"""The sharded emulated GEMM over a `torch.distributed` device mesh
(`sharded_gemm`, `sharding`) and the fault tolerance of a run (`fault`);
the parameter-sharded training mesh is not ported yet (ROADMAP queue 1,
item 11b)."""
from .fault import PreemptionGuard, StragglerWatch
from .sharded_gemm import ShardedBackend
from .sharding import GemmShardAxes, resolve_gemm_axes

__all__ = ["GemmShardAxes", "PreemptionGuard", "ShardedBackend", "StragglerWatch", "resolve_gemm_axes"]
