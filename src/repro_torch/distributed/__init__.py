"""Training and GEMMs over a `torch.distributed` device mesh: the
parameter rules and ZeRO-1 optimizer specs (`sharding`), the sharded
emulated GEMM (`sharded_gemm`), error-feedback gradient compression
(`compression`), restoring a checkpoint onto another mesh (`elastic`),
the GPipe pipeline (`pipeline`) and the fault tolerance of a run
(`fault`)."""
from .fault import PreemptionGuard, StragglerWatch
from .sharded_gemm import ShardedBackend
from .sharding import (
    DEFAULT_RULES,
    AbstractMesh,
    GemmShardAxes,
    NamedSharding,
    batch_pspec,
    batch_sharding,
    optimizer_spec,
    pspec_for_axes,
    resolve_gemm_axes,
    tree_pspecs,
    tree_shardings,
)

__all__ = [
    "DEFAULT_RULES",
    "AbstractMesh",
    "GemmShardAxes",
    "NamedSharding",
    "PreemptionGuard",
    "ShardedBackend",
    "StragglerWatch",
    "batch_pspec",
    "batch_sharding",
    "optimizer_spec",
    "pspec_for_axes",
    "resolve_gemm_axes",
    "tree_pspecs",
    "tree_shardings",
]
