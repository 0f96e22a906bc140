"""Fault tolerance of one card (the port's copy of
`repro.distributed.fault`); sharding over a device group is not ported
yet (ROADMAP queue 1, item 11)."""
from .fault import PreemptionGuard, StragglerWatch

__all__ = ["PreemptionGuard", "StragglerWatch"]
