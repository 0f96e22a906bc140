"""Architecture registry: `get_config(arch)` / `get_reduced(arch)`.

The port's copy of `repro.configs`.  Each module defines CONFIG (the
published configuration) and REDUCED (same family, small dims, for the
CPU tests), the reference's data unchanged.  Every arch runs: the six
attention-family archs, mamba2-130m (SSD), recurrentgemma-2b (RG-LRU
and windowed attention) and the MoE archs granite-moe-3b-a800m and
deepseek-moe-16b.
"""
from __future__ import annotations

import dataclasses
import importlib

ARCHS = (
    "mamba2-130m",
    "internvl2-26b",
    "qwen2.5-32b",
    "nemotron-4-15b",
    "starcoder2-3b",
    "minitron-4b",
    "recurrentgemma-2b",
    "granite-moe-3b-a800m",
    "deepseek-moe-16b",
    "musicgen-medium",
)

def _module(arch: str):
    from ..linalg import _no_ambient_policy

    name = arch.replace("-", "_").replace(".", "_")
    with _no_ambient_policy():
        # a first import inside a use_policy scope must not pin that scope
        # into the module-level CONFIG/REDUCED (re-pinned by _resolve)
        return importlib.import_module(f"{__name__}.{name}")


def _resolve(cfg, overrides):
    """Registry configs are built at import time (no ambient scope), so a
    `repro_torch.use_policy` scope active at lookup re-pins their matmul
    policy, unless the arch module set an emulated policy itself or the
    caller overrides `gemm_policy`."""
    if "gemm_policy" not in overrides:
        from ..core.policy import NATIVE
        from ..linalg import current_policy

        ambient = current_policy()
        if ambient != NATIVE and cfg.gemm_policy == NATIVE:
            overrides = dict(overrides, gemm_policy=ambient)
    return dataclasses.replace(cfg, **overrides) if overrides else cfg


def get_config(arch: str, **overrides):
    return _resolve(_module(arch).CONFIG, overrides)


def get_reduced(arch: str, **overrides):
    return _resolve(_module(arch).REDUCED, overrides)
