"""`repro_torch.tune` — on-card calibration + GEMM kernel tile autotuning.

The port's copy of `repro.tune`: a one-shot microbenchmark (`calibrate`)
measures the card's int8/e4m3 rates, memory bandwidth, native complex GEMM
rates and per-launch overhead into an `HW.from_calibration` instance, an
autotuner (`autotune_blocks`) times each GEMM kernel over its compiled
tiles, and both persist to one JSON calibration cache (`cache`) keyed by
(device kind, device count, torch version, CUDA version).

Activating a calibration (`use_calibration` scope, `set_calibration`
process default, or a `GemmPolicy(calibration=path)` pin) makes every
``"auto"`` decision — formulation, n_block, mode / n_moduli, engine — price
against the *measured* `HW` (`perfmodel.default_hw`), and makes the
`kernel` / `fused` / `fp8` executions launch the tuned tiles
(`kernels.common.resolve_blocks`).  With no calibration active the presets
(GH200) price and the default tiles run.

CLI::

    PYTHONPATH=src python -m repro_torch.tune [--smoke] [--out PATH] [--no-blocks]
"""
from .cache import (  # noqa: F401
    Calibration,
    block_key,
    calibration_hash,
    current_calibration,
    default_cache_path,
    load_calibration,
    load_calibration_cached,
    save_calibration,
    set_calibration,
    shape_bucket,
    use_calibration,
)

__all__ = [
    "Calibration",
    "add_calibration_args",
    "apply_calibration_args",
    "autotune_blocks",
    "block_key",
    "calibrate",
    "calibration_hash",
    "current_calibration",
    "default_cache_path",
    "load_calibration",
    "load_calibration_cached",
    "save_calibration",
    "set_calibration",
    "shape_bucket",
    "use_calibration",
]


def __getattr__(name):
    # calibrate/autotune pull in the kernel stack; load them lazily
    if name == "calibrate":
        from .calibrate import calibrate

        return calibrate
    if name == "autotune_blocks":
        from .autotune import autotune_blocks

        return autotune_blocks
    if name in ("add_calibration_args", "apply_calibration_args"):
        from . import cli

        return getattr(cli, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
