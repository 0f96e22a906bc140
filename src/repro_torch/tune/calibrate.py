"""One-shot on-card calibration microbenchmark -> measured `HW`.

The port's copy of `repro.tune.calibrate`.  It measures, on the card (or on
the CPU when the caller asks for ``device="cpu"``, as the tests do):

* the sustained int8 MAC rate (`HW.int8_ops`, ops counted as mul+add, the
  SIII-C model's `p`), by `torch._int_mm` (int8 x int8 -> int32);
* the sustained e4m3 rate (`HW.fp8_ops`), by `torch._scaled_mm` on e4m3
  operands; 0.0 on the CPU, which has no e4m3 matmul (the model reads 0 as
  "no native fp8").  On the card a failing e4m3 probe raises;
* memory bandwidth (`HW.mem_bw`), by the elementwise v * 1.000001 + 1 over
  2^24 f32 elements, one read and one write each (one `torch.add` launch);
* the per-launch overhead (`HW.gemm_launch_s`), by the launch-timing copy
  kernel (`kernels/launch_copy.py`), launched through the same ctypes path
  as the GEMM kernels (`build.library`, `build.check_launch`, the current
  stream), so the overhead the model prices is theirs;
* native complex GEMM rates (`HW.native_c64` / `native_c128`), by
  `torch.matmul` (cuBLAS on the card); a failing probe raises;
* all-reduce bandwidth and collective overhead (`HW.ici_bw` /
  `collective_launch_s`): inside a process group of two or more ranks, a
  tiny and a large float64 all-reduce over the whole group (every rank
  calibrates together); (0, 0) without one, which keeps the presets, as
  the reference does with one device.

Timing is the reference's: host wall time around `torch.cuda.synchronize()`,
one warm-up call, the median of 3.  The probe sizes are the reference's
(smoke, full).  `calibrate()` bundles the measurements with the
`repro_torch.tune.autotune` tile winners into a `Calibration` ready for
`save_calibration`.  A calibration changes speed only, never the bits.
"""
from __future__ import annotations

import statistics
import time

import numpy as np
import torch
import torch.distributed as dist

from ..core.executor import resolve_device
from .cache import Calibration, live_key

# probe sizes: (smoke, full)
_MEM_ELEMS = (1 << 20, 1 << 24)       # f32 elements of the bandwidth probe
_DOT_DIM = (256, 1024)                # square dim of the engine-rate probes
_NATIVE_DIM = (128, 512)
_PSUM_ELEMS = (1 << 16, 1 << 22)      # f64 elements of the large all-reduce


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _time_s(fn, device: torch.device, *args, warmup: int = 1, iters: int = 3) -> float:
    """Median wall-seconds per call of `fn`, each call ending in a sync."""
    for _ in range(warmup):
        fn(*args)
        _sync(device)
    ts = []
    for _ in range(iters):
        t0 = time.perf_counter()
        fn(*args)
        _sync(device)
        ts.append(time.perf_counter() - t0)
    return float(statistics.median(ts))


def _measure_mem_bw(smoke: bool, device: torch.device) -> float:
    n = _MEM_ELEMS[0] if smoke else _MEM_ELEMS[1]
    x = torch.arange(n, dtype=torch.float32, device=device)
    one = torch.ones((), dtype=torch.float32, device=device)
    t = _time_s(lambda v: torch.add(one, v, alpha=1.000001), device, x)
    return 2.0 * 4.0 * n / t  # one read + one write of 4-byte elements


def _measure_int8_ops(smoke: bool, device: torch.device) -> float:
    d = _DOT_DIM[0] if smoke else _DOT_DIM[1]
    rng = np.random.default_rng(0)
    a = torch.from_numpy(rng.integers(-63, 64, (d, d), dtype=np.int8)).to(device)
    b = torch.from_numpy(rng.integers(-63, 64, (d, d), dtype=np.int8)).to(device)
    t = _time_s(torch._int_mm, device, a, b)
    return 2.0 * d**3 / t


def _measure_fp8_ops(smoke: bool, device: torch.device) -> float:
    """e4m3 dot rate on the card; 0.0 on the CPU (no e4m3 matmul there)."""
    if device.type != "cuda":
        return 0.0
    d = _DOT_DIM[0] if smoke else _DOT_DIM[1]
    rng = np.random.default_rng(0)
    a = torch.from_numpy(rng.integers(-7, 8, (d, d)).astype(np.float32)).to(device)
    b = torch.from_numpy(rng.integers(-7, 8, (d, d)).astype(np.float32)).to(device)
    a8 = a.to(torch.float8_e4m3fn)
    b8 = b.t().contiguous().to(torch.float8_e4m3fn).t()  # column-major, as _scaled_mm wants
    one = torch.ones((), dtype=torch.float32, device=device)
    t = _time_s(lambda x, w: torch._scaled_mm(x, w, one, one, out_dtype=torch.float32), device, a8, b8)
    return 2.0 * d**3 / t


def _measure_native_rate(dtype: torch.dtype, smoke: bool, device: torch.device) -> float:
    """Native complex GEMM flop rate (8 m n k flops)."""
    d = _NATIVE_DIM[0] if smoke else _NATIVE_DIM[1]
    rng = np.random.default_rng(0)
    a = torch.from_numpy(rng.standard_normal((d, d)) + 1j * rng.standard_normal((d, d)))
    a = a.to(device=device, dtype=dtype)
    t = _time_s(torch.matmul, device, a, a)
    return 8.0 * d**3 / t


def _measure_gemm_launch_s(device: torch.device) -> float:
    """Wall time of a launch of the copy kernel on an (8, 128) f32 tile:
    the per-launch overhead of the port's kernels."""
    from ..kernels.launch_copy import launch_copy

    x = torch.zeros((8, 128), dtype=torch.float32, device=device)
    return _time_s(launch_copy, device, x)


def _measure_psum(smoke: bool, device: torch.device) -> tuple[float, float]:
    """(ici_bw B/s, collective_launch_s) of the run's process group; (0, 0)
    outside a group of two or more ranks, meaning "not measured":
    `HW.from_calibration` keeps the presets."""
    if not dist.is_initialized() or dist.get_world_size() < 2:
        return 0.0, 0.0
    d = dist.get_world_size()
    tiny = torch.zeros(8, dtype=torch.float64, device=device)
    t_tiny = _time_s(dist.all_reduce, device, tiny)
    n = _PSUM_ELEMS[0] if smoke else _PSUM_ELEMS[1]
    big = torch.from_numpy(np.random.default_rng(0).standard_normal(n)).to(device)
    t_big = _time_s(dist.all_reduce, device, big)
    # a ring all-reduce moves ~2(d-1)/d of the payload per rank
    return 2.0 * (d - 1) / d * 8.0 * n / max(t_big - t_tiny, 1e-9), t_tiny


def measure_hw(smoke: bool = False, device=None) -> dict:
    """Run every microbenchmark; returns the `HW.from_calibration` dict."""
    device = resolve_device(device)
    ici_bw, coll_s = _measure_psum(smoke, device)
    return {
        "mem_bw": _measure_mem_bw(smoke, device),
        "int8_ops": _measure_int8_ops(smoke, device),
        "fp8_ops": _measure_fp8_ops(smoke, device),
        "native_c64": _measure_native_rate(torch.complex64, smoke, device),
        "native_c128": _measure_native_rate(torch.complex128, smoke, device),
        "gemm_launch_s": _measure_gemm_launch_s(device),
        "ici_bw": ici_bw,
        "collective_launch_s": coll_s,
    }


def calibrate(smoke: bool = False, *, blocks: bool = True, verbose: bool = False,
              device=None) -> Calibration:
    """The one-shot calibration: microbenchmarks + (optionally) the tile
    autotuner, on the card (`device=None`; raises without one) or on
    ``device="cpu"``.

    Returns a `Calibration` keyed by the device it measured, ready to
    persist with `save_calibration` and activate with `set_calibration` /
    `use_calibration`.  `blocks=False` skips the autotuner (HW only).
    """
    from ..core.perfmodel import HW

    device = resolve_device(device)
    key = live_key(device)
    meas = measure_hw(smoke, device)
    if verbose:
        for k in sorted(meas):
            print(f"  measured {k:>20s} = {meas[k]:.3e}")
    hw = HW.from_calibration(meas, name=f"calibrated/{key['device_kind']}")
    cal = Calibration(hw=hw, **key)
    if blocks:
        from .autotune import autotune_blocks

        cal = cal.with_blocks(autotune_blocks(smoke=smoke, verbose=verbose, device=device))
    return cal
