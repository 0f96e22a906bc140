"""The launch-timing copy kernel of the calibration.

Port of the Pallas kernel `_copy` inside `repro.tune.calibrate.
_measure_gemm_launch_s`: a copy of a small f32 tile that does no work
worth timing, so its wall time through the wrapper is the per-launch
overhead of the port's kernels (`HW.gemm_launch_s`).  The wrapper runs the
GEMM kernels' launch path — `build.library`, `build.check_launch`, the
current stream — so the overhead the performance model prices is theirs.

On CUDA tensors `launch_copy` launches `csrc/launch_copy.cu`; on CPU
tensors it runs `launch_copy_plain`.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from . import build
from .common import check_tensor, on_card, traced_launch


def launch_copy_plain(x: torch.Tensor) -> torch.Tensor:
    """The kernel's function in PyTorch: a copy."""
    return x.clone()


@functools.cache
def _entry():
    fn = build.library("launch_copy").launch_copy_launch
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def launch_copy(x: torch.Tensor) -> torch.Tensor:
    """A copy of the contiguous f32 tensor `x` in one launch of one block."""
    check_tensor("x", x, torch.float32, tuple(x.shape))
    with traced_launch("launch_copy", (x,)):
        if on_card(x):
            out = torch.empty_like(x)
            if out.is_meta:  # shapes only: no launch
                return out
            status = _entry()(x.data_ptr(), out.data_ptr(), x.numel(),
                              torch.cuda.current_stream(x.device).cuda_stream)
            build.check_launch("launch_copy", status)
            launch_copy.launches += 1
            return out
        return launch_copy_plain(x)


launch_copy.launches = 0
