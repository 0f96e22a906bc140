"""Learning-rate schedules (step -> multiplier functions).

The port's copy of `repro.optim.schedules`, op for op: the step as
float32, the warm-up ramp, the clipped progress, the cosine and the
switch.  Every constant is divided by as a float32 tensor on the step's
device (a Python divisor on the card becomes a multiply by its
reciprocal), so the ops are the reference's.  The cosine is the
correctly rounded float32 value (`_cos`); the reference's op-by-op
factors are then matched to an ulp, while its jitted ones differ from its
own op-by-op ones by up to 6 ulps near the end of a schedule.
"""
from __future__ import annotations

import math

import torch

_F32 = torch.float32


def _cos(x: torch.Tensor) -> torch.Tensor:
    """float32 cos through float64: the correctly rounded value, which
    XLA's float32 cos gives at all but one or two steps of a schedule and
    torch's float32 cos misses at several.  Near the end of the cosine,
    ``1 + cos`` cancels and one ulp of cos becomes 4-7 ulps of the
    factor."""
    return torch.cos(x.to(torch.float64)).to(_F32)


def cosine_warmup(warmup_steps: int, total_steps: int, min_ratio: float = 0.1):
    def schedule(step):
        step = torch.as_tensor(step).to(_F32)

        def const(x):
            return torch.tensor(x, dtype=_F32, device=step.device)

        warm = step / const(max(warmup_steps, 1))
        prog = (step - warmup_steps) / const(max(total_steps - warmup_steps, 1))
        prog = torch.clamp(prog, 0.0, 1.0)
        cos = min_ratio + (1 - min_ratio) * 0.5 * (1 + _cos(math.pi * prog))
        return torch.where(step < warmup_steps, warm, cos)

    return schedule
