"""The MoE routing of a run, recorded, for comparisons between runs.

The router is a native float32 product (`blocks._route`).  Two runs that
agree to rounding (the card and the CPU, the port and the reference,
emulated and float64 linears) can still send a token to other experts
where its k-th and (k+1)-th router logits nearly tie, and that token's
output then moves by O(1).  A comparison of MoE models therefore reads
the routing: `RouteLog` records each routed group's top-k experts, the
gap between the k-th chosen and the best unchosen logit relative to the
bound on how far a relative change of the input can move either (|x|
times the larger norm of their router columns), and whether the group
dropped a token at capacity; `differing` says which tokens two runs
routed to different experts.
"""
from __future__ import annotations

import dataclasses

import torch

from . import blocks


@dataclasses.dataclass
class Route:
    """One routed group: experts (T, k), sorted; rel_gap (T,), float64;
    whether a token went over an expert's capacity."""

    experts: torch.Tensor
    rel_gap: torch.Tensor
    dropped: bool


class RouteLog:
    """Context manager: every `blocks._route` call inside it appends a
    `Route` to `.routes`, in call order (layer by layer, group by group)."""

    def __init__(self):
        self.routes: list[Route] = []
        self._real = None

    def __enter__(self):
        self._real = blocks._route

        def recording(cfg, router, xg):
            out = self._real(cfg, router, xg)
            logits, _, _, topi = out
            chosen = torch.zeros_like(logits, dtype=torch.bool).scatter_(1, topi, True)
            low, last = torch.where(chosen, logits, torch.inf).min(dim=-1)
            high, rival = torch.where(chosen, -torch.inf, logits).max(dim=-1)
            # the products' Cauchy-Schwarz bound: an input off by a
            # relative d moves either logit by at most d times it
            w = torch.linalg.vector_norm(router.double(), dim=0)
            scale = torch.linalg.vector_norm(xg.double(), dim=-1) * torch.maximum(w[last], w[rival])
            counts = torch.bincount(topi.flatten(), minlength=cfg.moe_experts)
            self.routes.append(Route(
                experts=torch.sort(topi, dim=-1).values.cpu(),
                rel_gap=((low - high).double() / scale.clamp_min(1e-300)).cpu(),
                dropped=bool(counts.max() > blocks.moe_capacity(cfg, xg.shape[0])),
            ))
            return out

        blocks._route = recording
        return self

    def __exit__(self, *exc):
        blocks._route = self._real
        return False


def differing(a: list[Route], b: list[Route]) -> list[torch.Tensor]:
    """Per pair of routes, the (T,) mask of tokens routed to a different
    set of experts (the runs must route the same groups)."""
    if len(a) != len(b):
        raise ValueError(f"the runs routed {len(a)} and {len(b)} groups")
    return [(x.experts != y.experts).any(dim=-1) for x, y in zip(a, b)]
