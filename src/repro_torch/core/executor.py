"""The executor for Ozaki-II emulation plans (real and complex).

The port's copy of the kernel-path part of `repro.core.executor`:

    scale -> residue cast -> residue GEMMs -> Garner reconstruct

parameterized by an :class:`EmulationPlan` and a residue backend (the
kernel backend, `repro_torch.kernels.ops.KernelBackend`) supplying
`cast_stack`, `residue_matmul`, `karatsuba` and `reconstruct_stack`.  The
two block-embedding formulations (paper eqs. 7/8) are composed here from
`residue_matmul`, so all three Fig. 1 strategies run on the kernels.
`run_plan` batches over leading operand dims with a loop written out where
the reference uses `jnp.vectorize`.
"""
from __future__ import annotations

import torch

from . import scaling
from .moduli import K_CHUNK_LIMIT
from .plan import EmulationPlan


def chunked_residue_matmul(mod_gemm_stack, ares, bres, chunk_limit: int | None = None):
    """K-chunk an (N,m,k) x (N,k,n) residue product so every kernel launch
    accumulates exactly (k <= `chunk_limit`, default `K_CHUNK_LIMIT`, read
    at call time so tests can patch the module constant).

    `mod_gemm_stack(ares, bres, carry) -> residues`: the previous chunk's
    residues are threaded through the kernel's carry input and folded into
    its epilogue mod, one batched launch per chunk.  `ares`/`bres` (and the
    carry) may be tuples of same-K stacks: the fused-Karatsuba product
    passes its (R, I) plane pairs and carries (CR, CI).
    """
    if chunk_limit is None:
        chunk_limit = K_CHUNK_LIMIT
    pair = isinstance(ares, tuple)
    k = (ares[0] if pair else ares).shape[-1]
    carry = None
    for k0 in range(0, k, chunk_limit):
        sl = slice(k0, k0 + chunk_limit)

        def cut_a(x):
            return x[..., sl].contiguous()

        def cut_b(x):
            return x[:, sl, :].contiguous()

        if pair:
            carry = mod_gemm_stack(tuple(map(cut_a, ares)), tuple(map(cut_b, bres)), carry)
        else:
            carry = mod_gemm_stack(cut_a(ares), cut_b(bres), carry)
    return carry


def _cast_pair(backend, xr, xi, e, axis, ctx, n_limbs):
    """Residue-cast a real/imag pair sharing one scale vector, 1 launch."""
    res = backend.cast_stack(torch.stack([xr, xi]), e, axis, ctx, n_limbs)
    return res[0], res[1]


def _reconstruct_pair(backend, er, ei, e_mu, e_nu, ctx, method, out_dtype):
    """Reconstruct a CR/CI residue pair in one stacked launch."""
    out = backend.reconstruct_stack(torch.stack([er, ei]), e_mu, e_nu, ctx, method, out_dtype)
    return out[0], out[1]


def _block_a(backend, arr, ari, brr, bri, ctx):
    """eq. (7): [[AR,-AI],[AI,AR]] @ [BR;BI] = [CR;CI] — one GEMM of (2m,2k,n)."""
    top = torch.cat([arr, -ari], dim=-1)
    bot = torch.cat([ari, arr], dim=-1)
    ahat = torch.cat([top, bot], dim=-2)  # (N, 2m, 2k)
    bhat = torch.cat([brr, bri], dim=-2)  # (N, 2k, n)
    chat = backend.residue_matmul(ahat, bhat, ctx)  # (N, 2m, n) int8 residues
    m = arr.shape[-2]
    return chat[:, :m, :], chat[:, m:, :]


def _block_b(backend, arr, ari, brr, bri, ctx):
    """eq. (8): [AI,AR] @ [[BR,-BI],[BI,BR]] = [CI,CR] — one GEMM of (m,2k,2n)."""
    ahat = torch.cat([ari, arr], dim=-1)  # (N, m, 2k)
    left = torch.cat([brr, bri], dim=-2)  # (N, 2k, n)
    right = torch.cat([-bri, brr], dim=-2)
    bhat = torch.cat([left, right], dim=-1)  # (N, 2k, 2n)
    chat = backend.residue_matmul(ahat, bhat, ctx)
    n = brr.shape[-1]
    return chat[:, :, n:], chat[:, :, :n]


def _complex_product(backend, plan, arr, ari, brr, bri, ctx):
    if plan.formulation == "karatsuba":
        return backend.karatsuba(arr, ari, brr, bri, ctx)
    if plan.formulation == "block_a":
        return _block_a(backend, arr, ari, brr, bri, ctx)
    if plan.formulation == "block_b":
        return _block_b(backend, arr, ari, brr, bri, ctx)
    raise ValueError(f"unknown formulation {plan.formulation!r}")


def execute_plan(plan: EmulationPlan, a, b, backend):
    """Run one 2D emulated GEMM per `plan`: C ~= A @ B, a: (m,k), b: (k,n)."""
    if plan.is_complex:
        return _execute_complex(plan, a, b, backend)
    return _execute_real(plan, a, b, backend)


def _blocked_pipeline_real(plan, backend, ctx, e_mu, ares, e_nu, bres_slice, n):
    """Residue GEMM -> reconstruct over output-column blocks; `bres_slice(sl)`
    yields the B-side residues of one block."""
    blocks = []
    for sl in plan.n_block_slices(n):
        e_r = backend.residue_matmul(ares, bres_slice(sl), ctx)
        blocks.append(
            backend.reconstruct(e_r, e_mu, e_nu[sl], ctx, plan.method, plan.real_out_dtype)
        )
    return blocks[0] if len(blocks) == 1 else torch.cat(blocks, dim=1)


def _blocked_pipeline_complex(plan, backend, ctx, e_mu, arr, ari, e_nu, bres_slice, n):
    """Complex twin of `_blocked_pipeline_real`; `bres_slice(sl)` yields the
    (brr, bri) residue pair of one output-column block."""
    rdt = plan.real_out_dtype
    blocks = []
    for sl in plan.n_block_slices(n):
        brr, bri = bres_slice(sl)
        er, ei = _complex_product(backend, plan, arr, ari, brr, bri, ctx)
        cr, ci = _reconstruct_pair(backend, er, ei, e_mu, e_nu[sl], ctx, plan.method, rdt)
        blocks.append(torch.complex(cr, ci))
    return blocks[0] if len(blocks) == 1 else torch.cat(blocks, dim=1)


def _execute_real(plan, a, b, backend):
    ctx = plan.ctx
    if plan.mode == "fast":
        e_mu, e_nu = scaling.scale_fast_real(a, b, ctx)
    else:
        e_mu, e_nu = scaling.scale_accurate_real(a, b, ctx)
    nl = plan.n_limbs
    ares = backend.cast(a, e_mu, 0, ctx, nl)
    return _blocked_pipeline_real(
        plan, backend, ctx, e_mu, ares, e_nu,
        lambda sl: backend.cast(b[:, sl], e_nu[sl], 1, ctx, nl),
        b.shape[1],
    )


def _execute_complex(plan, a, b, backend):
    ctx = plan.ctx
    ar, ai = a.real, a.imag
    br, bi = b.real, b.imag
    if plan.mode == "fast":
        e_mu, e_nu = scaling.scale_fast_complex(ar, ai, br, bi, ctx)
    else:
        e_mu, e_nu = scaling.scale_accurate_complex(ar, ai, br, bi, ctx)
    nl = plan.n_limbs
    arr, ari = _cast_pair(backend, ar, ai, e_mu, 0, ctx, nl)
    return _blocked_pipeline_complex(
        plan, backend, ctx, e_mu, arr, ari, e_nu,
        lambda sl: _cast_pair(backend, br[:, sl], bi[:, sl], e_nu[sl], 1, ctx, nl),
        b.shape[1],
    )


def run_plan(plan: EmulationPlan, a, b, backend):
    """Execute `plan` on (..., m, k) x (..., k, n), batched over the
    broadcast leading dims (one 2D execution per batch element)."""
    batch = torch.broadcast_shapes(a.shape[:-2], b.shape[:-2])
    if not batch:
        return execute_plan(plan, a, b, backend)
    a2 = a.expand(*batch, *a.shape[-2:]).reshape(-1, *a.shape[-2:])
    b2 = b.expand(*batch, *b.shape[-2:]).reshape(-1, *b.shape[-2:])
    outs = [execute_plan(plan, x, y, backend) for x, y in zip(a2, b2)]
    return torch.stack(outs).reshape(*batch, *outs[0].shape)


class PreparedOperand:
    """Weights cast once up front, for serving (`repro.core.PreparedOperand`).

    Not ported yet: ROADMAP queue 1, 'PreparedOperand / prepare_weights'.
    """

    def __init__(self, *args, **kwargs):
        raise NotImplementedError(
            "PreparedOperand is not ported yet (ROADMAP queue 1, "
            "'PreparedOperand / prepare_weights'); pass raw weights"
        )
