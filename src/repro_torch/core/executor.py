"""The executor for Ozaki-II emulation plans (real and complex).

The port's copy of `repro.core.executor`:

    scale -> quantize -> residue cast -> residue GEMMs
          -> CRT reconstruct -> exact inverse scaling

parameterized by an :class:`EmulationPlan` and a residue backend supplying
`cast`, `residue_matmul`, `karatsuba` and `reconstruct`, and optionally the
stacked `cast_stack` / `reconstruct_stack` on an (S, ...) leading stack
that shares scale exponents, which the complex pipeline uses (via
`_cast_pair` / `_reconstruct_pair`) to cast and reconstruct real and
imaginary parts in one launch; backends without them make two calls with
the same bits.  `ReferenceBackend` (here) is plain PyTorch in float64 with
every CRT method; `repro_torch.kernels.ops` holds the kernel backends.
The two block-embedding formulations (paper eqs. 7/8) are composed here
from `residue_matmul`, so every backend runs all three Fig. 1 strategies.
A backend with ``megakernel = True`` (`FusedBackend`) runs the whole chain
as one `fused_gemm` / `fused_karatsuba_gemm` launch per output-column
block instead.  `run_plan` batches over leading operand dims with a loop
written out where the reference uses `jnp.vectorize`.

Prepared serving: :class:`PreparedOperand` casts a reused operand once and
`gemm_prepared` multiplies by it.
"""
from __future__ import annotations

import dataclasses

import torch

from . import crt, scaling
from .intmul import int8_matmul
from .moduli import K_CHUNK_LIMIT, CRTContext, make_crt_context
from .plan import DTYPES, EmulationPlan, default_n_moduli, dtype_name, make_plan, n_limbs_for_ctx
from .residues import quantize, residues_from_quantized, sym_mod_int32


def resolve_device(device=None) -> torch.device:
    """The device an entry point computes on: `device`, else the card."""
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: the emulated GEMM runs on the card; pass "
            "device='cpu' to run the kernels' plain PyTorch versions"
        )
    return device


def _sym_mod_stack(d: torch.Tensor, ctx: CRTContext) -> torch.Tensor:
    """Symmetric mod of an (N, ...) integer stack, plane l modulo p_l."""
    p = torch.as_tensor(ctx.moduli_arr, device=d.device).reshape((ctx.n,) + (1,) * (d.ndim - 1))
    return sym_mod_int32(d, p.to(d.dtype))


def chunked_residue_matmul(mod_gemm_stack, ares, bres, ctx: CRTContext | None = None,
                           carry_epilogue: bool = False, chunk_limit: int | None = None):
    """K-chunk an (N,m,k) x (N,k,n) residue product so every product
    accumulates exactly (k <= `chunk_limit`, default `K_CHUNK_LIMIT`, read
    at call time so tests can patch the module constant).

    Two ways of combining the chunks share this one loop:

    * ``carry_epilogue=False`` — `mod_gemm_stack(ares, bres) -> (N,m,n)
      int8`: the chunks' residues are summed in int32 and reduced once
      (`_sym_mod_stack`, modulo `ctx`'s moduli): the reference and
      per-modulus backends.
    * ``carry_epilogue=True`` — `mod_gemm_stack(ares, bres, carry) ->
      residues`: the previous chunk's residues are threaded through the
      kernel's carry input and folded into its epilogue mod, one batched
      launch per chunk.  `ares`/`bres` (and the carry) may be tuples of
      same-K stacks: the fused-Karatsuba product passes its (R, I) plane
      pairs and carries (CR, CI).

    Both give the exact canonical residues of the full-k product.
    """
    if chunk_limit is None:
        chunk_limit = K_CHUNK_LIMIT
    pair = isinstance(ares, tuple)
    k = (ares[0] if pair else ares).shape[-1]

    def cut_a(x, sl):
        return x[..., sl].contiguous()

    def cut_b(x, sl):
        return x[:, sl, :].contiguous()

    if carry_epilogue:
        carry = None
        for k0 in range(0, k, chunk_limit):
            sl = slice(k0, k0 + chunk_limit)
            if pair:
                carry = mod_gemm_stack(tuple(cut_a(x, sl) for x in ares),
                                       tuple(cut_b(x, sl) for x in bres), carry)
            else:
                carry = mod_gemm_stack(cut_a(ares, sl), cut_b(bres, sl), carry)
        return carry
    if k <= chunk_limit:
        return mod_gemm_stack(ares, bres)
    acc = None
    for k0 in range(0, k, chunk_limit):
        sl = slice(k0, k0 + chunk_limit)
        e = mod_gemm_stack(cut_a(ares, sl), cut_b(bres, sl)).to(torch.int32)
        acc = e if acc is None else acc + e
    # |acc| <= n_chunks*127 << 2^31
    return _sym_mod_stack(acc, ctx).to(torch.int8)


def _cast_pair(backend, xr, xi, e, axis, ctx, n_limbs):
    """Residue-cast a real/imag pair sharing one scale vector: one stacked
    launch when the backend has `cast_stack`, else two `cast` calls (the
    reference and per-modulus backends), with the same bits."""
    cast_stack = getattr(backend, "cast_stack", None)
    if cast_stack is None:
        return backend.cast(xr, e, axis, ctx, n_limbs), backend.cast(xi, e, axis, ctx, n_limbs)
    res = cast_stack(torch.stack([xr, xi]), e, axis, ctx, n_limbs)
    return res[0], res[1]


def _reconstruct_pair(backend, er, ei, e_mu, e_nu, ctx, method, out_dtype):
    """Reconstruct a CR/CI residue pair: one stacked launch when the
    backend has `reconstruct_stack`, else two `reconstruct` calls."""
    rec_stack = getattr(backend, "reconstruct_stack", None)
    if rec_stack is None:
        return (backend.reconstruct(er, e_mu, e_nu, ctx, method, out_dtype),
                backend.reconstruct(ei, e_mu, e_nu, ctx, method, out_dtype))
    out = rec_stack(torch.stack([er, ei]), e_mu, e_nu, ctx, method, out_dtype)
    return out[0], out[1]


# ================================================================ backends


def _composed_karatsuba(backend, arr, ari, brr, bri, ctx):
    """Residues of (CR', CI') via 3 residue products (paper eq. 10), composed
    from `backend.residue_matmul` (the reference backend).  Every product
    returns canonical symmetric residues (|r| <= 127), so the int32
    combines stay exact."""
    asum = _sym_mod_stack(arr.to(torch.int32) + ari.to(torch.int32), ctx).to(torch.int8)
    bsum = _sym_mod_stack(brr.to(torch.int32) + bri.to(torch.int32), ctx).to(torch.int8)
    d = backend.residue_matmul(arr, brr, ctx).to(torch.int32)  # already mod p
    e = backend.residue_matmul(ari, bri, ctx).to(torch.int32)
    f = backend.residue_matmul(asum, bsum, ctx).to(torch.int32)
    er = _sym_mod_stack(d - e, ctx).to(torch.int8)
    ei = _sym_mod_stack(f - d - e, ctx).to(torch.int8)
    return er, ei


@dataclasses.dataclass(frozen=True)
class ReferenceBackend:
    """The reference data path (`execution="reference"`, port of
    `repro.core.executor.ReferenceBackend`): plain PyTorch on whatever
    device the operands are on, no hand-written kernel.  The cast quantizes
    in float64, the residue products are exact float64 matmuls of the int8
    planes (`core/intmul.py`), and the reconstruction is any of the three
    CRT methods (`core/crt.py`), so the output is float64-grade.  The
    capability flags are the reference's: Karatsuba is composed of 3
    products and each primitive counts as one launch per modulus."""

    fused_karatsuba = False
    modulus_batched = False
    launches_kernels = False  # the perfmodel's pricing aside, it launches none

    def analyze(self, plan, shape=None):
        """The static-analysis suite certifying this backend running `plan`
        (`repro_torch.analysis.passes_for_backend`): overflow and
        collective safety, and given ``shape = (m, k, n)`` the launch count
        the perfmodel predicts for its capabilities (none here)."""
        from ..analysis import passes_for_backend

        return passes_for_backend(self, plan, shape)

    def cast(self, x, e, axis, ctx, n_limbs):
        """quantize by 2^e along `axis` and residue-decompose (steps IV/V-i/ii)."""
        xq = quantize(x.to(torch.float64), scaling.exp2_vector(e), axis)
        return residues_from_quantized(xq, ctx, n_limbs)

    def residue_matmul(self, ares, bres, ctx):
        """(N,m,k) x (N,k,n) -> (N,m,n) int8 residues of A'B' (steps V-iii/iv),
        K-chunked by the shared `chunked_residue_matmul`."""
        return chunked_residue_matmul(
            lambda a, b: _sym_mod_stack(int8_matmul(a, b), ctx).to(torch.int8), ares, bres, ctx)

    def karatsuba(self, arr, ari, brr, bri, ctx):
        """Residues of (CR', CI') via 3 int8 products per modulus (paper eq. 10)."""
        return _composed_karatsuba(self, arr, ari, brr, bri, ctx)

    def reconstruct(self, e_res, e_mu, e_nu, ctx, method, out_dtype):
        """CRT reconstruction (steps V-v/vi) + exact inverse scaling."""
        hi, lo = crt.reconstruct(e_res, ctx, method)
        return crt.inverse_scale(hi, lo, e_mu, e_nu, out_dtype)


REFERENCE = ReferenceBackend()


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
    yields the B-side residues of one block.

    A backend with the `psum_partial` / `psum_combine` hooks (the sharded
    worker over a split residue dim) gets the two-phase structure: every
    block's product first, each reduced to its exact partial planes, then
    ONE collective over all of them (`psum_combine`, which returns each
    block's complete residue planes), then the reconstructions."""
    slices = list(plan.n_block_slices(n))
    psum_partial = getattr(backend, "psum_partial", None)
    if psum_partial is not None:
        planes = backend.psum_combine(
            [psum_partial(backend.residue_matmul(ares, bres_slice(sl), ctx)) for sl in slices])
    else:
        planes = (backend.residue_matmul(ares, bres_slice(sl), ctx) for sl in slices)
    blocks = [backend.reconstruct(e_r, e_mu, e_nu[sl], ctx, plan.method, plan.real_out_dtype)
              for e_r, sl in zip(planes, slices)]
    return blocks[0] if len(blocks) == 1 else torch.cat(blocks, dim=1)


def _blocked_pipeline_complex(plan, backend, ctx, e_mu, arr, ari, e_nu, bres_slice, n):
    """Complex twin of `_blocked_pipeline_real`; `bres_slice(sl)` yields the
    (brr, bri) residue pair of one output-column block.  The two-phase
    hooks take the stacked CR/CI residues."""
    rdt = plan.real_out_dtype
    slices = list(plan.n_block_slices(n))
    pairs = (_complex_product(backend, plan, arr, ari, *bres_slice(sl), ctx) for sl in slices)
    psum_partial = getattr(backend, "psum_partial", None)
    if psum_partial is not None:
        pairs = backend.psum_combine([psum_partial(torch.stack(pair)) for pair in pairs], stacked=True)
    blocks = []
    for (er, ei), sl in zip(pairs, slices):
        cr, ci = _reconstruct_pair(backend, er, ei, e_mu, e_nu[sl], ctx, plan.method, rdt)
        blocks.append(torch.complex(cr, ci))
    return blocks[0] if len(blocks) == 1 else torch.cat(blocks, dim=1)


def _fused_pipeline_real(plan, backend, ctx, e_mu, a, e_nu, b_slice, b_res_slice, n):
    """Real pipeline on a megakernel backend: ONE `fused_gemm` launch per
    output-column block.  `b_slice(sl)` yields the raw B block, or
    `b_res_slice(sl)` the pre-cast (N, k, n_blk) planes of a prepared
    operand."""
    blocks = []
    for sl in plan.n_block_slices(n):
        if b_res_slice is not None:
            out = backend.fused_gemm(a, None, e_mu, e_nu[sl], ctx, plan.n_limbs,
                                     plan.real_out_dtype, b_res=b_res_slice(sl))
        else:
            out = backend.fused_gemm(a, b_slice(sl), e_mu, e_nu[sl], ctx, plan.n_limbs,
                                     plan.real_out_dtype)
        blocks.append(out)
    return blocks[0] if len(blocks) == 1 else torch.cat(blocks, dim=1)


def _fused_complex_block(backend, plan, ctx, e_mu, ar, ai, e_nu_sl, b_blk, b_res_blk, nl, rdt):
    """One output-column block of the fused complex pipeline -> (cr, ci).

    'karatsuba' runs the complex megakernel.  The block embeddings (paper
    eqs. 7/8) embed the RAW operands (or, prepared, the int8 residue
    planes) and run the real megakernel once: the residue cast commutes
    bitwise with negation (trunc and round are symmetric), so cast(-AI)
    equals the composed path's negated int8 planes exactly.
    """
    if plan.formulation == "karatsuba":
        if b_res_blk is not None:
            return backend.fused_karatsuba_gemm(ar, ai, None, None, e_mu, e_nu_sl, ctx, nl, rdt,
                                                b_res=b_res_blk)
        return backend.fused_karatsuba_gemm(ar, ai, b_blk[0], b_blk[1], e_mu, e_nu_sl, ctx, nl, rdt)
    if plan.formulation == "block_a":
        # eq. (7): [[AR,-AI],[AI,AR]] @ [BR;BI] = [CR;CI]
        ahat = torch.cat([torch.cat([ar, -ai], dim=-1), torch.cat([ai, ar], dim=-1)], dim=-2)
        ehat = torch.cat([e_mu, e_mu])
        if b_res_blk is not None:
            chat = backend.fused_gemm(ahat, None, ehat, e_nu_sl, ctx, nl, rdt,
                                      b_res=torch.cat(b_res_blk, dim=-2))
        else:
            chat = backend.fused_gemm(ahat, torch.cat(b_blk, dim=-2), ehat, e_nu_sl, ctx, nl, rdt)
        m = ar.shape[-2]
        return chat[..., :m, :], chat[..., m:, :]
    if plan.formulation == "block_b":
        # eq. (8): [AI,AR] @ [[BR,-BI],[BI,BR]] = [CI,CR]
        ahat = torch.cat([ai, ar], dim=-1)
        ehat_nu = torch.cat([e_nu_sl, e_nu_sl])
        xr, xi = b_res_blk if b_res_blk is not None else b_blk
        bhat = torch.cat([torch.cat([xr, xi], dim=-2), torch.cat([-xi, xr], dim=-2)], dim=-1)
        if b_res_blk is not None:
            chat = backend.fused_gemm(ahat, None, e_mu, ehat_nu, ctx, nl, rdt, b_res=bhat)
        else:
            chat = backend.fused_gemm(ahat, bhat, e_mu, ehat_nu, ctx, nl, rdt)
        n = chat.shape[-1] // 2
        return chat[..., :, n:], chat[..., :, :n]
    raise ValueError(f"unknown formulation {plan.formulation!r}")


def _fused_pipeline_complex(plan, backend, ctx, e_mu, ar, ai, e_nu, b_slice, b_res_slice, n):
    """Complex pipeline on a megakernel backend: one launch per block."""
    blocks = []
    for sl in plan.n_block_slices(n):
        b_blk = None if b_res_slice is not None else b_slice(sl)
        b_res_blk = b_res_slice(sl) if b_res_slice is not None else None
        cr, ci = _fused_complex_block(backend, plan, ctx, e_mu, ar, ai, e_nu[sl], b_blk,
                                      b_res_blk, plan.n_limbs, plan.real_out_dtype)
        blocks.append(torch.complex(cr, ci))
    return blocks[0] if len(blocks) == 1 else torch.cat(blocks, dim=1)


def _megakernel(backend) -> bool:
    return getattr(backend, "megakernel", False)


def scale_exponents(plan, a, b, backend=None):
    """The scale exponents (e_mu, e_nu) of a @ b in the plan's mode: the
    backend's own where it carries them (`exponents`: the sharded worker's,
    its slice of the whole product's), else computed from `a` and `b`, the
    accurate mode's bound maxima combined by the backend's
    `accu_row_combine` / `accu_col_combine` where it has them (the sharded
    worker: a MAX over the ranks that split the other axis)."""
    fixed = getattr(backend, "exponents", None)
    if fixed is not None:
        return fixed
    ctx = plan.ctx
    parts = (a.real, a.imag, b.real, b.imag) if plan.is_complex else (a, b)
    if plan.mode == "fast":
        fast = scaling.scale_fast_complex if plan.is_complex else scaling.scale_fast_real
        return fast(*parts, ctx)
    accu = scaling.scale_accurate_complex if plan.is_complex else scaling.scale_accurate_real
    return accu(*parts, ctx, getattr(backend, "accu_row_combine", None),
                getattr(backend, "accu_col_combine", None))


def _execute_real(plan, a, b, backend):
    e_mu, e_nu = scale_exponents(plan, a, b, backend)
    return _pipeline_real(plan, backend, plan.ctx, e_mu, a, e_nu, b)


def _pipeline_real(plan, backend, ctx, e_mu, a, e_nu, b):
    """Everything after the scaling, on raw operands: one megakernel launch
    per block, or cast -> product -> reconstruct."""
    if _megakernel(backend):
        # fast AND accu mode: the scaling runs outside the kernels, so the
        # whole emulated GEMM is the megakernel's single launch per block
        return _fused_pipeline_real(plan, backend, ctx, e_mu, a, e_nu, lambda sl: b[:, sl], None,
                                    b.shape[1])
    nl = plan.n_limbs
    ares = backend.cast(a, e_mu, 0, ctx, nl)
    return _blocked_pipeline_real(
        plan, backend, ctx, e_mu, ares, e_nu,
        lambda sl: backend.cast(b[:, sl], e_nu[sl], 1, ctx, nl),
        b.shape[1],
    )


def _execute_complex(plan, a, b, backend):
    e_mu, e_nu = scale_exponents(plan, a, b, backend)
    return _pipeline_complex(plan, backend, plan.ctx, e_mu, a.real, a.imag, e_nu, b.real, b.imag)


def _pipeline_complex(plan, backend, ctx, e_mu, ar, ai, e_nu, br, bi):
    """Complex twin of `_pipeline_real`."""
    if _megakernel(backend):
        return _fused_pipeline_complex(plan, backend, ctx, e_mu, ar, ai, e_nu,
                                       lambda sl: (br[:, sl], bi[:, sl]), None, br.shape[1])
    nl = plan.n_limbs
    arr, ari = _cast_pair(backend, ar, ai, e_mu, 0, ctx, nl)
    return _blocked_pipeline_complex(
        plan, backend, ctx, e_mu, arr, ari, e_nu,
        lambda sl: _cast_pair(backend, br[:, sl], bi[:, sl], e_nu[sl], 1, ctx, nl),
        br.shape[1],
    )


def run_plan(plan: EmulationPlan, a, b, backend):
    """Execute `plan` on (..., m, k) x (..., k, n), batched over the
    broadcast leading dims (one 2D execution per batch element).  A backend
    with its own `run_plan` takes the whole execution over (the sharded
    backend, which runs 2D products only)."""
    runner = getattr(backend, "run_plan", None)
    if runner is not None:
        return runner(plan, a, b)
    batch = torch.broadcast_shapes(a.shape[:-2], b.shape[:-2])
    if not batch:
        return execute_plan(plan, a, b, backend)
    a2 = a.expand(*batch, *a.shape[-2:]).reshape(-1, *a.shape[-2:])
    b2 = b.expand(*batch, *b.shape[-2:]).reshape(-1, *b.shape[-2:])
    outs = [execute_plan(plan, x, y, backend) for x, y in zip(a2, b2)]
    return torch.stack(outs).reshape(*batch, *outs[0].shape)


# ====================================================== prepared operands


def _kernel_backend():
    from ..kernels.ops import KernelBackend  # the kernels import this module

    return KernelBackend()


class PreparedOperand:
    """One-time residue cast of a reused operand (port of
    `repro.core.executor.PreparedOperand`).

    Weight-stationary serving (Y = X_i @ W) and repeated applications of a
    fixed operand pay step 1 of the scheme (scaling, truncation, N residue
    planes) once.  The fast (Cauchy-Schwarz) scaling of one operand does
    not depend on the other, so `gemm_prepared` is bitwise equal to the
    direct fast-mode pipeline.

    Accurate mode (``keep_raw=True``, done by `prepare_weights` for accu
    policies) stores the per-row/column 7-bit bound (`bound`/`e_bound`,
    paper eqs. 13-14) and the raw operand instead of planes: the accurate
    exponents couple both operands, so the planes are re-cast per call.

    Fields, as in the reference: `side` ('left' prepares A row-wise,
    'right' B column-wise), `n_moduli`, `n_limbs`, `dtype` (a name),
    `e_scale`, `residues` (one plane stack, or the real/imag pair),
    `bound`, `e_bound` and `raw`.  Leading batch dims of `x` are prepared
    one matrix at a time and stacked.

    `backend` runs the residue cast; None means the kernel backend, whose
    f32 cast the kernel, fused and fp8 executions share (the reference
    defaults to its jnp backend; `prepare_weights` passes the policy's
    execution backend, `REFERENCE` on the default execution).  `device`: where the operand and its planes live; None
    means the card, as for the `linalg` entry points.
    """

    def __init__(self, x, n_moduli: int | None = None, side: str = "left", backend=None,
                 keep_raw: bool = False, device=None):
        if side not in ("left", "right"):
            raise ValueError(side)
        if backend is None:
            backend = _kernel_backend()
        x = torch.as_tensor(x, device=resolve_device(device))
        dt = dtype_name(x.dtype)
        if n_moduli is None:
            n_moduli = default_n_moduli(dt, "fast")
        n_moduli = int(n_moduli)
        ctx = make_crt_context(n_moduli)
        nl = n_limbs_for_ctx(ctx)
        axis = 0 if side == "left" else 1
        batch = x.shape[:-2]
        mats = x.reshape(-1, *x.shape[-2:])

        def per_matrix(fn):
            """fn(matrix) -> tuple of tensors, stacked over the batch dims
            (written into one buffer per field as each matrix is done, so a
            stacked weight never holds its planes twice)."""
            outs = None
            for i, x2 in enumerate(mats):
                cols = fn(x2)
                if outs is None:
                    outs = [c.new_empty((len(mats), *c.shape)) for c in cols]
                for out, c in zip(outs, cols):
                    out[i] = c
            return [out.reshape(*batch, *out.shape[1:]) for out in outs]

        def prep_fast(x2):
            if x2.is_complex():
                xr, xi = x2.real, x2.imag
                e = _solo_scale_complex(xr, xi, ctx, side)
                return (e, *_cast_pair(backend, xr, xi, e, axis, ctx, nl))
            e = _solo_scale_real(x2, ctx, side)
            return e, backend.cast(x2, e, axis, ctx, nl)

        def prep_bound(x2):
            if x2.is_complex():
                bars, e_bar, _ = scaling.accu_bound_complex(x2.real, x2.imag, side)
                return (*bars, e_bar)
            bar, e_bar, _ = scaling.accu_bound_real(x2, side)
            return bar, e_bar

        # fast preparation stores planes, accu preparation the bound and
        # the raw operand: the executions read disjoint things
        e_scale, res = None, []
        bound, e_bound = [], None
        if keep_raw:
            *bound, e_bound = per_matrix(prep_bound)
        else:
            e_scale, *res = per_matrix(prep_fast)

        self.side = side
        self.n_moduli = n_moduli
        self.n_limbs = nl
        self.dtype = dt
        self.e_scale = e_scale
        self.residues = tuple(res)
        self.bound = tuple(bound)
        self.e_bound = e_bound
        self.raw = x if keep_raw else None

    @classmethod
    def abstract(cls, shape, dtype, n_moduli: int, side: str = "right",
                 keep_raw: bool = False) -> "PreparedOperand":
        """The operand `PreparedOperand(x, n_moduli, side, keep_raw=...)`
        would build for an `x` of `shape` and `dtype`, with every field a
        tensor on the "meta" device: its structure and metadata, and no
        cast (the port's `jax.eval_shape` of a preparation)."""
        dt = dtype_name(dtype)
        ctx = make_crt_context(int(n_moduli))
        *batch, rows, cols = (int(d) for d in shape)
        meta = lambda *s, dtype: torch.empty(*s, dtype=dtype, device="meta")  # noqa: E731
        parts = 2 if dt.startswith("complex") else 1
        n_exp = rows if side == "left" else cols
        p = object.__new__(cls)
        p.side, p.n_moduli, p.n_limbs, p.dtype = side, ctx.n, n_limbs_for_ctx(ctx), dt
        p.e_scale = None if keep_raw else meta(*batch, n_exp, dtype=torch.int32)
        p.residues = () if keep_raw else tuple(
            meta(*batch, ctx.n, rows, cols, dtype=torch.int8) for _ in range(parts))
        p.bound = tuple(meta(*batch, rows, cols, dtype=torch.int8) for _ in range(parts)) if keep_raw else ()
        p.e_bound = meta(*batch, n_exp, dtype=torch.int32) if keep_raw else None
        p.raw = meta(*batch, rows, cols, dtype=DTYPES[dt]) if keep_raw else None
        return p

    def layer(self, i: int) -> "PreparedOperand":
        """Batch element `i` of a preparation with leading batch dims (layer
        `i` of a stacked (L, k, n) weight): views of every field at [i],
        bitwise what preparing that matrix alone gives."""
        if self.batch_ndim < 1:
            raise ValueError(f"{self!r} has no leading batch dim to index")
        p = object.__new__(PreparedOperand)
        p.side, p.n_moduli, p.n_limbs, p.dtype = self.side, self.n_moduli, self.n_limbs, self.dtype
        pick = lambda t: None if t is None else t[i]  # noqa: E731
        p.e_scale, p.e_bound, p.raw = pick(self.e_scale), pick(self.e_bound), pick(self.raw)
        p.residues = tuple(r[i] for r in self.residues)
        p.bound = tuple(b[i] for b in self.bound)
        return p

    @property
    def res(self):
        """Residues of the real part (the reference's historical name)."""
        return self.residues[0]

    @property
    def is_complex(self) -> bool:
        return self.dtype.startswith("complex")

    @property
    def mode(self) -> str:
        """The scaling mode this operand was prepared for, read from what it
        stores: planes for fast, bound + raw operand for accu."""
        return "fast" if self.residues else "accu"

    @property
    def ctx(self) -> CRTContext:
        return make_crt_context(self.n_moduli)

    @property
    def batch_ndim(self) -> int:
        """Leading batch dims of the prepared operand (0 = a plain matrix)."""
        if self.residues:
            return self.residues[0].ndim - 3  # (.., N, m, k) planes
        return self.bound[0].ndim - 2  # (.., m, k) bound matrix

    @property
    def operand_shape(self) -> tuple[int, int]:
        """Logical (rows, cols) of the prepared operand (per batch element)."""
        arrs = self.residues if self.residues else self.bound
        return tuple(arrs[0].shape[-2:])

    def __repr__(self):
        return (
            f"PreparedOperand(side={self.side!r}, dtype={self.dtype}, "
            f"mode={self.mode!r}, n_moduli={self.n_moduli}, "
            f"shape={self.operand_shape})"
        )


def _solo_scale_real(x, ctx, side):
    """Fast-mode exponent of one operand alone (a zero other operand)."""
    if side == "left":
        e, _ = scaling.scale_fast_real(x, x.new_zeros((x.shape[1], 1), dtype=torch.float64), ctx)
    else:
        _, e = scaling.scale_fast_real(x.new_zeros((1, x.shape[0]), dtype=torch.float64), x, ctx)
    return e


def _solo_scale_complex(xr, xi, ctx, side):
    if side == "left":
        z = xr.new_zeros((xr.shape[1], 1), dtype=torch.float64)
        e, _ = scaling.scale_fast_complex(xr, xi, z, z, ctx)
    else:
        z = xr.new_zeros((1, xr.shape[0]), dtype=torch.float64)
        _, e = scaling.scale_fast_complex(z, z, xr, xi, ctx)
    return e


def _gemm_prepared_accu(prep, x, plan, backend):
    """Accurate-mode prepared product: reuse the stored 7-bit bound, re-cast
    from the raw operand at the call-time coupled exponents — the
    operations of `_execute_real` / `_execute_complex` in the same order,
    hence bitwise equal to the unprepared accu run."""
    if prep.raw is None:
        raise ValueError(
            "accu-mode prepared matmuls re-cast from the raw operand (the "
            "accurate exponents couple both operands); prepare with "
            "keep_raw=True / prepare_weights(accu policy)"
        )
    ctx = prep.ctx
    other = "left" if prep.side == "right" else "right"
    reduce = 1 if prep.side == "left" else 0

    if prep.is_complex:
        xr, xi = x.real, x.imag
        xbar, e_xbar, x_nz = scaling.accu_bound_complex(xr, xi, other)
        pbar, e_pbar = prep.bound, prep.e_bound
        p_nz = torch.maximum(*[b.to(torch.int32) for b in pbar]).amax(dim=reduce) > 0
        wr, wi = prep.raw.real, prep.raw.imag
        if prep.side == "left":
            cmax = scaling.accu_cbar_complex(pbar, xbar)
            e_mu, e_nu = scaling.accu_exponents(cmax, e_pbar, e_xbar, p_nz, x_nz, ctx)
            return _pipeline_complex(plan, backend, ctx, e_mu, wr, wi, e_nu, xr, xi)
        cmax = scaling.accu_cbar_complex(xbar, pbar)
        e_mu, e_nu = scaling.accu_exponents(cmax, e_xbar, e_pbar, x_nz, p_nz, ctx)
        return _pipeline_complex(plan, backend, ctx, e_mu, xr, xi, e_nu, wr, wi)

    xbar, e_xbar, x_nz = scaling.accu_bound_real(x, other)
    pbar, e_pbar = prep.bound[0], prep.e_bound
    p_nz = pbar.to(torch.int32).amax(dim=reduce) > 0
    if prep.side == "left":
        cbar = int8_matmul(pbar, xbar)
        e_mu, e_nu = scaling.accu_exponents(cbar, e_pbar, e_xbar, p_nz, x_nz, ctx)
        return _pipeline_real(plan, backend, ctx, e_mu, prep.raw, e_nu, x)
    cbar = int8_matmul(xbar, pbar)
    e_mu, e_nu = scaling.accu_exponents(cbar, e_xbar, e_pbar, x_nz, p_nz, ctx)
    return _pipeline_real(plan, backend, ctx, e_mu, x, e_nu, prep.raw)


def gemm_prepared(prep: PreparedOperand, x: torch.Tensor, method: str = "garner",
                  formulation: str = "karatsuba", out_dtype=None, n_block=None, backend=None,
                  mode: str = "fast") -> torch.Tensor:
    """Emulated product with one prepared side (port of
    `repro.core.executor.gemm_prepared`).

    side='left':  C ~= prep @ x   (x is B, cast per call)
    side='right': C ~= x @ prep   (x is A, cast per call)

    Bitwise equal to the direct pipeline in both modes.  mode='fast' skips
    the prepared side's cast; on a megakernel backend a right-prepared
    product is one launch per block, the planes feeding the kernel's B
    side.  mode='accu' reuses the stored bound and re-casts from the raw
    operand (`_gemm_prepared_accu`).  `backend` None means the kernel
    backend, as for `PreparedOperand`, so `method` defaults to 'garner'
    (the reference's defaults are its jnp backend and 'paper').
    """
    if backend is None:
        backend = _kernel_backend()
    ctx = prep.ctx
    if prep.batch_ndim != 0:
        raise ValueError(
            "gemm_prepared expects an unbatched (2D) prepared operand; "
            f"got a {prep.batch_ndim}-batched preparation of "
            f"shape {prep.operand_shape}"
        )
    if prep.side == "left":
        m, k = prep.operand_shape
        n = x.shape[1]
    else:
        k, n = prep.operand_shape
        m = x.shape[0]
    plan = make_plan(
        prep.dtype,
        n_moduli=prep.n_moduli,
        mode=mode,
        method=method,
        formulation=formulation if prep.is_complex else None,
        out_dtype=out_dtype or x.dtype,
        n_block=n_block,
        shape=(m, k, n),
        # the 'auto' selections must charge launches and engine operations
        # as the executing backend issues them, or a prepared run could pick
        # another formulation than the unprepared run it must bit-match
        fused_karatsuba=getattr(backend, "fused_karatsuba", False),
        modulus_batched=getattr(backend, "modulus_batched", False),
        megakernel=getattr(backend, "megakernel", False),
        engine=getattr(backend, "engine", "int8"),
    )
    nl = prep.n_limbs
    other_side = "left" if prep.side == "right" else "right"

    if mode == "accu":
        return _gemm_prepared_accu(prep, x, plan, backend)
    if not prep.residues:
        raise ValueError(
            "this operand was prepared for accu mode (bound + raw only); "
            "fast-mode calls consume pre-cast residue planes — re-prepare "
            "with prepare_weights(fast policy)"
        )

    # the megakernel casts the streaming side in its prologue and reads the
    # prepared planes directly.  A LEFT-prepared operand stores planes but
    # no raw matrix, and the prologue needs the raw A tile, so side='left'
    # takes the composed kernel path the megakernel backend inherits.
    fused = _megakernel(backend) and prep.side == "right"

    if prep.is_complex:
        xr, xi = x.real, x.imag
        e_other = _solo_scale_complex(xr, xi, ctx, other_side)
        if prep.side == "left":
            e_mu, e_nu = prep.e_scale, e_other
            arr, ari = prep.residues
            bres_slice = lambda sl: _cast_pair(  # noqa: E731
                backend, xr[:, sl], xi[:, sl], e_nu[sl], 1, ctx, nl)
        else:
            e_mu, e_nu = e_other, prep.e_scale
            planes = lambda sl: tuple(r[..., sl] for r in prep.residues)  # noqa: E731
            if fused:
                return _fused_pipeline_complex(plan, backend, ctx, e_mu, xr, xi, e_nu, None,
                                               planes, n)
            arr, ari = _cast_pair(backend, xr, xi, e_mu, 0, ctx, nl)
            bres_slice = planes
        return _blocked_pipeline_complex(plan, backend, ctx, e_mu, arr, ari, e_nu, bres_slice, n)

    e_other = _solo_scale_real(x, ctx, other_side)
    if prep.side == "left":
        e_mu, e_nu, ares = prep.e_scale, e_other, prep.res
        bres_slice = lambda sl: backend.cast(x[:, sl], e_nu[sl], 1, ctx, nl)  # noqa: E731
    else:
        e_mu, e_nu = e_other, prep.e_scale
        planes = lambda sl: prep.res[..., sl]  # noqa: E731
        if fused:
            return _fused_pipeline_real(plan, backend, ctx, e_mu, x, e_nu, None, planes, n)
        ares = backend.cast(x, e_mu, 0, ctx, nl)
        bres_slice = planes
    return _blocked_pipeline_real(plan, backend, ctx, e_mu, ares, e_nu, bres_slice, n)
