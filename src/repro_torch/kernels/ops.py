"""The residue backends behind `GemmPolicy(execution="kernel")`,
`execution="per_modulus_kernel"`, `execution="fused"` and
`execution="fp8"`.

Port of `repro.kernels.ops`.  `KernelBackend` maps the executor's residue
primitives onto the four kernels, one launch each whatever the modulus
count N — `residue_cast` writes all N planes of an operand (real and
imaginary parts stacked), the batched GEMM kernels fold the N planes into
their grid, and `crt_garner` reconstructs the whole (stacked) output.  A
GEMM with k <= 2^17 is therefore cast + cast + product + reconstruct = 4
launches.  Reconstruction is always Garner; f64-grade output uses its
double-single mode, summed in float64 as hi + lo.

`PerModulusKernelBackend` (execution="per_modulus_kernel") keeps the
pre-batching schedule: one product launch per modulus, the casts and
reconstructions unstacked; bitwise equal to execution="kernel".

`FusedBackend` (execution="fused") runs each emulated GEMM as one launch
of a megakernel instead (`fused_mod_gemm`, `fused_karatsuba_mod_gemm`).

`Fp8Backend` (execution="fp8") keeps the casts and Garner and runs the
residue products on the e4m3 engine (`fp8_mod_gemm_batched`,
`fp8_karatsuba_mod_gemm_batched`): still 4 launches per GEMM, bitwise
equal to execution="kernel".

Every GEMM launch takes the block tile `common.resolve_blocks` gives for
its (family, dtype class, shape): the active calibration's tuned tile,
else the kernel's default.  The capability flags (`fused_karatsuba`,
`modulus_batched`, `megakernel`, `engine`) are the reference backends'
declarations, which the performance model's 'auto' selections price.

`ozaki2_gemm_kernels` / `ozaki2_cgemm_kernels` are the reference's
deprecated entry points, kept as shims over `linalg.matmul` under the
kernel execution.
"""
from __future__ import annotations

import dataclasses

import torch

from ..core import executor
from ..core.executor import chunked_residue_matmul
from ..core.moduli import CRTContext
from . import fp8_mod_gemm
from .common import resolve_blocks, split_scale_exponent
from .crt_garner import crt_garner
from .int8_mod_gemm import fused_mod_gemm, int8_mod_gemm, int8_mod_gemm_batched
from .karatsuba_fused import fused_karatsuba_mod_gemm, karatsuba_mod_gemm, karatsuba_mod_gemm_batched
from .residue_cast import residue_cast


@dataclasses.dataclass(frozen=True)
class _KernelBackendBase:
    """The kernel backends' shared cast and reconstruction: one
    `residue_cast` launch per operand and one `crt_garner` launch per
    output (the plain PyTorch versions on CPU tensors).  Reconstruction is
    always Garner; f64-grade output uses its double-single mode, summed in
    float64 as hi + lo."""

    # both kernel paths fuse the Karatsuba D/E/F triple into one kernel;
    # only the batched subclass folds the N planes into one grid
    fused_karatsuba = True
    modulus_batched = False

    def analyze(self, plan, shape=None):
        """The static-analysis suite certifying this backend running `plan`
        (`repro_torch.analysis.passes_for_backend`): overflow and
        collective safety, and given ``shape = (m, k, n)`` the launch count
        the perfmodel predicts for its capabilities (`modulus_batched`,
        `fused_karatsuba`, `megakernel`, `engine`)."""
        from ..analysis import passes_for_backend

        return passes_for_backend(self, plan, shape)

    @staticmethod
    def _check_method(method):
        if method != "garner":
            raise ValueError(
                f"the kernel backend only reconstructs via 'garner'; plan "
                f"requested method={method!r}"
            )

    def cast(self, x, e, axis, ctx: CRTContext, n_limbs: int):
        """(m, k) operand -> (N, m, k) int8 residues (an (S, m, k) stack
        sharing the scale vector -> (S, N, m, k)), 1 launch."""
        s1, s2 = split_scale_exponent(e)
        return residue_cast(
            x.to(torch.float32).contiguous(), s1, s2,
            moduli=ctx.moduli, n_limbs=n_limbs, scale_axis=axis,
        )

    def reconstruct(self, e_res, e_mu, e_nu, ctx: CRTContext, method, out_dtype):
        """(N, m, n) residues -> (m, n) output (an (S, N, m, n) stack
        sharing the scale exponents -> (S, m, n)), 1 launch."""
        self._check_method(method)
        out_dd = out_dtype == torch.float64
        out = crt_garner(e_res.contiguous(), e_mu, e_nu, ctx, out_dd=out_dd)
        return _dd_sum(out) if out_dd else out


@dataclasses.dataclass(frozen=True)
class KernelBackend(_KernelBackendBase):
    """Residue backend running the modulus-batched kernels: every primitive
    is one launch (the plain PyTorch versions on CPU tensors), and the
    real and imaginary parts of a complex operand or output are stacked
    into one launch (`cast_stack` / `reconstruct_stack`)."""

    modulus_batched = True

    def cast_stack(self, xs, e, axis, ctx: CRTContext, n_limbs: int):
        """(S, m, k) stack sharing one scale vector -> (S, N, m, k), 1 launch."""
        return self.cast(xs, e, axis, ctx, n_limbs)

    def residue_matmul(self, ares, bres, ctx: CRTContext):
        """One batched launch per K-chunk; the inter-chunk sym_mod runs in
        the kernel epilogue via the carry input."""
        return chunked_residue_matmul(
            lambda a, b, carry: int8_mod_gemm_batched(
                a, b, moduli=ctx.moduli, carry=carry, tile=_tile("kernel", "real", a, b)),
            ares, bres, ctx, carry_epilogue=True,
        )

    def karatsuba(self, arr, ari, brr, bri, ctx: CRTContext):
        """Fused-Karatsuba kernel: one launch per K-chunk for all N planes,
        the CR/CI chunk carries folded into its epilogue."""
        return chunked_residue_matmul(
            lambda a, b, carry: karatsuba_mod_gemm_batched(
                a[0], a[1], b[0], b[1], moduli=ctx.moduli, carry=carry,
                tile=_tile("kernel", "complex", a[0], b[0]),
            ),
            (arr, ari), (brr, bri), ctx, carry_epilogue=True,
        )

    def reconstruct_stack(self, e_res, e_mu, e_nu, ctx: CRTContext, method, out_dtype):
        """(S, N, m, n) residue stacks sharing scale exponents -> (S, m, n)
        outputs in one launch (the executor stacks CR/CI)."""
        return self.reconstruct(e_res, e_mu, e_nu, ctx, method, out_dtype)


@dataclasses.dataclass(frozen=True)
class PerModulusKernelBackend(_KernelBackendBase):
    """One product launch per modulus (execution="per_modulus_kernel", port
    of `repro.kernels.ops.PerModulusKernelBackend`): the pre-batching
    schedule, kept as the bitwise parity target of `KernelBackend` and as
    the launch-count contrast of the performance model.  Each product is
    the batched kernel on a grid of one plane (`int8_mod_gemm`,
    `karatsuba_mod_gemm`), K-chunked with the int32 combine between
    chunks; the casts and reconstructions are not stacked, so a complex
    GEMM casts four times and reconstructs twice.
    """

    def _mod_gemm_stack(self, ares, bres, ctx: CRTContext):
        """Un-chunked per-modulus kernel launches (k <= K_CHUNK_LIMIT)."""
        tile = _tile("kernel", "real", ares, bres)
        planes = [int8_mod_gemm(ares[l], bres[l], p=int(ctx.moduli[l]), tile=tile)
                  for l in range(ctx.n)]
        return torch.stack(planes, dim=0)

    def residue_matmul(self, ares, bres, ctx: CRTContext):
        return chunked_residue_matmul(
            lambda a, b: self._mod_gemm_stack(a, b, ctx), ares, bres, ctx)

    def karatsuba(self, arr, ari, brr, bri, ctx: CRTContext):
        tile = _tile("kernel", "complex", arr, brr)
        er_planes, ei_planes = [], []
        for l in range(ctx.n):
            cr, ci = karatsuba_mod_gemm(arr[l], ari[l], brr[l], bri[l], p=int(ctx.moduli[l]),
                                        tile=tile)
            er_planes.append(cr)
            ei_planes.append(ci)
        return torch.stack(er_planes, dim=0), torch.stack(ei_planes, dim=0)


def _tile(family, dclass, a, b):
    """The tile of one launch on (N, m, k) x (N, k, n) planes (or on (m, k)
    x (k, n) operands)."""
    m, k = a.shape[-2:]
    return resolve_blocks(family, dclass, m, b.shape[-1], k)


def _dd_sum(out):
    """The float64 value hi + lo of a (..., 2, m, n) double-single pair."""
    return out.select(-3, 0).double() + out.select(-3, 1).double()


@dataclasses.dataclass(frozen=True)
class FusedBackend(KernelBackend):
    """Residue backend running the one-launch megakernels
    (execution="fused", port of `repro.kernels.ops.FusedBackend`): the
    residue casts run as the kernel's prologue, the N plane products
    accumulate with the K-chunk reduction inside, and Garner runs as the
    epilogue — an emulated GEMM is ONE launch per output-column block, in
    fast and accu mode (the scaling runs outside the kernels).

    The executor dispatches on ``megakernel = True``; a left-prepared
    operand, which stores planes but no raw matrix, takes the composed
    primitives inherited from :class:`KernelBackend`.  Bitwise equal to
    execution="kernel": the prologue and epilogue run the cast's and
    Garner's exact op sequences.
    """

    megakernel = True

    @staticmethod
    def _chunk_limit() -> int:
        # read at call time, so a patch of executor.K_CHUNK_LIMIT governs it
        return executor.K_CHUNK_LIMIT

    def fused_gemm(self, a, b, e_mu, e_nu, ctx: CRTContext, n_limbs, out_dtype, b_res=None):
        out_dd = out_dtype == torch.float64
        out = fused_mod_gemm(
            a, b, e_mu, e_nu, ctx, n_limbs=n_limbs, out_dd=out_dd, b_res=b_res,
            chunk_limit=self._chunk_limit(),
            tile=_tile("fused", "real", a, b if b_res is None else b_res),
        )
        return _dd_sum(out) if out_dd else out

    def fused_karatsuba_gemm(self, ar, ai, br, bi, e_mu, e_nu, ctx: CRTContext, n_limbs,
                             out_dtype, b_res=None):
        out_dd = out_dtype == torch.float64
        cr, ci = fused_karatsuba_mod_gemm(
            ar, ai, br, bi, e_mu, e_nu, ctx, n_limbs=n_limbs, out_dd=out_dd, b_res=b_res,
            chunk_limit=self._chunk_limit(),
            tile=_tile("fused", "complex", ar, br if b_res is None else b_res[0]),
        )
        return (_dd_sum(cr), _dd_sum(ci)) if out_dd else (cr, ci)


@dataclasses.dataclass(frozen=True)
class Fp8Backend(KernelBackend):
    """Residue backend running the modular products on the e4m3 engine
    (execution="fp8", port of `repro.core.executor.Fp8Backend`).

    The casts and the Garner reconstruction are the kernel backend's
    (inherited, as the reference delegates them), so the plane layout and
    the f32 quantization grade are the same; `residue_matmul` is one
    `fp8_mod_gemm_batched` launch and `karatsuba` one
    `fp8_karatsuba_mod_gemm_batched` launch per K-chunk of at most
    `FP8_K_CHUNK_LIMIT` (the f32 digit sums' bound), the previous chunk's
    residues folded in through the carry.  The digit split is exact, so the
    whole pipeline is bitwise equal to execution="kernel".  The flags are
    the reference's capability declarations.
    """

    engine = "fp8"

    def residue_matmul(self, ares, bres, ctx: CRTContext):
        return chunked_residue_matmul(
            lambda a, b, carry: fp8_mod_gemm.fp8_mod_gemm_batched(
                a, b, moduli=ctx.moduli, carry=carry, tile=_tile("fp8", "real", a, b)),
            ares, bres, ctx, carry_epilogue=True,
            chunk_limit=fp8_mod_gemm.FP8_K_CHUNK_LIMIT,  # read at call time: tests patch it
        )

    def karatsuba(self, arr, ari, brr, bri, ctx: CRTContext):
        return chunked_residue_matmul(
            lambda a, b, carry: fp8_mod_gemm.fp8_karatsuba_mod_gemm_batched(
                a[0], a[1], b[0], b[1], moduli=ctx.moduli, carry=carry,
                tile=_tile("fp8", "complex", a[0], b[0])),
            (arr, ari), (brr, bri), ctx, carry_epilogue=True,
            chunk_limit=fp8_mod_gemm.FP8_K_CHUNK_LIMIT,
        )


def _kernels_shim_policy(name, backend, **kw):
    from ..core.gemm import _deprecated
    from ..core.policy import GemmPolicy

    policy = GemmPolicy(backend=backend, execution="kernel", **kw)
    # stacklevel 4: user -> ozaki2_*_kernels -> here -> _deprecated
    _deprecated(name, policy, stacklevel=4)
    return policy


def ozaki2_gemm_kernels(a, b, n_moduli: int | None = None, mode: str = "fast",
                        n_block: int | None = None, *, device=None) -> torch.Tensor:
    """Kernel-path real GEMM emulation (f32 in / f32 out).

    .. deprecated:: use ``repro_torch.linalg.matmul`` with a
       ``GemmPolicy(backend="ozaki2_f32", execution="kernel")`` instead.

    The reference's ``interpret`` argument has no counterpart: ``device``
    picks the card (None) or the plain versions (``"cpu"``).
    """
    policy = _kernels_shim_policy(
        "ozaki2_gemm_kernels", "ozaki2_f32",
        n_moduli=None if n_moduli is None else int(n_moduli),
        mode=mode, n_block=n_block, out_dtype="float32",
    )
    from .. import linalg

    return linalg.matmul(a, b, policy=policy, device=device)


def ozaki2_cgemm_kernels(a, b, n_moduli: int | None = None, mode: str = "fast",
                         formulation: str = "karatsuba", n_block: int | None = None, *,
                         device=None) -> torch.Tensor:
    """Kernel-path complex GEMM emulation (complex64 in/out).

    .. deprecated:: use ``repro_torch.linalg.matmul`` with a
       ``GemmPolicy(backend="ozaki2_c64", execution="kernel",
       formulation=...)`` instead.
    """
    policy = _kernels_shim_policy(
        "ozaki2_cgemm_kernels", "ozaki2_c64",
        n_moduli=None if n_moduli is None else int(n_moduli),
        mode=mode, formulation=formulation, n_block=n_block, out_dtype="complex64",
    )
    from .. import linalg

    return linalg.matmul(a, b, policy=policy, device=device)
