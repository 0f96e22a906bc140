"""The kernel residue backend behind `GemmPolicy(execution="kernel")`.

Port of `repro.kernels.ops.KernelBackend`: it maps the executor's residue
primitives onto the four kernels, one launch each whatever the modulus
count N — `residue_cast` writes all N planes of an operand (real and
imaginary parts stacked), the batched GEMM kernels fold the N planes into
their grid, and `crt_garner` reconstructs the whole (stacked) output.  A
GEMM with k <= 2^17 is therefore cast + cast + product + reconstruct = 4
launches.  Reconstruction is always Garner; f64-grade output uses its
double-single mode, summed in float64 as hi + lo.
"""
from __future__ import annotations

import dataclasses

import torch

from ..core.executor import chunked_residue_matmul
from ..core.moduli import CRTContext
from .common import split_scale_exponent
from .crt_garner import crt_garner
from .int8_mod_gemm import int8_mod_gemm_batched
from .karatsuba_fused import karatsuba_mod_gemm_batched
from .residue_cast import residue_cast


@dataclasses.dataclass(frozen=True)
class KernelBackend:
    """Residue backend running the modulus-batched kernels: every primitive
    is one launch (the plain PyTorch versions on CPU tensors)."""

    @staticmethod
    def _check_method(method):
        if method != "garner":
            raise ValueError(
                f"the kernel backend only reconstructs via 'garner'; plan "
                f"requested method={method!r}"
            )

    def cast(self, x, e, axis, ctx: CRTContext, n_limbs: int):
        """(m, k) operand -> (N, m, k) int8 residues, 1 launch."""
        return self.cast_stack(x, e, axis, ctx, n_limbs)

    def cast_stack(self, xs, e, axis, ctx: CRTContext, n_limbs: int):
        """(S, m, k) stack sharing one scale vector -> (S, N, m, k), 1 launch."""
        s1, s2 = split_scale_exponent(e)
        return residue_cast(
            xs.to(torch.float32).contiguous(), s1, s2,
            moduli=ctx.moduli, n_limbs=n_limbs, scale_axis=axis,
        )

    def residue_matmul(self, ares, bres, ctx: CRTContext):
        """One batched launch per K-chunk; the inter-chunk sym_mod runs in
        the kernel epilogue via the carry input."""
        return chunked_residue_matmul(
            lambda a, b, carry: int8_mod_gemm_batched(a, b, moduli=ctx.moduli, carry=carry),
            ares, bres,
        )

    def karatsuba(self, arr, ari, brr, bri, ctx: CRTContext):
        """Fused-Karatsuba kernel: one launch per K-chunk for all N planes,
        the CR/CI chunk carries folded into its epilogue."""
        return chunked_residue_matmul(
            lambda a, b, carry: karatsuba_mod_gemm_batched(
                a[0], a[1], b[0], b[1], moduli=ctx.moduli, carry=carry
            ),
            (arr, ari), (brr, bri),
        )

    def reconstruct(self, e_res, e_mu, e_nu, ctx: CRTContext, method, out_dtype):
        """(N, m, n) residues -> (m, n) output, 1 launch."""
        return self.reconstruct_stack(e_res[None], e_mu, e_nu, ctx, method, out_dtype)[0]

    def reconstruct_stack(self, e_res, e_mu, e_nu, ctx: CRTContext, method, out_dtype):
        """(S, N, m, n) residue stacks sharing scale exponents -> (S, m, n)
        outputs in one launch (the executor stacks CR/CI)."""
        self._check_method(method)
        out_dd = out_dtype == torch.float64
        out = crt_garner(e_res.contiguous(), e_mu, e_nu, ctx, out_dd=out_dd)
        if out_dd:
            return out[:, 0].double() + out[:, 1].double()
        return out
