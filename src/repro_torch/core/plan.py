"""Static emulation plans: every Ozaki-II GEMM is described by one object.

The port's copy of `repro.core.plan`.  An :class:`EmulationPlan` holds the
static decisions of one emulated GEMM — dtype class, number of CRT moduli,
scaling mode, reconstruction method, complex formulation, output blocking —
and nothing data-dependent.  `make_plan` applies the paper's per-dtype
moduli defaults and — when the caller passes ``formulation="auto"`` /
``n_block="auto"`` with a shape hint — consults the SIII-C performance
model (`core/perfmodel.py`) to pick the complex formulation and the
output-column blocking, charging launches per the executing backend's
capabilities (`fused_karatsuba`, `modulus_batched`, `megakernel`,
`engine`), which `GemmPolicy.plan_for` reads from the execution.
"""
from __future__ import annotations

import dataclasses
import math

import torch

from .moduli import CRTContext, make_crt_context
from .residues import num_limbs_for_bits

# Defaults matching the paper's accuracy bands (SIV-A / [30]).
DEFAULT_MODULI = {
    ("float32", "fast"): 8,
    ("float32", "accu"): 7,
    ("float64", "fast"): 16,
    ("float64", "accu"): 15,
    ("complex64", "fast"): 7,
    ("complex64", "accu"): 7,
    ("complex128", "fast"): 14,
    ("complex128", "accu"): 14,
}

# Paper SIII-A: output-column blocks of 8192; used by n_block="auto".
DEFAULT_N_BLOCK = 8192

REAL_FORMULATION = "real"
COMPLEX_FORMULATIONS = ("karatsuba", "block_a", "block_b")

DTYPES = {
    "float32": torch.float32,
    "float64": torch.float64,
    "complex64": torch.complex64,
    "complex128": torch.complex128,
}
_REAL_OF_COMPLEX = {"complex64": "float32", "complex128": "float64"}


def dtype_name(dtype) -> str:
    """Canonical name of a torch dtype or dtype name ('float32', ...)."""
    if isinstance(dtype, torch.dtype):
        name = str(dtype).removeprefix("torch.")
    else:
        name = str(dtype)
    if name not in DTYPES:
        raise ValueError(f"unsupported dtype {dtype!r}")
    return name


def default_n_moduli(dtype, mode: str) -> int:
    key = (dtype_name(dtype), mode)
    if key not in DEFAULT_MODULI:
        raise ValueError(f"no default moduli count for {key}")
    return DEFAULT_MODULI[key]


def n_limbs_for_ctx(ctx: CRTContext) -> int:
    """Limb count for the residue decomposition of one CRT context:
    |a'| <= 2^(P'_accu + 6) <= 2^(log2(P)/2 + 6); +2 safety margin."""
    return num_limbs_for_bits(ctx.log2_P / 2.0 + 8.0)


@dataclasses.dataclass(frozen=True)
class EmulationPlan:
    """Static description of one emulated GEMM (real or complex)."""

    dtype: str                 # compute dtype name (float32/.../complex128)
    n_moduli: int
    mode: str                  # 'fast' | 'accu'
    method: str                # CRT reconstruction ('garner' on the kernel path)
    formulation: str           # 'real' | 'karatsuba' | 'block_a' | 'block_b'
    n_block: int | None        # output-column blocking (paper SIII-A)
    out_dtype: str             # result dtype name
    rtol: float | None = None  # declared accuracy contract (metadata only:
    # the tolerance an adaptive policy resolved this plan for; never read by
    # the executor)

    @property
    def is_complex(self) -> bool:
        return self.formulation != REAL_FORMULATION

    @property
    def ctx(self) -> CRTContext:
        return make_crt_context(self.n_moduli)

    @property
    def n_limbs(self) -> int:
        return n_limbs_for_ctx(self.ctx)

    @property
    def real_out_dtype(self) -> torch.dtype:
        """dtype of each real component of the output."""
        name = self.out_dtype
        return DTYPES[_REAL_OF_COMPLEX.get(name, name)]

    def n_block_slices(self, n: int):
        """Output-column block slices (one full slice when unblocked)."""
        nb = self.n_block or n
        return [slice(j0, j0 + nb) for j0 in range(0, n, nb)]


def make_plan(
    dtype,
    n_moduli: int | None = None,
    mode: str = "fast",
    method: str = "paper",
    formulation: str | None = None,
    out_dtype=None,
    n_block=None,
    shape: tuple[int, int, int] | None = None,
    hw=None,
    fused_karatsuba: bool = False,
    modulus_batched: bool = False,
    megakernel: bool = False,
    comm_s: float = 0.0,
    engine: str = "int8",
    rtol: float | None = None,
) -> EmulationPlan:
    """Build an :class:`EmulationPlan` from user-facing knobs.

    formulation: for complex plans 'karatsuba' | 'block_a' | 'block_b' |
      'auto' (perfmodel-driven, needs `shape`).
    n_block: int, None, or 'auto' (the paper's 8192 blocking, balanced;
      needs the (m, k, n) `shape` hint).
    hw: `perfmodel.HW` target for 'auto' (default `perfmodel.default_hw()`:
      the active calibration's measured card, else the GH200 preset).
    fused_karatsuba / modulus_batched / megakernel / engine: how the
      executing backend launches (the Karatsuba triple in one launch, all N
      planes in one launch, the whole GEMM in one launch, the residue
      products on 'int8' or 'fp8'), which the 'auto' selection prices.
    comm_s: a sharded execution's collective cost, folded into the totals.
    rtol: the declared componentwise tolerance (metadata on the plan).
    """
    dt = dtype_name(dtype)
    if mode not in ("fast", "accu"):
        raise ValueError(f"unknown mode {mode!r}")
    is_complex = dt.startswith("complex")
    if n_moduli is None:
        n_moduli = default_n_moduli(dt, mode)
    out_dt = dtype_name(out_dtype or dt)
    if out_dt.startswith("complex") != is_complex:
        raise ValueError(
            f"out_dtype {out_dt} does not match the "
            f"{'complex' if is_complex else 'real'} compute dtype {dt}"
        )

    if not is_complex:
        formulation = REAL_FORMULATION
    else:
        formulation = formulation or "karatsuba"
        if formulation == "auto":
            formulation = _auto_formulation(
                shape, int(n_moduli), mode, dt, hw, fused_karatsuba,
                modulus_batched, megakernel, comm_s, engine,
            )
        if formulation not in COMPLEX_FORMULATIONS:
            raise ValueError(f"unknown complex formulation {formulation!r}")

    if n_block == "auto":
        n_block = _auto_n_block(shape)
    if n_block is not None:
        n_block = int(n_block)
        if n_block <= 0:
            raise ValueError(f"n_block must be positive, got {n_block}")

    return EmulationPlan(
        dtype=dt,
        n_moduli=int(n_moduli),
        mode=mode,
        method=method,
        formulation=formulation,
        n_block=n_block,
        out_dtype=out_dt,
        rtol=rtol,
    )


def _auto_formulation(shape, n_moduli, mode, dt, hw, fused_karatsuba=False,
                      modulus_batched=False, megakernel=False, comm_s=0.0, engine="int8"):
    from . import perfmodel

    if shape is None:
        raise ValueError(
            "formulation='auto' needs the (m, k, n) shape hint to consult "
            "the performance model; pass shape= or pick a formulation"
        )
    m, k, n = shape
    prec = "c" if dt == "complex64" else "z"
    return perfmodel.select_formulation(
        m, n, k, n_moduli,
        hw=hw or perfmodel.default_hw(),
        mode=mode,
        prec=prec,
        karatsuba_launches=1 if fused_karatsuba else 3,
        modulus_batched=modulus_batched,
        megakernel=megakernel,
        comm_s=comm_s,
        engine=engine,
    )


def _auto_n_block(shape) -> int | None:
    if shape is None:
        raise ValueError(
            "n_block='auto' needs the (m, k, n) shape hint; pass shape= "
            "or an explicit block size"
        )
    n = shape[2]
    if n <= DEFAULT_N_BLOCK:
        return None
    # round the block count up so blocks stay balanced
    blocks = math.ceil(n / DEFAULT_N_BLOCK)
    return math.ceil(n / blocks)
