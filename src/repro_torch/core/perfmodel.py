"""The paper's performance model (SIII-C), parameterized by hardware.

The port's copy of `repro.core.perfmodel` (plain Python floats, no
framework):

  t = mem_bytes(m, n, k, N, c, mode, prec) / b  +  int8_ops(...) / p

with b = sustained memory bandwidth (B/s) and p = int8 engine throughput
(OPS).  TFLOPS is reported as 8 m n k / t * 1e-12 (complex GEMM flops).

Hardware presets include the paper's GPUs and the reference's TPU v5e
target.  **One difference from the reference**: with no calibration active,
`default_hw()` returns the `GH200` preset (the nearest Hopper part among
the presets) instead of `TPU_V5E`, so the port's 'auto' decisions are
priced for the card it runs on.  A measured H100 (`repro_torch.tune`,
`HW.from_calibration`) replaces the preset whenever a calibration is
active.

Beyond-paper terms live here too, because the 'auto' plan selections
(`formulation="auto"` / `n_block="auto"` in `core/plan.py`, `mode="auto"`
/ `rtol` in `core/policy.py`) must price them:

* an *engine axis* for the residue products: the int8 path is the paper's
  model verbatim; the FP8 (e4m3) engine of `execution="fp8"`
  (arXiv:2603.10634) charges `ENGINE_OP_FACTOR["fp8"]` = 4 digit-GEMM
  volumes at the hardware's e4m3 rate (`HW.fp8_ops`, `engine_rate`), with
  unchanged memory terms (both engines move the same int8 residue planes).
  `select_engine` compares the two per shape;
* a *communication term* for a sharded execution — the exact
  partial-reconstruction combine all-reduces `crt_partial_parts(N)` f64
  planes of the output over the residue axis (`sharded_comm_time_s`);
* the *kernel block-selection* rule of the reference's Pallas kernels
  (`select_block` / `padded_dim`), kept term for term.
"""
from __future__ import annotations

import dataclasses
import math

from .moduli import default_moduli

# Fixed per-GEMM-launch overhead (dispatch + epilogue barrier), used by the
# formulation auto-selection: Karatsuba issues 3N small GEMMs per product,
# the block embeddings one 4x-sized GEMM per modulus — at small m,n,k the
# launch term dominates and the embeddings win (paper Fig. 1 crossover).
# The modulus-batched kernels fold the N planes into one grid dimension,
# collapsing the per-modulus factor to 1 (`modulus_batched`).
# This module constant is the *preset* default; a calibrated `HW`
# (`HW.from_calibration`, `repro_torch.tune`) carries the measured value in its
# `gemm_launch_s` field, which is what the model terms actually read.
GEMM_LAUNCH_S = 5e-6


# Fixed per-collective dispatch overhead (psum/all-gather launch + barrier),
# charged once per output-column block by the sharded execution (each block
# reconstructs — and therefore combines — separately).  Preset default of
# `HW.collective_launch_s`, same calibration story as `GEMM_LAUNCH_S`.
COLLECTIVE_LAUNCH_S = 2e-5


@dataclasses.dataclass(frozen=True)
class HW:
    name: str
    mem_bw: float          # B/s
    int8_ops: float        # OPS
    native_c64: float      # native CGEMM flop/s (for speedup comparisons)
    native_c128: float     # native ZGEMM flop/s
    # sustained per-device collective (all-reduce) bandwidth, B/s — the
    # denominator of the sharded-execution psum term.  Order-of-magnitude
    # presets (v5e: 4x ICI links); refine with the calibration microbench.
    ici_bw: float = 9e10
    # e4m3 MAC throughput (OPS) of the fp8 engine (`execution="fp8"`); 0.0
    # means "no native fp8 matmul" — the engine then runs at the upconvert
    # (bf16-grade) rate, approximated as int8_ops / 2.  NVIDIA/AMD parts
    # run e4m3 at the int8 rate; B200's fp8 tensor cores match its int8
    # dense rate; v5e has no fp8 MXU (v5p/v6 do).
    fp8_ops: float = 0.0
    # per-launch / per-collective dispatch overheads (s).  The presets keep
    # the historical module constants; `HW.from_calibration` replaces them
    # with values measured on the live device (`repro_torch.tune.calibrate`).
    gemm_launch_s: float = GEMM_LAUNCH_S
    collective_launch_s: float = COLLECTIVE_LAUNCH_S

    @classmethod
    def from_calibration(cls, meas, name: str = "calibrated") -> "HW":
        """An `HW` built from the `repro_torch.tune.calibrate` measurement dict.

        Required keys: ``mem_bw`` (B/s) and ``int8_ops`` (OPS, mul+add
        counted separately — the model's `p`).  Optional keys fall back to
        the field defaults (`fp8_ops=0` = no native fp8; `ici_bw`, launch
        overheads = the preset constants), so a partial measurement — e.g.
        single-device hosts never measure psum bandwidth — still yields a
        usable model.  Zero/negative optional values are treated as "not
        measured".
        """
        def _opt(key, default):
            v = float(meas.get(key) or 0.0)
            return v if v > 0 else default

        return cls(
            name=name,
            mem_bw=float(meas["mem_bw"]),
            int8_ops=float(meas["int8_ops"]),
            native_c64=_opt("native_c64", 0.0),
            native_c128=_opt("native_c128", 0.0),
            ici_bw=_opt("ici_bw", 9e10),
            fp8_ops=_opt("fp8_ops", 0.0),
            gemm_launch_s=_opt("gemm_launch_s", GEMM_LAUNCH_S),
            collective_launch_s=_opt("collective_launch_s", COLLECTIVE_LAUNCH_S),
        )


TPU_V5E = HW("tpu-v5e", 819e9, 394e12, 197e12, 0.0)  # no native f64 at all
GH200 = HW("gh200", 4000e9, 1979e12, 67e12, 34e12, ici_bw=45e10,
           fp8_ops=1979e12)
B200 = HW("b200", 8000e9, 4500e12, 75e12, 37e12, ici_bw=90e10,
          fp8_ops=4500e12)
RTX5080 = HW("rtx5080", 960e9, 450e12, 56e12, 0.88e12, ici_bw=3e10,
             fp8_ops=450e12)
MI300X = HW("mi300x", 5300e9, 2615e12, 163e12, 163e12, ici_bw=45e10,
            fp8_ops=2615e12)

HARDWARE = {h.name: h for h in (TPU_V5E, GH200, B200, RTX5080, MI300X)}


def default_hw() -> HW:
    """The `HW` every ``hw=None`` model query prices against.

    The active calibration's *measured* hardware when a `repro_torch.tune`
    calibration scope is live (`use_calibration` / `set_calibration` / a
    `GemmPolicy(calibration=...)` pin), else the **GH200** preset — not the
    reference's TPU v5e: the port runs on a Hopper card, and GH200 is the
    nearest Hopper preset.
    """
    # lazy import: tune depends on this module, not the other way around
    from ..tune.cache import current_calibration

    cal = current_calibration()
    return cal.hw if cal is not None else GH200


# ------------------------------------------------------------ engine terms

# MAC-volume multiplier of each residue-product engine, relative to the int8
# path's one (m,k,n) GEMM per plane.  The fp8 engine (e4m3 significand = 4
# bits < the 7-bit residues) splits every residue into two balanced base-16
# digits and runs HH + LL + the doubled-K cross GEMM — 4 digit-GEMM volumes
# per plane (`kernels/fp8_mod_gemm.py`).
ENGINE_OP_FACTOR = {"int8": 1.0, "fp8": 4.0}


def engine_rate(hw: HW, engine: str) -> float:
    """Sustained MAC throughput (OPS) of `engine` on `hw` (see `HW.fp8_ops`)."""
    if engine == "int8":
        return hw.int8_ops
    if engine == "fp8":
        return hw.fp8_ops if hw.fp8_ops > 0 else hw.int8_ops / 2.0
    raise ValueError(f"unknown engine {engine!r}")


ENGINES = tuple(ENGINE_OP_FACTOR)


def complex_time_s(
    m: int,
    n: int,
    k: int,
    n_moduli: int,
    hw: HW,
    mode: str = "fast",
    prec: str = "z",     # 'z' (complex128 in) | 'c' (complex64 in)
    c: float | None = None,
    engine: str = "int8",
) -> float:
    """Paper SIII-C total-time model for complex GEMM emulation.

    `engine` prices the residue-product MACs: 'int8' is the paper's model
    verbatim; 'fp8' charges `ENGINE_OP_FACTOR` digit-GEMM volumes at the
    e4m3 rate (the memory terms are unchanged — both engines move the same
    int8 residue planes; the digit split happens in-register).
    """
    N = n_moduli
    cc = float(c if c is not None else N)
    b, p = hw.mem_bw, engine_rate(hw, engine) / ENGINE_OP_FACTOR[engine]
    if mode == "fast":
        if prec == "z":
            mem = ((3 * N + 32 + cc) * k + 4) * (m + n) + (16 * N + 16 + 2 * cc) * m * n
        else:
            mem = ((3 * N + 16 + cc) * k + 4) * (m + n) + (16 * N + 8 + 2 * cc) * m * n
        ops = 6 * N * m * n * k
    elif mode == "accu":
        if prec == "z":
            mem = ((35 + 3 * N + cc) * k + 8) * (m + n) + (16 * N + 40 + 2 * cc) * m * n
        else:
            mem = ((19 + 3 * N + cc) * k + 8) * (m + n) + (16 * N + 32 + 2 * cc) * m * n
        ops = 6 * (N + 1) * m * n * k
    else:
        raise ValueError(mode)
    return mem / b + ops / p


def complex_tflops(m, n, k, n_moduli, hw: HW, mode="fast", prec="z", c=None,
                   engine="int8"):
    t = complex_time_s(m, n, k, n_moduli, hw, mode, prec, c, engine)
    return 8.0 * m * n * k / t * 1e-12


def real_time_s(m, n, k, n_moduli, hw: HW, mode="fast", prec="d", c=None,
                engine="int8"):
    """Real-GEMM variant ([30] + SIV-C): N engine GEMMs of (m,k,n)."""
    N = n_moduli
    cc = float(c if c is not None else N)
    b, p = hw.mem_bw, engine_rate(hw, engine) / ENGINE_OP_FACTOR[engine]
    in_bytes = 8 if prec == "d" else 4
    mem = ((N + 2 * in_bytes + cc) * k + 2) * (m + n) + (6 * N + in_bytes + 2 * cc) * m * n
    ops = 2 * (N if mode == "fast" else N + 1) * m * n * k
    return mem / b + ops / p


def real_tflops(m, n, k, n_moduli, hw: HW, mode="fast", prec="d", c=None,
                engine="int8"):
    t = real_time_s(m, n, k, n_moduli, hw, mode, prec, c, engine)
    return 2.0 * m * n * k / t * 1e-12


def crt_partial_parts(n_moduli: int) -> int:
    """Number of exact f64 part-planes the sharded combine all-reduces per
    output element: the width of the reference's `core/crt.partial_split`
    for the default moduli (the weights w_l = (P/p_l) q_l cut into parts of
    53 - 7 - ceil(log2 N) bits)."""
    moduli = default_moduli(n_moduli)
    P = math.prod(moduli)
    ws = [(P // p) * pow((P // p) % p, -1, p) for p in moduli]
    part_bits = 53 - 7 - max(1, math.ceil(math.log2(max(n_moduli, 2))))
    return max(1, -(-max(w.bit_length() for w in ws) // part_bits))


def sharded_comm_time_s(
    m: int,
    n: int,
    n_moduli: int,
    residue_shards: int,
    hw: HW | None = None,
    complex_: bool = False,
    n_blocks: int = 1,
) -> float:
    """Communication term of one sharded emulated GEMM (per-shard m, n).

    The residue-sharded pipeline communicates exactly one thing: the
    all-reduce of the `crt_partial_parts(N)` exact f64 partial-reconstruction
    planes over the residue axis (complex outputs stack CR/CI, 2x); no int8
    residue plane crosses devices.  Ring all-reduce moves ~(r-1)/r of the
    payload per device.
    """
    if residue_shards <= 1:
        return 0.0
    hw = hw or default_hw()
    parts = crt_partial_parts(n_moduli)
    stack = 2 if complex_ else 1
    byts = parts * 8 * m * n * stack * (residue_shards - 1) / residue_shards
    return n_blocks * hw.collective_launch_s + byts / hw.ici_bw


def formulation_time_s(
    formulation: str,
    m: int,
    n: int,
    k: int,
    n_moduli: int,
    hw: HW,
    mode: str = "fast",
    prec: str = "z",
    karatsuba_launches: int = 3,
    modulus_batched: bool = False,
    megakernel: bool = False,
    comm_s: float = 0.0,
    engine: str = "int8",
) -> float:
    """SIII-C time model specialized per Fig. 1 complex-product strategy.

    `complex_time_s` assumes the Karatsuba op count (6 N m n k int8 ops);
    the block embeddings (eqs. 7/8) do 4 real products worth (8 N m n k) and
    additionally materialize the embedded operands in HBM, but need only one
    GEMM launch per modulus.  Accu mode prices one extra modulus plane
    (matching `complex_time_s`'s 6(N+1) op count) in every per-plane term.
    `karatsuba_launches` is per modulus-plane-group: 3 for the composed
    reference path, 1 when the backend fuses the D/E/F triple into one
    kernel (`kernels/karatsuba_fused.py`).  `modulus_batched` collapses the
    per-modulus launch factor to 1 (the batched kernels run all N planes in
    one grid), leaving only the op/byte terms to scale with N.  `megakernel`
    (the `execution='fused'` single-launch path) collapses the launch term of
    *every* strategy to exactly one `GEMM_LAUNCH_S` — cast, products and
    reconstruction share one kernel — so the selection degenerates to the
    op/byte terms (the block embeddings still pay their HBM embed traffic
    and 8N-vs-6N op volume).  `comm_s` is
    the sharded execution's collective cost (`sharded_comm_time_s`, charged
    on the per-shard shape the caller passes) — the same for every strategy
    today, but kept in the totals so sharded 'auto' selections model what
    actually runs.  `engine` prices every MAC term at that engine's rate and
    volume factor ('fp8': 4 digit-GEMM volumes at the e4m3 rate,
    `ENGINE_OP_FACTOR`/`engine_rate`), so an fp8 policy's launch-vs-compute
    crossover shifts with e4m3 throughput.
    """
    neff = n_moduli if mode == "fast" else n_moduli + 1
    launch_planes = 1 if modulus_batched else neff
    base = complex_time_s(m, n, k, n_moduli, hw, mode, prec, engine=engine) + comm_s
    if formulation == "karatsuba":
        if megakernel:
            return base + hw.gemm_launch_s
        return base + karatsuba_launches * launch_planes * hw.gemm_launch_s
    # 8N mnk vs the model's 6N, charged at the engine's effective rate
    extra_ops = (
        2 * neff * m * n * k
        * ENGINE_OP_FACTOR[engine] / engine_rate(hw, engine)
    )
    if formulation == "block_a":
        embed_bytes = 2 * neff * (4 * m * k + 2 * k * n)  # write+read Ahat/Bhat
    elif formulation == "block_b":
        embed_bytes = 2 * neff * (2 * m * k + 4 * k * n)
    else:
        raise ValueError(f"unknown formulation {formulation!r}")
    launches = 1 if megakernel else launch_planes
    return (
        base + extra_ops + embed_bytes / hw.mem_bw
        + launches * hw.gemm_launch_s
    )


def select_formulation(
    m: int,
    n: int,
    k: int,
    n_moduli: int,
    hw: HW | None = None,
    mode: str = "fast",
    prec: str = "z",
    karatsuba_launches: int = 3,
    modulus_batched: bool = False,
    megakernel: bool = False,
    comm_s: float = 0.0,
    engine: str = "int8",
) -> str:
    """Pick the fastest Fig. 1 complex-product strategy under the SIII-C
    model (used by `core/plan.py` for ``formulation='auto'``).  Sharded
    callers pass per-shard (m, n) and their `sharded_comm_time_s` so the
    launch-vs-compute crossover reflects the local problem each shard runs;
    fp8 policies pass ``engine="fp8"`` so the crossover reflects the e4m3
    engine's op volume and rate; megakernel (`execution='fused'`) policies
    charge one launch per strategy, so only op/byte terms differentiate.
    ``hw=None`` prices against `default_hw()` — the active calibration's
    measured hardware, else the GH200 preset.
    """
    hw = hw or default_hw()
    return min(
        ("karatsuba", "block_a", "block_b"),
        key=lambda f: formulation_time_s(
            f, m, n, k, n_moduli, hw, mode, prec,
            karatsuba_launches, modulus_batched, megakernel, comm_s, engine,
        ),
    )


def engine_time_s(
    engine: str,
    m: int,
    n: int,
    k: int,
    n_moduli: int,
    hw: HW | None = None,
    mode: str = "fast",
    prec: str = "z",
    complex_: bool | None = None,
) -> float:
    """Total SIII-C time of one emulated GEMM on `engine` ('int8' | 'fp8').

    `prec` follows the model conventions: 'c'/'z' for complex (the default),
    's'/'d' for real.  Used by `select_engine` and the throughput benchmark
    to compare the two engines per shape on one hardware preset.
    """
    hw = hw or default_hw()
    if complex_ is None:
        complex_ = prec in ("c", "z")
    if complex_:
        return complex_time_s(m, n, k, n_moduli, hw, mode, prec, engine=engine)
    return real_time_s(
        m, n, k, n_moduli, hw, mode, "d" if prec in ("z", "d") else "s",
        engine=engine,
    )


def select_engine(
    m: int,
    n: int,
    k: int,
    n_moduli: int,
    hw: HW | None = None,
    mode: str = "fast",
    prec: str = "z",
) -> str:
    """The faster residue-product engine for this shape under the SIII-C
    model: 'fp8' wins exactly when its rate advantage beats its 4x digit-MAC
    volume (e.g. hardware whose e4m3 rate is >4x its int8 rate, or
    memory-bound shapes where the op term hardly matters)."""
    hw = hw or default_hw()
    return min(
        ENGINES, key=lambda e: engine_time_s(e, m, n, k, n_moduli, hw, mode, prec)
    )


def select_mode(
    m: int,
    n: int,
    k: int,
    candidates,
    hw: HW | None = None,
    prec: str = "z",
    engine: str = "int8",
) -> tuple[str, int]:
    """Cheapest (mode, n_moduli) pair among ``candidates`` (SIII-C model).

    The accuracy-adaptive resolver (`GemmPolicy(rtol=...)` / ``mode="auto"``)
    computes the *admissible* pairs from `core.accuracy.min_moduli_for` and
    hands them here, so "auto" means: the cheapest plan on this machine —
    `default_hw()` returns the live `repro_torch.tune` calibration when one is
    active — that provably meets the tolerance.  Ties keep the earlier
    candidate (callers list 'fast' first)."""
    hw = hw or default_hw()
    cands = list(candidates)
    if not cands:
        raise ValueError("select_mode needs at least one (mode, n_moduli) candidate")
    best = cands[0]
    best_t = float("inf")
    for mode, n_moduli in cands:
        t = engine_time_s(engine, m, n, k, n_moduli, hw, mode, prec)
        if t < best_t:
            best, best_t = (mode, n_moduli), t
    return best


def kernel_launch_count(
    n_moduli: int,
    formulation: str = "real",
    *,
    modulus_batched: bool = True,
    fused_karatsuba: bool = True,
    n_chunks: int = 1,
    n_blocks: int = 1,
    prepared: bool = False,
    fused: bool = False,
) -> int:
    """Kernel-launch count of one emulated GEMM on the kernel path.

    The batched backend (`modulus_batched=True`) issues exactly one
    launch per cast (complex operands stack real+imag into one), one
    per modular product per K-chunk, and one per reconstruction (CR/CI
    stacked) — 2 + n_chunks + 1 per output-column block at any N.  The
    per-modulus backend pays a factor N on products, 2x on complex casts /
    reconstructions, and 3x on unfused Karatsuba.  `prepared=True` drops the
    weight-side cast entirely (its residue planes were cast once up front by
    `prepare_weights` / `PreparedOperand` — the serving fast path), leaving
    cast + product + reconstruct = 3 launches per GEMM.

    `fused=True` is the `execution='fused'` megakernel: the residue casts
    run as the kernel prologue, Garner reconstruction as its epilogue, and
    the K-chunk carry loop becomes an in-kernel grid dimension — so the
    whole GEMM is exactly one launch per output-column block,
    regardless of n_moduli, mode, formulation or K-chunking:

        path                    batched kernel      fused megakernel
        fast real/complex       4  (2+1+1)          1
        prepared fast (right)   3  (1+1+1)          1
        K-chunked (c chunks)    3 + c               1

    `chip_smoke.py` holds the port's launch counters to it on the card.
    """
    if fused:
        return n_blocks
    planes = 1 if modulus_batched else n_moduli
    complex_ = formulation != "real"
    per_part = 1 if modulus_batched else 2  # real+imag stacked vs separate
    cast_a = per_part if complex_ else 1
    cast_b = 0 if prepared else (per_part if complex_ else 1)
    if formulation == "karatsuba":
        products = (1 if fused_karatsuba else 3) * planes * n_chunks
    else:  # 'real' or a block embedding: one real product per chunk
        products = planes * n_chunks
    reconstructs = per_part if complex_ else 1
    return cast_a + n_blocks * (cast_b + products + reconstructs)


# --------------------------------------------- kernel block selection (pads)

# Knob for the just-over-a-multiple block shrink: when a GEMM dimension is
# barely above a block multiple (m=257 with bm=256), padding to the next
# block multiple wastes ~2x compute/memory; shrinking the block to the next
# smaller aligned size pads far less (257 -> 384 at bm=128 instead of 512).
# The reference's Pallas kernels pad by this rule (`repro.kernels.common.
# block_and_padded`); the port's CUDA kernels mask their ragged edges and
# pad nothing, so here the rule is the model's term only, kept equal to the
# reference's.  Setting BLOCK_SHRINK = False restores the legacy
# round-up-to-the-default-block behaviour.
BLOCK_SHRINK = True


def _round_up(x: int, mult: int) -> int:
    return -(-x // mult) * mult


def select_block(dim: int, block: int, align: int | None = None) -> int:
    """Block size one kernel axis actually uses for `dim` (default `block`).

    dim <= block: the block shrinks to the axis (single block, no padding —
    the pre-existing rule; this includes dims below the hardware alignment,
    where the padded extent is the dim itself).  dim > block: with
    BLOCK_SHRINK on and a hardware alignment given, scan the *align-multiple*
    block sizes <= block and keep the one whose padded dim
    (`_round_up(dim, b)`) is smallest, preferring the largest such block
    (fewer grid steps).  `block` itself is always a candidate — even when it
    is not an align multiple (autotuned or caller-chosen blocks feed this
    same path) — so the padded dim never exceeds the static round-up
    `_round_up(dim, block)`.

    Invariants: the selected block always divides `padded_dim(dim, block,
    align)`, and that padded dim never exceeds the legacy round-up to
    `block`.
    """
    if dim <= 0:
        raise ValueError(f"dim must be positive, got {dim}")
    if block <= 0:
        raise ValueError(f"block must be positive, got {block}")
    if dim <= block:
        return dim
    if not BLOCK_SHRINK or align is None or block <= align:
        return block
    best, best_pad = block, _round_up(dim, block)
    # largest align multiple <= block (strictly below it when block is
    # itself an align multiple — that case is already `best`)
    start = block // align * align
    if start == block:
        start -= align
    for b in range(start, align - 1, -align):
        pad = _round_up(dim, b)
        if pad < best_pad:
            best, best_pad = b, pad
    return best


def padded_dim(dim: int, block: int, align: int | None = None) -> int:
    """The padded extent a kernel axis runs at under `select_block`."""
    return _round_up(dim, select_block(dim, block, align))


def ozaki1_complex_time_s(m, n, k, slices: int, hw: HW) -> float:
    """Ozaki-I cost shape (SIV-B): S(S+1)/2 int8 complex products, each a
    Karatsuba triple => 3*S(S+1)/2 real int8 GEMMs (memory terms omitted —
    used only for the >=algorithmic-factor comparison)."""
    s = slices
    return (3 * s * (s + 1) / 2) * 2 * m * n * k / hw.int8_ops
