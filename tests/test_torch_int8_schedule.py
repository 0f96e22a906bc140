"""The schedules of the three int8 Hopper kernels, modelled on the CPU from
their sources.

* `csrc/fused_mod_gemm.cu`, the real megakernel: its shared memory (the
  stash of N canonical planes, N BM BN bytes, beside the staging buffers of
  its cluster-shared cast) must fit the 232,448 bytes a block may use, for
  every compiled tile and every N, with the staging buffers the source's
  rule gives.
* `csrc/karatsuba_fused.cu`, the int8 Karatsuba kernel on wgmma: its int32
  accumulators must stay exact over all of K up to the wrapper's 2^17; its
  preparing warpgroup forms (AR+AI) mod p 16 bytes at a time on the chunks
  of the swizzled tiles TMA writes, and (BR+BI) mod p on B's transpose, by
  a division-free integer route; and the transpose must write every B
  element once, where the wgmma descriptor reads it.
* `csrc/int8_mod_gemm.cu`, the int8 real kernel on wgmma: its tiles are
  the compiled ones, its ring fits the shared memory, the warps that take
  slices in turn are no more than its stages on either load path, its
  cluster's shares of B cover the tile, its transpose writes every B
  element once where the descriptor reads it, and its int32 accumulators
  stay exact to k = 2^17.

Constants, tiles and the op sequence are read from the sources; the models
run in numpy, exactly (int64 / uint64), and are held bitwise against the
plain versions.  CPU only; tolerance: none.
"""
import pathlib
import re

import numpy as np
import pytest
import torch

from repro_torch.core.moduli import make_crt_context
from repro_torch.kernels.common import COMPILED_TILES, sym_mod_f32
from repro_torch.kernels.karatsuba_fused import karatsuba_mod_gemm_plain

CSRC = pathlib.Path(__file__).resolve().parents[1] / "src/repro_torch/kernels/csrc"
FUSED = CSRC / "fused_mod_gemm.cu"
KARATSUBA = CSRC / "karatsuba_fused.cu"
SMEM_BLOCK = 232448          # the shared memory an H100 block may use
NMAX = (8, 16, 24)           # the megakernel's instantiations by N
K_MAX = 1 << 17              # the int8 Karatsuba wrapper's k limit
INT32_MAX = (1 << 31) - 1


def constant(path: pathlib.Path, pattern: str) -> tuple[int, ...]:
    m = re.search(pattern, path.read_text())
    assert m, f"{pattern!r} not found in {path.name}"
    return tuple(int(g) for g in m.groups())


def tiles(path: pathlib.Path) -> list[tuple[int, int, int, int]]:
    """The (BM, BN, BK, fourth) of each REPRO_TILE line, default first."""
    found = re.findall(r"^\s*REPRO_TILE\((\d+), (\d+), (\d+), (\d+)\)", path.read_text(), re.M)
    return [tuple(int(x) for x in t) for t in found]


# ------------------------------------------------ fused_mod_gemm: shared memory


def fused_layout():
    cm, cn = constant(FUSED, r"constexpr int CM = (\d+), CN = (\d+);")
    (smem_max,) = constant(FUSED, r"constexpr int SMEM_MAX = (\d+);")
    return cm, cn, smem_max


def fused_stages(bm, bn, bk, nmax, smem_max):
    """The source's rule: two staging buffers where they fit beside the
    largest stash of the instantiation."""
    stage = (bm + bn) * (bk + 16)  # A and B tiles of [rows][BK + 16] bytes (gemm_tiles.cuh lds_for)
    return 2 if nmax * bm * bn + 2 * stage <= smem_max else 1


def test_fused_stage_rule_is_the_sources():
    src = FUSED.read_text()
    assert "NMAX * T::BM * T::BN + 2 * Stage<T>::BYTES <= SMEM_MAX ? 2 : 1" in src
    assert "A_BYTES = BM * LDS, B_BYTES = BN * LDS" in src
    assert "n_mod * T::BM * T::BN + 16 * stages<T, NMAX>()" in src
    assert "lds_for(int bk) { return bk + 16; }" in (CSRC / "gemm_tiles.cuh").read_text()
    assert constant(FUSED, r"constexpr int SMEM_MAX = (\d+);") == (SMEM_BLOCK,)


@pytest.mark.parametrize("n_mod", range(1, 25))
def test_fused_shared_memory_fits_every_tile(n_mod):
    """Stash + staging (+ the cluster barriers) <= 232,448 B at every
    compiled tile, with two staging buffers for every N up to 24."""
    cm, cn, smem_max = fused_layout()
    nmax = next(x for x in NMAX if n_mod <= x)
    for bm, bn, bk, _ in tiles(FUSED):
        stages = fused_stages(bm, bn, bk, nmax, smem_max)
        assert stages == 2, (bm, bn, bk, n_mod)
        total = stages * (bm + bn) * (bk + 16) + n_mod * bm * bn + 16 * stages  # + 2 mbarriers a buffer
        assert total <= SMEM_BLOCK, (bm, bn, bk, n_mod, total)


def test_fused_cluster_shares_cover_the_tiles():
    """Every block of a CM x CN cluster casts a whole number of 4-value
    words of A rows and B columns a thread, and the shares tile the block's
    A and B tiles exactly (the source's static_asserts, for every tile)."""
    cm, cn, _ = fused_layout()
    threads = 256
    for bm, bn, bk, _ in tiles(FUSED):
        assert bm % cn == 0 and bn % cm == 0
        for rows, vals in ((bm // cn, bm // cn * bk), (bn // cm, bn // cm * bk)):
            seg = min(16, vals // threads)
            assert seg % 4 == 0 and seg >= 4
            assert vals % (threads * seg) == 0
            assert rows * bk == vals


def test_fused_tiles_are_the_compiled_ones():
    assert [t[:3] for t in tiles(FUSED)] == list(COMPILED_TILES["fused", "real"])
    assert tiles(FUSED)[0][:3] == (64, 64, 64)


# ------------------------------------ karatsuba_fused: the division-free sum mod p


def sum_mod_model(x: np.ndarray, y: np.ndarray, p: int) -> np.ndarray:
    """`sum_mod_word` per byte, as the kernel computes it in uint32/uint64:
    t = (x ^ 0x80) + (y ^ 0x80) + (K p - 256); q = (t M + h M) >> 32;
    r = t - q p, whose low byte is the int8 residue."""
    p = np.uint64(p)
    bias = np.uint64((256 + int(p) - 1) // int(p) * int(p) - 256)
    m = np.uint64(0xFFFFFFFF // int(p) + 1)
    hm = np.uint64((int(p) - 1) >> 1) * m
    ux = (x.astype(np.uint8) ^ np.uint8(0x80)).astype(np.uint64)
    uy = (y.astype(np.uint8) ^ np.uint8(0x80)).astype(np.uint64)
    t = ux + uy + bias
    q = (t * m + hm) >> np.uint64(32)
    r = (t - q * p) & np.uint64(0xFFFFFFFF)
    return (r & np.uint64(0xFF)).astype(np.uint8).view(np.int8)


def test_sum_mod_op_sequence_is_the_sources():
    src = KARATSUBA.read_text()
    for line in ("sm.bias = static_cast<uint32_t>((256 + p - 1) / p * p - 256);",
                 "sm.m = 0xFFFFFFFFu / sm.p + 1;",
                 "sm.hm = static_cast<uint64_t>((p - 1) >> 1) * sm.m;",
                 "const uint32_t ux = x ^ 0x80808080u, uy = y ^ 0x80808080u;",
                 "__byte_perm(ux, 0, 0x4440 + b) + __byte_perm(uy, 0, 0x4440 + b) + sm.bias;",
                 "(static_cast<uint64_t>(t) * sm.m + sm.hm) >> 32",
                 "r[b] = t - q * sm.p;"):
        assert line in src, line


def swizzle_offsets(rows: int, bk: int) -> np.ndarray:
    """(rows, bk) -> byte offset in a [rows][bk] tile as `swizzled<BK>` writes
    it: the 16-byte chunk index XOR row / 2 mod 4 (64-byte rows) or row mod
    8 (128-byte rows)."""
    r = np.arange(rows)[:, None]
    c = np.arange(bk)[None, :]
    x = (r & 7) if bk == 128 else ((r >> 1) & 3)
    return r * bk + (((c >> 4) ^ x) << 4) + (c & 15)


def address_swizzle(lin: np.ndarray, bk: int) -> np.ndarray:
    """The swizzle of TMA and of the wgmma descriptor as a map of byte
    addresses within a 1024-byte-aligned tile: bits [4, 4 + B) XOR bits
    [7, 7 + B), B = 3 (128-byte swizzle) or 2 (64-byte)."""
    mask = 7 if bk == 128 else 3
    return lin ^ (((lin >> 7) & mask) << 4)


@pytest.mark.parametrize("bk", [64, 128])
def test_swizzled_is_the_hardware_swizzle(bk):
    rows = 64
    lin = np.arange(rows * bk).reshape(rows, bk)
    np.testing.assert_array_equal(swizzle_offsets(rows, bk), address_swizzle(lin, bk))
    src = (CSRC / "hopper.cuh").read_text()  # `swizzled`, shared by the TMA kernels
    assert "const int x = BK == 128 ? (row & 7) : ((row >> 1) & 3);" in src
    assert "return row * BK + (((col >> 4) ^ x) << 4) + (col & 15);" in src


@pytest.mark.parametrize("bk", [64, 128])
def test_chunk_sums_on_swizzled_tiles_equal_the_plain_sums(bk):
    """Every int8 pair (x, y) laid out as logical AR and AI tiles, swizzled
    as TMA writes them; the kernel's sum of each physical 16-byte chunk,
    once unswizzled, is the plain version's sym_mod(x + y, p), for every
    odd modulus 3..255 (the C entry's range) and so every default one."""
    x, y = np.meshgrid(np.arange(-128, 128, dtype=np.int8), np.arange(-128, 128, dtype=np.int8))
    rows = x.size // bk
    off = swizzle_offsets(rows, bk).ravel()
    phys_x = np.empty(x.size, np.int8)
    phys_y = np.empty(y.size, np.int8)
    phys_x[off] = x.ravel()
    phys_y[off] = y.ravel()
    moduli = sorted(set(range(3, 256, 2)) | set(make_crt_context(21).moduli))
    v = torch.from_numpy((x.astype(np.float32) + y.astype(np.float32)).ravel())
    for p in moduli:
        chunks = sum_mod_model(phys_x.reshape(-1, 16), phys_y.reshape(-1, 16), p).ravel()
        got = chunks[off]  # unswizzle
        want = sym_mod_f32(v, float(p), float((p - 1) // 2)).numpy().astype(np.int8)
        np.testing.assert_array_equal(got, want, err_msg=f"p={p}")


# ------------------------------------ karatsuba_fused: the B transpose and wgmma


def karatsuba_layout():
    cm, cn = constant(KARATSUBA, r"constexpr int CM = (\d+), CN = (\d+);")
    (prep_wgs,) = constant(KARATSUBA, r"constexpr int PREP_WGS = (\d+);")
    # the first warps of the preparing warpgroups are the producers
    (producers,) = constant(KARATSUBA, r"constexpr int COMPUTE_THREADS = PREP_THREADS - (\d+);")
    assert "B_SHIFT = COMPUTE_THREADS - A_CHUNKS % COMPUTE_THREADS;" in KARATSUBA.read_text()
    assert "const int b = (ct + L::B_SHIFT) % COMPUTE_THREADS + COMPUTE_THREADS * i;" in KARATSUBA.read_text()
    assert "B_BLOCKS = (B_COLS / 4) * (BK / 4);" in KARATSUBA.read_text()  # 4 x 4 blocks
    return cm, cn, 128 * prep_wgs - producers


def test_karatsuba_tiles_are_the_compiled_ones():
    found = tiles(KARATSUBA)
    assert [t[:3] for t in found] == list(COMPILED_TILES["kernel", "complex"])
    assert len(found) >= 3 and (64, 64, 64) in [t[:3] for t in found]
    assert all(t[0] == 64 and t[3] >= 3 for t in found)  # one wgmma m64 a product; rings of >= 3 stages
    src = KARATSUBA.read_text()
    assert "constexpr uint32_t SBO = 8 * BK;" in src
    assert "LAYOUT = BK == 128 ? 1 : 2;" in src


@pytest.mark.parametrize("tile", tiles(KARATSUBA), ids=lambda t: "x".join(map(str, t[:3])))
def test_b_transpose_is_a_bijection_onto_the_descriptor_layout(tile):
    """The preparing threads' map from raw B (k, n) of every block's share
    to a byte of the K-major [BN][BK] tile: each element lands once, at the
    address the wgmma descriptor (K-major, 8-row groups SBO = 8 BK apart,
    the hardware swizzle) reads element (n, k) from."""
    bm, bn, bk, _ = tile
    cm, _, threads = karatsuba_layout()
    b_cols = bn // cm
    blocks = (b_cols // 4) * (bk // 4)
    shift = threads - (bm * bk // 16) % threads
    seen = np.full(bn * bk, -1, np.int64)
    for cy in range(cm):
        for ct in range(threads):
            for i in range(-(-blocks // threads)):
                b = (ct + shift) % threads + threads * i
                if b >= blocks:
                    continue
                nb, kb = b % (b_cols // 4), b // (b_cols // 4)
                for j4 in range(4):       # column 4 nb + j4 of the share, after the transpose
                    n = cy * b_cols + 4 * nb + j4
                    base = int(swizzle_offsets(bn, bk)[n, 4 * kb])
                    for r in range(4):    # byte r of the word: k = 4 kb + r
                        k = 4 * kb + r
                        assert (base + r) // 16 == base // 16, "a column's bytes leave their 16-byte chunk"
                        assert seen[base + r] == -1, "two elements on one byte"
                        seen[base + r] = n * bk + k
    assert (seen >= 0).all(), "a byte of the tile is never written"
    # the descriptor's layout: element (n, k) at the swizzle of n BK + k
    # (8-row groups of 8 BK bytes, rows BK bytes apart within a group)
    lin = np.arange(bn * bk)
    want = np.empty_like(seen)
    want[address_swizzle(lin, bk)] = lin
    np.testing.assert_array_equal(seen, want)


# ------------------------------------ karatsuba_fused: the int32 accumulators


def sym_mod(v, p):
    r = np.mod(v, p)
    return np.where(r > (p - 1) // 2, r - p, r)


def accumulate(a: np.ndarray, b: np.ndarray, bk: int):
    """One product as a product warpgroup sums it: k32 steps (BK / 32 a
    slice of bk), from zero, never reduced.  Returns the final sums and the
    largest |partial sum| at any k32 step, which bounds every partial sum
    of the tensor cores' int32 adds when all products share a sign."""
    m, k = a.shape
    steps = -(-k // 32)
    pad = steps * 32 - k
    a3 = np.pad(a.astype(np.int64), ((0, 0), (0, pad))).reshape(m, steps, 32)
    b3 = np.pad(b.astype(np.int64), ((0, pad), (0, 0))).reshape(steps, 32, -1)
    per_step = np.einsum("msk,skn->smn", a3, b3)
    partial = np.cumsum(per_step, axis=0)
    return partial[-1], int(np.abs(partial).max())


@pytest.mark.parametrize("case", ["-127", "largest sums"])
def test_accumulators_stay_below_2_31_at_k_2_17(case):
    """At k = 2^17, every tile: planes of -127 (D and E at 127^2 k) and
    operands whose sums mod p are the largest, +-127 at p = 255 (F); every
    partial sum stays below 2^31, and the modelled epilogue is the plain
    version's, bitwise (numpy int64 against karatsuba_mod_gemm_plain)."""
    mods = make_crt_context(8).moduli
    k = K_MAX
    if case == "-127":
        ar = np.full((2, k), -127, np.int8)
        ai = ar.copy()
        br = np.full((k, 3), -127, np.int8)
        bi = br.copy()
    else:
        ar = np.full((2, k), 127, np.int8)
        ai = np.zeros((2, k), np.int8)
        br = np.full((k, 3), -127, np.int8)
        bi = np.zeros((k, 3), np.int8)
    for _, _, bk, _ in tiles(KARATSUBA):
        out_r, out_i = [], []
        for p in mods:
            asum = sym_mod(ar.astype(np.int64) + ai, p)
            bsum = sym_mod(br.astype(np.int64) + bi, p)
            res = []
            for x, y in ((ar, br), (ai, bi), (asum, bsum)):
                acc, largest = accumulate(x, y, bk)
                assert largest <= INT32_MAX, (bk, p, largest)
                res.append(sym_mod(acc, p))
            d, e, f = res
            out_r.append(sym_mod(d - e, p))
            out_i.append(sym_mod(f - d - e, p))
        t = lambda z: torch.from_numpy(np.ascontiguousarray(np.broadcast_to(z, (8, *z.shape))))  # noqa: E731
        want = karatsuba_mod_gemm_plain(t(ar), t(ai), t(br), t(bi), moduli=mods)
        np.testing.assert_array_equal(np.stack(out_r), want[0].numpy())
        np.testing.assert_array_equal(np.stack(out_i), want[1].numpy())
    if case == "-127":
        assert 127 * 127 * k <= INT32_MAX < 128 * 128 * k  # the bound is tight: k = 2^17 is the limit


# ------------------------------------ int8_mod_gemm: the real product on wgmma

INT8 = CSRC / "int8_mod_gemm.cu"


def int8_layout():
    """(CM, CN) of int8_mod_gemm.cu."""
    return constant(INT8, r"constexpr int CM = (\d+), CN = (\d+);")


def test_int8_tiles_are_the_compiled_ones():
    found = tiles(INT8)
    assert [t[:3] for t in found] == list(COMPILED_TILES["kernel", "real"])
    assert found[0][:3] == (128, 128, 64) and len(found) >= 3
    assert all(t[0] in (64, 128) and t[3] >= 3 for t in found)  # one or two wgmma m64 row blocks; rings of >= 3
    src = INT8.read_text()
    assert "constexpr uint32_t SBO = 8 * BK;" in src
    assert "LAYOUT = BK == 128 ? 1 : 2;" in src
    assert "wgmma_s8<BN>(acc, a0 + st + 2 * q, b0 + st + 2 * q);" in src


def test_int8_shared_memory_fits_every_tile():
    """The ring of ST stages (A and B tiles, the raw B share) and its 4 ST
    mbarriers, with 1024 bytes of alignment, fit the 232,448 bytes a
    block may use, at every compiled tile (the source's rule)."""
    src = INT8.read_text()
    for line in ("STAGE = A_TILE + B_TILE;", "RAW_B = BK * B_COLS;", "RAW_OFF = ST * STAGE;",
                 "BAR_OFF = RAW_OFF + ST * RAW_B;", "BYTES = 1024 + BAR_OFF + 8 * 4 * ST;"):
        assert line in src, line
    assert constant(INT8, r"constexpr int SMEM_MAX = (\d+);") == (SMEM_BLOCK,)
    cm, _ = int8_layout()
    for bm, bn, bk, st in tiles(INT8):
        total = 1024 + st * (bm * bk + bn * bk) + st * bk * (bn // cm) + 32 * st
        assert total <= SMEM_BLOCK, (bm, bn, bk, st, total)


def test_int8_cluster_shares_cover_the_tiles():
    """The CM blocks of a cluster column transpose BN / CM columns each,
    a whole number of 16-byte TMA box rows, and together the block's BN."""
    cm, cn = int8_layout()
    assert cn == 1
    for _, bn, bk, _ in tiles(INT8):
        cols = bn // cm
        assert cols * cm == bn and cols % 16 == 0 and cols % 4 == 0
        assert bk % 4 == 0


@pytest.mark.parametrize("tile", tiles(INT8), ids=lambda t: "x".join(map(str, t[:3])))
def test_int8_b_transpose_is_a_bijection_onto_the_descriptor_layout(tile):
    """The map of a slice's preparing warp from raw B (k, n) of every
    block's share to a byte of the K-major [BN][BK] tile (lane l takes the
    4 x 4 blocks l + 32 i): each element lands once, at the address the
    wgmma descriptor (K-major, 8-row groups SBO = 8 BK apart, the hardware
    swizzle) reads element (n, k) from."""
    _, bn, bk, _ = tile
    cm, _ = int8_layout()
    src = INT8.read_text()
    assert "B_ITERS = B_BLOCKS / 32;" in src and "B_BLOCKS = (B_COLS / 4) * (BK / 4);" in src
    assert "const int b = lane + 32 * i;" in src
    assert "nb = b % (L::B_COLS / 4), kb = b / (L::B_COLS / 4);" in src
    assert "st_shared(stage + L::A_TILE + swizzled<BK>(b_col0 + 4 * nb + j4, 4 * kb), wb[j4]);" in src
    b_cols = bn // cm
    blocks = (b_cols // 4) * (bk // 4)
    assert blocks % 32 == 0
    offsets = swizzle_offsets(bn, bk)
    seen = np.full(bn * bk, -1, np.int64)
    for cy in range(cm):
        for lane in range(32):
            for i in range(blocks // 32):
                b = lane + 32 * i
                nb, kb = b % (b_cols // 4), b // (b_cols // 4)
                for j4 in range(4):
                    n = cy * b_cols + 4 * nb + j4
                    base = int(offsets[n, 4 * kb])
                    for r in range(4):
                        assert (base + r) // 16 == base // 16, "a column's bytes leave their 16-byte chunk"
                        assert seen[base + r] == -1, "two elements on one byte"
                        seen[base + r] = n * bk + 4 * kb + r
    assert (seen >= 0).all(), "a byte of the tile is never written"
    lin = np.arange(bn * bk)
    want = np.empty_like(seen)
    want[address_swizzle(lin, bk)] = lin
    np.testing.assert_array_equal(seen, want)


def int8_prep_warps(tma: bool, stages: int) -> int:
    """The preparing warps that take slices in turn on a load path at a
    ring of `stages`, by the source's rule: on the TMA path the two after
    the load and push warps; on the global-load path the six of its two
    preparing warpgroups after those, and the load warp (idle there) too
    where the ring has seven stages or more."""
    src = INT8.read_text()
    assert "static constexpr int PREP_WGS = TMA ? 1 : 2;" in src
    assert "static constexpr int PREP_WARPS = TMA ? 2 : (ST >= 7 ? 7 : 6);" in src
    assert "if (threadIdx.x < 64 && (TMA || threadIdx.x >= 32 || L::PREP_WARPS < 7)) {" in src
    assert "pw = threadIdx.x >= 64 ? (threadIdx.x - 64) >> 5 : L::PREP_WARPS - 1;" in src
    assert "for (int j = pw; j < S; j += L::PREP_WARPS) {" in src
    if tma:
        return 2
    warps = 7 if stages >= 7 else 6
    # the warps that prepare: every warp of the two warpgroups but the push
    # warp, and the load warp only with seven
    assert warps <= 2 * 4 - 1
    return warps


def parity_wait_is_sound(warps: int, stages: int, slices: int = 64) -> bool:
    """Whether every preparing warp's stage wait is sound when `warps`
    warps take slices in turn through a ring of `stages`.  The warp of
    slice j waits on the parity of the phase in which slice j - stages was
    read; all it knows is that slice j - warps - stages was read (its own
    last wait; readers release in order).  A parity wait passes at once
    when the barrier is two phases behind, so slice j - 2 stages must be
    known read."""
    for j in range(slices):
        known = j - warps - stages  # read before this warp's last wait returned
        if j - 2 * stages >= 0 and known < j - 2 * stages:
            return False
    return True


@pytest.mark.parametrize("tma", [True, False], ids=["tma", "global"])
@pytest.mark.parametrize("tile", tiles(INT8), ids=lambda t: "x".join(map(str, t[:3])))
def test_int8_turn_taking_warps_fit_the_ring(tile, tma):
    """The warps that take slices in turn are no more than the ring's
    stages, on both load paths at every compiled tile (the source's
    static_assert), and so every stage wait is sound; a control: more warps
    than stages is not."""
    assert 'static_assert(PREP_WARPS <= ST, "' in INT8.read_text()
    warps, stages = int8_prep_warps(tma, tile[3]), tile[3]
    assert warps <= stages, (tile, warps)
    assert parity_wait_is_sound(warps, stages)
    assert not parity_wait_is_sound(stages + 1, stages)


@pytest.mark.parametrize("tile", tiles(INT8), ids=lambda t: "x".join(map(str, t[:3])))
def test_int8_a_chunks_cover_the_tile_on_the_global_path(tile):
    """On the global-load path a slice's preparing warp stores A's 16-byte
    chunks lane + 32 i at their swizzled places: every byte of the
    [BM][BK] tile once, where TMA would have put it."""
    bm, _, bk, _ = tile
    src = INT8.read_text()
    assert "A_ITERS = A_CHUNKS / 32" in src and "const int c = lane + 32 * i;" in src
    assert "ra = c / (BK / 16), ca = (c % (BK / 16)) * 16;" in src
    assert "st_shared4(stage + swizzled<BK>(ra, ca), make_uint4(w[i][0], w[i][1], w[i][2], w[i][3]));" in src
    assert "load_chunk(w[i], op.a + a_plane + static_cast<size_t>(gm) * k + kk, gm < m ? k - kk : 0, op.a_width);" in src
    offsets = swizzle_offsets(bm, bk)
    seen = np.zeros(bm * bk, np.int64)
    for c in range(bm * bk // 16):
        ra, ca = c // (bk // 16), (c % (bk // 16)) * 16
        np.testing.assert_array_equal(offsets[ra, ca:ca + 16], offsets[ra, ca] + np.arange(16))
        seen[offsets[ra, ca]:offsets[ra, ca] + 16] += 1
    assert (seen == 1).all()


@pytest.mark.parametrize("case", ["-127", "largest residues"])
def test_int8_accumulators_stay_below_2_31_at_k_2_17(case):
    """At k = 2^17, every tile: planes of -127 (every product 127^2) and
    every residue at its largest magnitude ((p - 1) / 2 against -(p - 1) /
    2); every partial sum of a product warpgroup's k32 steps stays below
    2^31, and the modelled epilogue (+ carry, the symmetric mod) is
    int8_mod_gemm_plain's, bitwise."""
    from repro_torch.kernels.int8_mod_gemm import int8_mod_gemm_plain

    mods = make_crt_context(8).moduli
    k = K_MAX
    if case == "-127":
        a = np.full((8, 2, k), -127, np.int8)
        b = np.full((8, k, 3), -127, np.int8)
    else:
        half = np.asarray([(p - 1) // 2 for p in mods], np.int8)[:, None, None]
        a = np.broadcast_to(half, (8, 2, k)).copy()
        b = np.broadcast_to(-half, (8, k, 3)).copy()
    carry = np.asarray([[[(p - 1) // 2] * 3] * 2 for p in mods], np.int8)
    for _, _, bk, _ in tiles(INT8):
        out = []
        for l, p in enumerate(mods):
            acc, largest = accumulate(a[l], b[l], bk)
            assert largest <= INT32_MAX, (bk, p, largest)
            out.append(sym_mod(acc + carry[l], p))
        want = int8_mod_gemm_plain(*(torch.from_numpy(x) for x in (a, b)), moduli=mods,
                                   carry=torch.from_numpy(carry))
        np.testing.assert_array_equal(np.stack(out), want.numpy())
