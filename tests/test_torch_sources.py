"""Source checks of the port's Hopper kernels (`src/repro_torch/kernels/csrc`)
that the CPU can make: the helpers the TMA kernels share live in
`hopper.cuh` alone, the residue cast takes the division-free route, and no
named barrier of the e4m3 kernels follows a branch that only some lanes of
a warp take.  The kernels themselves run only on the card, where
`chip_smoke.py` holds them bitwise against their plain versions.
"""
import re

import pytest

from repro_torch.kernels import build

CSRC = build.CSRC
SHARED = {
    "swizzled": r"__device__\s+__forceinline__\s+int\s+swizzled\s*\(",
    "uses_tma": r"\bbool\s+uses_tma\s*\(",
    # the 3-D int8 map (flash_attention.cu's 4-D bf16 map is another function)
    "tensor_map": r"\bbool\s+tensor_map\s*\(\s*CUtensorMap\s*\*\s*\w+\s*,\s*const\s+void\s*\*\s*\w+\s*,\s*int\b",
    "ld_shared": r"\bld_shared4?\s*\(\s*uint32_t\s+\w+\s*\)\s*\{",
    "st_shared": r"\bvoid\s+st_shared4?\s*\(\s*uint32_t\s+\w+\s*,",
    "aligned": r"\bbool\s+aligned\s*\(",
    "load_word": r"\buint32_t\s+load_word\s*\(",
    "wgmma_s8": r"\bvoid\s+wgmma_s8(_n\d+)?\s*\(",
    "fence_acc": r"\bvoid\s+fence_acc\s*\(",
}
TMA_KERNELS = ("fp8_karatsuba", "karatsuba_fused", "fp8_mod_gemm", "int8_mod_gemm")


def code(path) -> str:
    """A source without its comments."""
    text = path.read_text()
    text = re.sub(r"/\*.*?\*/", "", text, flags=re.S)
    return re.sub(r"//[^\n]*", "", text)


@pytest.mark.parametrize("helper", sorted(SHARED))
def test_tma_helpers_are_defined_once_in_hopper_cuh(helper):
    """Each shared helper is defined in hopper.cuh, and no kernel source
    defines a copy of its own; the four TMA kernels include hopper.cuh."""
    pattern = SHARED[helper]
    assert re.search(pattern, code(CSRC / "hopper.cuh")), helper
    for path in sorted(CSRC.glob("*.cu")):
        assert not re.search(pattern, code(path)), f"{path.name} defines its own {helper}"
    for name in TMA_KERNELS:
        assert '#include "hopper.cuh"' in (CSRC / f"{name}.cu").read_text(), name


def test_one_c_entry_for_the_tma_rule():
    """The TMA rule has one C entry, `repro_uses_tma`, written once in
    hopper.cuh's `REPRO_USES_TMA_ENTRY`, which the four TMA kernels expand
    and no other source does (`build.uses_tma` reads it from the library
    of each)."""
    entries = {path.name: re.findall(r'extern "C" int (\w*uses_tma\w*)', path.read_text())
               for path in sorted(CSRC.glob("*.cu*"))}
    assert {name: found for name, found in entries.items() if found} == {"hopper.cuh": ["repro_uses_tma"]}
    assert re.search(r'#define REPRO_USES_TMA_ENTRY\s*\\\s*extern "C" int repro_uses_tma\(',
                     code(CSRC / "hopper.cuh"))
    expanding = {path.stem for path in sorted(CSRC.glob("*.cu"))
                 if re.search(r"^REPRO_USES_TMA_ENTRY$", code(path), flags=re.M)}
    assert expanding == set(TMA_KERNELS)


def body(src: str, signature: str) -> str:
    """The brace-delimited body of the function whose definition starts
    with `signature`."""
    start = src.index("{", src.index(signature))
    depth = 0
    for i in range(start, len(src)):
        depth += {"{": 1, "}": -1}.get(src[i], 0)
        if depth == 0:
            return src[start:i + 1]
    raise AssertionError(f"unbalanced braces after {signature}")


def test_residue_cast_takes_the_division_free_route():
    """residue_cast.cu casts through residue_fma.cuh (a residue a limb by
    fma, one final reduce, the megakernels' route), its kernel divides
    nothing (no `/` or `%`), and its C entry refuses moduli the route does
    not cover."""
    src = code(CSRC / "residue_cast.cu")
    assert '#include "residue_fma.cuh"' in src
    kernel = body(src, "residue_cast_kernel(")
    assert "residue_fma(" in kernel and "plane_cast(" in kernel and "pack4_residues(" in kernel
    assert "/" not in kernel and "%" not in kernel
    assert "sym_mod_i32" not in kernel and "__float2int" not in kernel
    assert "fma_moduli_ok(" in body(src, 'extern "C" int residue_cast_launch(')


def test_e4m3_named_barriers_follow_converged_warps():
    """The repaired race of fp8_karatsuba.cu: every split thread waits on
    the stage's "empty" barrier itself (not inside thread 0's branch), and
    the split warpgroup's named barrier follows a __syncwarp().
    fp8_mod_gemm.cu has no named barrier at all."""
    src = code(CSRC / "fp8_karatsuba.cu")
    lines = [line.strip() for line in src.splitlines() if line.strip()]
    waits = [i for i, line in enumerate(lines) if line.startswith("mbar_wait_cluster(dig_empty(s)")]
    assert len(waits) == 1
    opened = 0  # braces opened since the split loop's `for (int j` line
    start = max(i for i in range(waits[0]) if lines[i].startswith("for (int j = 0; j < S; ++j)"))
    for line in lines[start:waits[0]]:
        opened += line.count("{") - line.count("}")
    assert opened == 1, "the wait sits in a branch of the split loop, not in its body"
    calls = [i for i, line in enumerate(lines) if line == "split_barrier();"]
    assert calls and all(lines[i - 1] == "__syncwarp();" for i in calls)
    assert "bar.sync" not in code(CSRC / "fp8_mod_gemm.cu")
