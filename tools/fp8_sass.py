#!/usr/bin/env python3
"""Count the tensor-core, conversion and fold instructions of one of the
port's kernels as `nvcc` compiled it for sm_90a, per compiled variant:
the e4m3 Karatsuba kernel (`csrc/fp8_karatsuba.cu`, the default), the e4m3
real kernel (`csrc/fp8_mod_gemm.cu`), the int8 Karatsuba kernel
(`csrc/karatsuba_fused.cu`), the int8 real kernel (`csrc/int8_mod_gemm.cu`),
the real megakernel (`csrc/fused_mod_gemm.cu`), or the residue cast
(`csrc/residue_cast.cu`) or the Garner reconstruction
(`csrc/crt_garner.cu`), which have no tensor-core instruction and so no
main loop: their counts are of the whole function, element loop included.

It builds one checkout's library of that kernel (into that checkout's
`build/`), lists it with `cuobjdump -sass` and counts, for each kernel
function, the wgmma (QGMMA for e4m3, IGMMA for int8) and mma.sync (HMMA,
IMMA) instructions, F2I (float to integer conversion), I2F and I2FP
(integer to float), FRND (float rounding, rintf's instruction), FADD and
FFMA instructions, MUFU.RCP (the reciprocal with which every 32-bit
integer division or remainder by a run-time divisor starts), and the
local-memory loads and stores (LDL, STL): over the whole function, and over
its main loop, taken as the instructions from its first tensor-core
instruction to its last.  Each variant is labelled by its tile (and the
load path, N bound or operand kind where the source compiles several).
Needs the CUDA toolkit (`nvcc`, `cuobjdump`):

    python3 tools/fp8_sass.py [--kernel NAME] [--src PATH/TO/CHECKOUT/src]

It prints one JSON line: {"src", "kernel", "serialized_wgmma",
"functions": {label: {"all": {...}, "main_loop": {...}}}}, where
`serialized_wgmma` says whether ptxas warned that it serialised wgmma
instructions (its C7512 warning in the build's `-Xptxas -v` log).  With `--against OTHER/src` it also builds
that checkout's library of the same kernel and compares each variant's
instructions in order, with the immediate kernel-parameter offsets
(`c[0x0][0x...]`) and branch targets taken out (a register-indexed
parameter load, `c[0x0][R+0x...]`, keeps its offset): "against": {label:
{"instructions": [this, other], "differing": [this, other]}}, the
instructions of each side that an in-order match leaves unpaired.
"""
from __future__ import annotations

import argparse
import collections
import difflib
import json
import pathlib
import re
import subprocess
import sys

# wgmma is HGMMA (f16, bf16), QGMMA (e4m3, e5m2) or IGMMA (int8) in SASS;
# mma.sync is HMMA (e4m3 included on sm_90) or IMMA
OPCODES = ("QGMMA", "HGMMA", "IGMMA", "HMMA", "IMMA", "F2I", "I2F", "I2FP", "FRND", "FADD", "FFMA", "MUFU.RCP",
           "LDL", "STL")
TENSOR = ("QGMMA", "HGMMA", "IGMMA", "HMMA", "IMMA")
KERNELS = ("fp8_karatsuba", "fp8_mod_gemm", "karatsuba_fused", "int8_mod_gemm", "fused_mod_gemm", "residue_cast",
           "crt_garner")
# the variant's label from its mangled name: Tile<BM, BN, BK, WN> (a kernel of
# mma.sync tiles; the megakernel's also by N bound, prepared B and vector
# loads), fp8_karatsuba_kernel<BK, stages, TMA>, fp8_mod_gemm_kernel<BK,
# stages, TMA>, karatsuba_kernel<BN, BK, stages, TMA> or
# residue_cast_kernel<limbs, VEC>
LABELS = (
    (re.compile(r"TileILi(\d+)ELi(\d+)ELi(\d+)ELi\d+EELi(\d+)ELb(\d)ELb(\d)E"),
     lambda g: f"tile {g[0]}x{g[1]}x{g[2]} nmax={g[3]} prepared={g[4]} vec={g[5]}"),
    (re.compile(r"TileILi(\d+)ELi(\d+)ELi(\d+)ELi\d+EELb(\d)E"),
     lambda g: f"tile {g[0]}x{g[1]}x{g[2]} vec={g[3]}"),
    (re.compile(r"fp8_karatsuba_kernelILi(\d+)ELi\d+ELb(\d)E"),
     lambda g: f"tile 64x64x{g[0]} {'tma' if g[1] == '1' else 'global loads'}"),
    (re.compile(r"fp8_mod_gemm_kernelILi(\d+)ELi\d+ELb(\d)E"),
     lambda g: f"tile 128x64x{g[0]} {'tma' if g[1] == '1' else 'global loads'}"),
    (re.compile(r"karatsuba_kernelILi(\d+)ELi(\d+)ELi\d+ELb(\d)E"),
     lambda g: f"tile 64x{g[0]}x{g[1]} {'tma' if g[2] == '1' else 'global loads'}"),
    (re.compile(r"residue_cast_kernelILi(\d)ELb(\d)E"), lambda g: f"limbs={g[0]} vec={g[1]}"),
    (re.compile(r"int8_mod_gemm_kernelILi(\d+)ELi(\d+)ELi(\d+)ELi\d+ELb(\d)E"),
     lambda g: f"tile {g[0]}x{g[1]}x{g[2]} {'tma' if g[3] == '1' else 'global loads'}"),
    (re.compile(r"crt_garner_kernelILi(\d+)ELb(\d)ELb(\d)E"), lambda g: f"nmax={g[0]} vec={g[1]} dd={g[2]}"),
)


def sass_functions(text: str) -> dict[str, list[str]]:
    """{function: [opcode, in order]} from `cuobjdump -sass`, NOPs left out:
    the base opcode, except MUFU with its function (MUFU.RCP)."""
    out, current = {}, None
    for line in text.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            current = out.setdefault(m.group(1), [])
            continue
        m = re.match(r"\s*/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_]*)(\.[A-Z0-9]+)?", line)
        if m and current is not None and m.group(1) != "NOP":
            current.append(m.group(1) + (m.group(2) if m.group(1) == "MUFU" and m.group(2) else ""))
    return out


def sass_instructions(text: str) -> dict[str, list[str]]:
    """{function: [instruction text, in order]} from `cuobjdump -sass`, NOPs
    left out, with parameter offsets and branch targets replaced by a
    placeholder."""
    out, current = {}, None
    for line in text.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            current = out.setdefault(m.group(1), [])
            continue
        m = re.match(r"\s*/\*[0-9a-f]{4,}\*/\s+(.*?)\s*;", line)
        if m and current is not None and not re.match(r"(?:@!?U?P\w+\s+)?NOP\b", m.group(1)):
            ins = re.sub(r"c\[0x0\]\[0x[0-9a-f]+\]", "c[0x0][param]", m.group(1))
            ins = re.sub(r"`\(\.L_x_\d+\)", "label", ins)
            current.append(re.sub(r"^((?:@!?U?P\w+\s+)?(?:BRA|BSSY|CALL|JMP|BRX)\S*\s+.*?)0x[0-9a-f]+",
                                  r"\1addr", ins))
    return out


def compare(this: list[str], other: list[str]) -> dict:
    """The instructions of each side that an in-order match leaves unpaired."""
    diff = [0, 0]
    for tag, i1, i2, j1, j2 in difflib.SequenceMatcher(None, this, other, autojunk=False).get_opcodes():
        if tag != "equal":
            diff[0] += i2 - i1
            diff[1] += j2 - j1
    return {"instructions": [len(this), len(other)], "differing": diff}


def library_sass(src: str, kernel: str) -> tuple[str, str]:
    """`cuobjdump -sass` of the library of `kernel` built from checkout
    `src` (a fresh interpreter, so two checkouts' modules do not mix), and
    its build log."""
    code = ("import sys; sys.path.insert(0, sys.argv[1]); from repro_torch.kernels import build; "
            "build.library(sys.argv[2]); print(build.library_path(sys.argv[2])); print(build.nvcc_path())")
    lib, nvcc = subprocess.run([sys.executable, "-c", code, src, kernel], capture_output=True, text=True,
                               check=True).stdout.split()
    cuobjdump = str(pathlib.Path(nvcc).with_name("cuobjdump"))
    log = pathlib.Path(lib).with_suffix(".log").read_text()
    return subprocess.run([cuobjdump, "-sass", lib], capture_output=True, text=True, check=True).stdout, log


def label_of(name: str) -> str:
    for pattern, label in LABELS:
        m = pattern.search(name)
        if m:
            return label(m.groups())
    return name


def counts(ops: list[str]) -> dict[str, int]:
    c = collections.Counter(ops)
    return {op: c[op] for op in OPCODES} | {"total": len(ops)}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--src", default=str(pathlib.Path(__file__).resolve().parents[1] / "src"),
                    help="the `src` directory of the checkout (default: this one)")
    ap.add_argument("--kernel", default="fp8_karatsuba", choices=KERNELS, help="the kernel's CUDA source")
    ap.add_argument("--against", metavar="OTHER/src",
                    help="also compare each variant's instructions with this checkout's")
    args = ap.parse_args()
    sass, log = library_sass(args.src, args.kernel)
    record = {}
    for name, ops in sass_functions(sass).items():
        where = [i for i, op in enumerate(ops) if op in TENSOR]
        loop = ops[where[0]:where[-1] + 1] if where else []
        record[label_of(name)] = {"all": counts(ops), "main_loop": counts(loop)}
    out = {"src": args.src, "kernel": args.kernel,
           "serialized_wgmma": "wgmma.mma_async instructions are serialized" in log, "functions": record}
    if args.against:
        # matched by label: two builds need not mangle one variant alike
        this, other = ({label_of(name): ins for name, ins in sass_instructions(text).items()}
                       for text in (sass, library_sass(args.against, args.kernel)[0]))
        out["against"] = {label: compare(ins, other.get(label, [])) for label, ins in this.items()}
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
