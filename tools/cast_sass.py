#!/usr/bin/env python3
"""Count the SASS instructions of one residue cast, the int32 `%` one
and the division-free one, as `nvcc` compiles them for sm_90a.

It compiles a probe source with four kernels, each casting f32 values with
the port's build flags (`kernels/build.NVCC_FLAGS`):

- `probe_base`: the load, the index and the byte store alone;
- `probe_div`: the cast with an int32 `%` per limb and modulus and the f32
  reciprocal reduce (defined in the probe: the route the port's kernels
  took before `residue_fma.cuh`, kept here for the comparison);
- `probe_fma`: `residue_fma` of `csrc/residue_fma.cuh` and its byte, as
  `residue_cast.cu`, `fused_karatsuba.cu` and `fused_mod_gemm.cu` run it;
- `probe_word`: four values a thread through `residue_fma` and
  `pack4_residues` into one word, as the megakernels' cast of a share
  (`cast_store`) does (its counts are per word, four casts, less
  `probe_base`'s one load and store).

`MUFU.RCP` in a probe's counts is the reciprocal with which every 32-bit
integer division or remainder by a run-time divisor starts: the
division-free probes have none.

Both casts read the plane's constants with a run-time plane index and
take the number of limbs at run time, as the kernels do, so the code of
every limb slot up to REPRO_MAX_LIMBS = 5 is compiled and the slots past
the run-time count are branched over: the counts are of the code as the
kernels compile it, not of the instructions one cast at 3 limbs (N = 14)
executes.  `cuobjdump -sass` lists each kernel; the script counts its
instructions by class, less `probe_base`'s, and prints one JSON line.
Needs the CUDA toolkit (`nvcc`, `cuobjdump`):

    python3 tools/cast_sass.py
"""
from __future__ import annotations

import collections
import json
import pathlib
import re
import subprocess
import sys
import tempfile

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

PROBE = r"""
#include "cast_tile.cuh"
#include "residue_fma.cuh"

// the reference's f32 symmetric mod (kernels/common.py sym_mod_f32): the
// guess n = rint(v * (1/p)) is within +/-1 of the quotient, and the two
// corrections make the result exact
__device__ __forceinline__ float sym_mod_f32(float v, float p, float half, float recip) {
  float n = rintf(v * recip);
  float r = v - n * p;
  if (r > half) r -= p;
  if (r < -half) r += p;
  return r;
}

// the cast by an int32 remainder per limb: limbs as the reference peels
// them, each limb's residue by sym_mod_i32, the radix sum, the f32 reduce
__device__ __forceinline__ int8_t cast_residue(float a, float scale, int l, const CastParams& prm) {
  float rem = truncf(a * scale), limbs[REPRO_MAX_LIMBS];
#pragma unroll
  for (int i = REPRO_MAX_LIMBS - 1; i >= 1; --i) {
    if (i < prm.n_limbs) {
      const float hi = truncf(rem * ldexpf(1.0f, -24 * i));
      rem = rem - hi * ldexpf(1.0f, 24 * i);
      limbs[i] = hi;
    }
  }
  limbs[0] = rem;
  float acc = 0.0f;
#pragma unroll
  for (int i = 0; i < REPRO_MAX_LIMBS; ++i) {
    if (i < prm.n_limbs) acc = acc + static_cast<float>(sym_mod_i32(static_cast<int>(limbs[i]), prm.pi[l])) * prm.radix[i][l];
  }
  const float p = prm.p[l];
  return static_cast<int8_t>(sym_mod_f32(acc, p, static_cast<float>((prm.pi[l] - 1) / 2), prm.recip[l]));
}

extern "C" __global__ void probe_base(const float* x, int8_t* out, float scale, int l, CastParams cp) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  out[i] = static_cast<int8_t>(__float_as_uint(x[i] * scale));
}

extern "C" __global__ void probe_div(const float* x, int8_t* out, float scale, int l, CastParams cp) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  out[i] = cast_residue(x[i], scale, l, cp);
}

extern "C" __global__ void probe_fma(const float* x, int8_t* out, float scale, int l, CastParams cp) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const PlaneCast pc = plane_cast(cp, l);
  out[i] = static_cast<int8_t>(residue_byte(residue_fma(x[i], scale, cp.n_limbs, pc)));
}

extern "C" __global__ void probe_word(const float* x, int8_t* out, float scale, int l, CastParams cp) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const PlaneCast pc = plane_cast(cp, l);
  const float4 v = reinterpret_cast<const float4*>(x)[i];
  const float r[4] = {residue_fma(v.x, scale, cp.n_limbs, pc), residue_fma(v.y, scale, cp.n_limbs, pc),
                      residue_fma(v.z, scale, cp.n_limbs, pc), residue_fma(v.w, scale, cp.n_limbs, pc)};
  reinterpret_cast<uint32_t*>(out)[i] = pack4_residues(r);
}
"""

# SASS opcodes by the unit that issues them
CLASSES = {
    "conversion": ("F2I", "I2F", "F2F", "FRND", "I2I", "F2FP"),
    "mufu": ("MUFU",),
    "integer": ("IMAD", "IADD3", "IMUL", "ISETP", "LOP3", "SHF", "IABS", "IMNMX", "SEL", "LEA",
                "PRMT", "SGXT", "IADD", "VIADD", "BMSK", "POPC", "FLO", "I2IP"),
    "float": ("FFMA", "FADD", "FMUL", "FSETP", "FSEL", "FMNMX", "FCHK", "FSWZADD"),
    "constant load": ("LDC", "ULDC"),
    "memory": ("LDG", "STG", "LDS", "STS", "LD", "ST"),
    "control": ("BRA", "EXIT", "BSSY", "BSYNC", "CALL", "RET", "WARPSYNC", "YIELD", "BAR"),
}


def opcode_class(op: str) -> str:
    for name, ops in CLASSES.items():
        if op in ops:
            return name
    return "other"


def count_sass(text: str) -> dict[str, collections.Counter]:
    """{kernel: Counter(opcode)} from `cuobjdump -sass`, NOPs left out."""
    out, current = {}, None
    for line in text.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            current = out.setdefault(m.group(1), collections.Counter())
            continue
        m = re.match(r"\s*/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_]*)", line)
        if m and current is not None and m.group(1) != "NOP":
            current[m.group(1)] += 1
            if m.group(1) == "MUFU" and ".RCP" in line:
                current["MUFU.RCP"] += 1
    return out


def main() -> int:
    from repro_torch.kernels import build

    nvcc = build.nvcc_path()
    cuobjdump = str(pathlib.Path(nvcc).with_name("cuobjdump"))
    flags = [f for f in build.NVCC_FLAGS if f not in ("-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")]
    with tempfile.TemporaryDirectory() as tmp:
        src, cubin = pathlib.Path(tmp) / "probe.cu", pathlib.Path(tmp) / "probe.cubin"
        src.write_text(PROBE)
        subprocess.run([nvcc, *flags, "-cubin", "-I", str(build.CSRC), "-o", str(cubin), str(src)],
                       check=True)
        sass = subprocess.run([cuobjdump, "-sass", str(cubin)], capture_output=True, text=True,
                              check=True).stdout
    counts = count_sass(sass)
    base = counts["probe_base"]
    record = {}
    for name in ("probe_div", "probe_fma", "probe_word"):
        diff = collections.Counter(counts[name])
        diff.subtract(base)
        rcp = diff.pop("MUFU.RCP", 0)  # of the MUFU, the reciprocals (counted once, as MUFU, in the rest)
        by_class = collections.Counter()
        for op, c in diff.items():
            by_class[opcode_class(op)] += c
        record[name] = {"total": sum(diff.values()), "by_class": dict(sorted(by_class.items())),
                        "by_opcode": {op: c for op, c in sorted(diff.items()) if c}, "mufu_rcp": rcp}
    print(json.dumps({"sass_less_probe_base": record, "nvcc_flags": flags}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
