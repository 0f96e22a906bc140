"""Build and load the port's CUDA kernels.

Each `csrc/<name>.cu` is compiled on its own by `nvcc` into a shared library
with a plain C interface, which `ctypes` loads:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -fmad=false
         -shared -Xcompiler -fPIC -o build/repro_torch_kernels/<name>-<hash>.so

`-fmad=false` keeps every float multiply and add a separate rounding, as the
reference's op order needs; where a kernel fuses on purpose it says so with
an explicit intrinsic.  Fast-math is never on.  `<hash>` covers the source,
the shared headers and the flags, so an edited source is rebuilt on its
next use.  `build_all` starts one `nvcc` per source at once and waits for all.

Nothing here runs at import: the CPU tests import every module, and the CPU
machine has no `nvcc`.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import pathlib
import shutil
import subprocess

CSRC = pathlib.Path(__file__).resolve().parent / "csrc"
BUILD_DIR = pathlib.Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"
SOURCES = (
    "residue_cast", "int8_mod_gemm", "karatsuba_fused", "crt_garner",
    "fused_mod_gemm", "fused_karatsuba", "fp8_mod_gemm", "fp8_karatsuba", "launch_copy",
    "flash_attention",
)
HEADERS = (
    "common.cuh", "gemm_tiles.cuh", "fp8_tiles.cuh", "cast_tile.cuh", "garner_tile.cuh", "residue_fma.cuh",
    "hopper.cuh",
)
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-fmad=false", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)


def nvcc_path() -> str:
    nvcc = shutil.which("nvcc")
    if nvcc is None:
        home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
        nvcc = os.path.join(home, "bin", "nvcc")
    if not os.path.exists(nvcc):
        raise RuntimeError("nvcc not found: the CUDA kernels are built on a machine with the CUDA toolkit")
    return nvcc


def library_path(name: str) -> pathlib.Path:
    """Where the library of source `name` is built, keyed by content."""
    h = hashlib.sha256()
    for part in (f"{name}.cu", *HEADERS):
        h.update((CSRC / part).read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def _start(name: str) -> tuple[subprocess.Popen, pathlib.Path, pathlib.Path] | None:
    out = library_path(name)
    if out.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    proc = subprocess.Popen(
        [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
    )
    return proc, tmp, out


def _finish(name: str, job) -> None:
    proc, tmp, out = job
    log, _ = proc.communicate()
    out.with_suffix(".log").write_text(log)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {name}.cu (exit {proc.returncode}):\n{log}")
    os.replace(tmp, out)  # atomic: a concurrent loader sees all or nothing


def build_all() -> dict[str, str]:
    """Compile every stale source, one `nvcc` each, all at once.  Returns
    the `-Xptxas -v` report (registers, shared memory, spills) by name;
    raises after all have finished if any failed, with every failure's log."""
    jobs = {name: _start(name) for name in SOURCES}
    failures = []
    for name, job in jobs.items():
        if job is not None:
            try:
                _finish(name, job)
            except RuntimeError as e:
                failures.append(str(e))
    if failures:
        raise RuntimeError("\n".join(failures))
    return {name: library_path(name).with_suffix(".log").read_text() for name in SOURCES}


@functools.cache
def library(name: str) -> ctypes.CDLL:
    """The loaded library of source `name`, built first if needed."""
    job = _start(name)
    if job is not None:
        _finish(name, job)
    return ctypes.CDLL(str(library_path(name)))


def check_launch(name: str, status: int) -> None:
    """Raise if the C entry point of source `name` reported a CUDA error."""
    if status != 0:
        describe = library(name).repro_error_string
        describe.argtypes = [ctypes.c_int]
        describe.restype = ctypes.c_char_p
        raise RuntimeError(f"{name}: CUDA error {status} at launch: {describe(status).decode()}")


def cluster_launch_info(name: str, tile, n_mod: int, n_fields: int) -> list[int]:
    """What the C entry `<name>_cluster_info` of source `name` reports of
    its cluster kernel's launch with `tile` at `n_mod` moduli: {CM, CN, the
    most clusters the card holds at once, shared bytes a block, ...},
    `n_fields` values.  Needs the card."""
    fn = getattr(library(name), f"{name}_cluster_info")
    fn.argtypes = [ctypes.c_int] * 4 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    info = (ctypes.c_int * n_fields)()
    check_launch(name, fn(*tile, int(n_mod), info))
    return list(info)


def uses_tma(name: str, ar, ai, br, bi) -> bool:
    """Whether the TMA kernel of source `name` (`karatsuba_fused`,
    `fp8_karatsuba`, or `fp8_mod_gemm` or `int8_mod_gemm`, which pass their
    one A and one B twice) loads these (card) operands by TMA: the rule of
    `csrc/hopper.cuh`, read through the C entry `repro_uses_tma` that each
    of those sources defines (k and n multiples of 16, every operand
    16-byte aligned), which shape and alignment alone decide."""
    return bool(_uses_tma_entry(name)(ar.data_ptr(), ai.data_ptr(), br.data_ptr(), bi.data_ptr(),
                                      br.shape[-1], ar.shape[-1]))


@functools.cache
def _uses_tma_entry(name: str):
    fn = library(name).repro_uses_tma
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 2
    fn.restype = ctypes.c_int
    return fn
