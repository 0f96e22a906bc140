"""The port's Hopper kernels, each with its plain PyTorch version and a
launch counter (`<wrapper>.launches`), and the residue backends."""
from . import (
    crt_garner, flash_attention, fp8_mod_gemm, int8_mod_gemm, karatsuba_fused, launch_copy, residue_cast,
)

#: the wrapper of each kernel, by the name of its CUDA source
WRAPPERS = {
    "residue_cast": residue_cast.residue_cast,
    "int8_mod_gemm": int8_mod_gemm.int8_mod_gemm_batched,
    "karatsuba_fused": karatsuba_fused.karatsuba_mod_gemm_batched,
    "crt_garner": crt_garner.crt_garner,
    "fused_mod_gemm": int8_mod_gemm.fused_mod_gemm,
    "fused_karatsuba": karatsuba_fused.fused_karatsuba_mod_gemm,
    "fp8_mod_gemm": fp8_mod_gemm.fp8_mod_gemm_batched,
    "fp8_karatsuba": fp8_mod_gemm.fp8_karatsuba_mod_gemm_batched,
    "launch_copy": launch_copy.launch_copy,
    "flash_attention": flash_attention.flash_attention,
}


def reset_launches() -> None:
    for fn in WRAPPERS.values():
        fn.launches = 0
    fp8_mod_gemm.fp8_mod_gemm_batched.tma_launches = 0
    int8_mod_gemm.int8_mod_gemm_batched.tma_launches = 0
    fp8_mod_gemm.fp8_karatsuba_mod_gemm_batched.tma_launches = 0
    karatsuba_fused.karatsuba_mod_gemm_batched.tma_launches = 0


def launch_counts() -> dict[str, int]:
    return {name: fn.launches for name, fn in WRAPPERS.items()}
