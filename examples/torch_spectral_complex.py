"""Complex-GEMM application on the PyTorch/CUDA port: spectral filtering
Y = F^H diag(h) F X.

This is the class of HPC workload the paper targets (complex matrix
products dominating runtime).  The complex products run on the Ozaki-II
int8 emulation, on the card by default.

    PYTHONPATH=src python examples/torch_spectral_complex.py [--device cpu]

The twin of `examples/spectral_complex.py`: the same products and checks.
Where that script projects TPU v5e and B200 throughput, this one prints
the filter's measured time beside the device it ran on, and the
performance model's projection for the one preset it names (GH200, the
port's default without a calibration).
"""
import argparse
import time

import numpy as np
import torch

import repro_torch
from repro_torch import GemmPolicy
from repro_torch.core.executor import REFERENCE, PreparedOperand, gemm_prepared, resolve_device
from repro_torch.core.perfmodel import GH200, complex_tflops, select_formulation


def dft_matrix(n: int) -> np.ndarray:
    i = np.arange(n)
    return np.exp(-2j * np.pi * np.outer(i, i) / n) / np.sqrt(n)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None, help="default: the card; 'cpu' runs the plain versions")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    n, batch = 192, 64
    rng = np.random.default_rng(0)
    x = (rng.standard_normal((n, batch)) + 1j * rng.standard_normal((n, batch)))
    f = dft_matrix(n)
    h = np.exp(-0.5 * (np.arange(n) / n) ** 2)  # low-pass response

    # The plan builder can pick the Fig. 1 strategy from the SIII-C model
    # (same mode as the calls below, so the print matches what
    # formulation='auto' actually selects):
    form = select_formulation(n, batch, n, 14, mode="accu")
    print(f"perfmodel-selected formulation @ ({n},{n},{batch}): {form}")

    # scope the drop-in API once; every matmul below routes through it
    policy = GemmPolicy(backend="ozaki2_c128", n_moduli=14, mode="accu", formulation="auto")

    def emul(a, b):
        with repro_torch.use_policy(policy):
            return repro_torch.linalg.matmul(torch.as_tensor(a), torch.as_tensor(b), device=dev)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    hd = torch.from_numpy(h[:, None]).to(dev)
    emul(f, x)  # warm-up
    sync()
    t0 = time.perf_counter()
    spec = emul(f, x)                         # F X
    filt = hd * spec                          # diag(h) F X
    y = emul(f.conj().T, filt).cpu().numpy()  # F^H diag(h) F X
    sync()
    dt = time.perf_counter() - t0

    ref = f.conj().T @ (h[:, None] * (f @ x))
    err = np.max(np.abs(y - ref)) / np.max(np.abs(ref))
    print(f"spectral filter (n={n}, batch={batch}) emulated-vs-native rel err: {err:.2e}")

    # F and F^H are fixed across batches: residue-cast them once and
    # amortize step 1 of the scheme over every application (fast mode, on
    # the reference execution, as in the reference's example).
    pf = PreparedOperand(f, 14, side="left", backend=REFERENCE, device=dev)
    pfh = PreparedOperand(f.conj().T, 14, side="left", backend=REFERENCE, device=dev)
    xd = torch.from_numpy(x).to(dev)
    y2 = gemm_prepared(pfh, hd * gemm_prepared(pf, xd, method="paper", backend=REFERENCE),
                       method="paper", backend=REFERENCE).cpu().numpy()
    err2 = np.max(np.abs(y2 - ref)) / np.max(np.abs(ref))
    print(f"  prepared-operand (amortized F, F^H) rel err: {err2:.2e}")

    flops = 2 * 8 * n * n * batch
    where = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "the CPU"
    print(f"  measured: the filter's two emulated ZGEMMs took {dt * 1e3:.2f} ms on {where}")
    tf = complex_tflops(16384, 16384, 16384, 14, GH200, "accu")
    print(f"  projected by the performance model's {GH200.name} preset, ZGEMM emulation @16k^3: {tf:.0f} TFLOPS")
    print(f"  (this demo ran {flops/1e6:.1f} MFLOP of complex work)")


if __name__ == "__main__":
    main()
