"""Quickstart of the PyTorch/CUDA port: `repro_torch.linalg`, a drop-in
high-precision matmul scoped by `repro_torch.use_policy`, on the card.

    PYTHONPATH=src python examples/torch_quickstart.py [--device cpu]

The twin of `examples/quickstart.py`: the same products and checks, on
the card by default (``--device cpu`` runs the kernels' plain versions).
Where that script projects a TPU's throughput, this one prints each
call's measured time beside the device it ran on.
"""
import argparse
import time

import numpy as np
import torch
import torch.distributed as dist

import repro_torch
from repro_torch import GemmPolicy
from repro_torch.core.executor import resolve_device


def device_name(device: torch.device) -> str:
    return torch.cuda.get_device_name(device) if device.type == "cuda" else "the CPU"


def timed(fn, device):
    """(result, seconds) of one call, the card's work included."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    t0 = time.perf_counter()
    out = fn()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    return out, time.perf_counter() - t0


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None, help="default: the card; 'cpu' runs the plain versions")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    rng = np.random.default_rng(0)
    m = k = n = 256

    # ---- real f64 GEMM emulated on int8 arithmetic -------------------------
    # One policy object answers every static question: what to emulate
    # (backend), how precisely (n_moduli/mode), and WHERE to run it
    # (execution: plain PyTorch reference | the hand-written Hopper kernels).
    a = rng.standard_normal((m, k))
    b = rng.standard_normal((k, n))
    with repro_torch.use_policy(GemmPolicy(backend="ozaki2_f64")):
        c = repro_torch.linalg.matmul(a, b, device=dev).cpu().numpy()  # default N=16
    ref = np.asarray(a, np.longdouble) @ np.asarray(b, np.longdouble)
    print("DGEMM emulation max rel err:", float(np.max(np.abs(c - ref) / np.abs(ref).max())))

    # ---- the paper's contribution: complex GEMM ---------------------------
    az = (a + 1j * rng.standard_normal((m, k))).astype(np.complex128)
    bz = (b + 1j * rng.standard_normal((k, n))).astype(np.complex128)
    cz = repro_torch.linalg.zgemm(az, bz, device=dev).cpu().numpy()  # BLAS-shaped wrapper, N=14
    refz = np.asarray(az, np.clongdouble) @ np.asarray(bz, np.clongdouble)
    print("ZGEMM emulation max rel err:", float(np.max(np.abs(cz - refz) / np.abs(refz).max())))
    native = (torch.from_numpy(az).to(dev) @ torch.from_numpy(bz).to(dev)).cpu().numpy()
    print("native ZGEMM    max rel err:", float(np.max(np.abs(native - refz) / np.abs(refz).max())))

    # ---- same policy, the kernel execution --------------------------------
    # execution="kernel" runs the modulus-batched pipeline on four
    # hand-written Hopper kernels (their plain PyTorch versions with
    # --device cpu): 4 launches per GEMM at any N, and for f32-grade dtypes
    # bitwise-identical to the reference execution.
    a32, b32 = (torch.from_numpy(x.astype(np.float32)).to(dev) for x in (a, b))
    kpol = GemmPolicy(backend="ozaki2_f32", execution="kernel")
    with repro_torch.use_policy(kpol):
        ck = repro_torch.linalg.matmul(a32, b32, device=dev)
    cr = repro_torch.linalg.matmul(a32, b32, policy=GemmPolicy(backend="ozaki2_f32"), device=dev)
    print("kernel path bitwise == reference (f32):", bool(torch.equal(ck, cr)))

    # ---- same policy, FP8 (e4m3) engine -----------------------------------
    # execution="fp8" runs the residue products on the e4m3 tensor cores:
    # residues split into balanced base-16 digits, exact in e4m3, so the
    # pipeline stays bitwise identical to the int8 kernels; what changes is
    # the engine the MACs run on.
    fpol = GemmPolicy(backend="ozaki2_f32", execution="fp8")
    with repro_torch.use_policy(fpol):
        cf = repro_torch.linalg.matmul(a32, b32, device=dev)
    print("fp8 engine bitwise == int8 kernels:", bool(torch.equal(cf, ck)))

    # fewer moduli = faster & less accurate; more = beyond-native accuracy
    azt, bzt = torch.from_numpy(az).to(dev), torch.from_numpy(bz).to(dev)
    for nm in (10, 13, 16):
        with repro_torch.use_policy(GemmPolicy(backend="ozaki2_c128", n_moduli=nm)):
            repro_torch.linalg.matmul(azt, bzt, device=dev)  # warm-up
            czn, dt = timed(lambda: repro_torch.linalg.matmul(azt, bzt, device=dev), dev)
        err = float(np.max(np.abs(czn.cpu().numpy() - refz) / np.abs(refz).max()))
        print(f"  N={nm:2d}: err={err:.2e}   measured ZGEMM @{m}^3: {dt * 1e3:.2f} ms on {device_name(dev)}")

    # ---- same policy, sharded over the mesh --------------------------------
    # execution="sharded" runs the kernel pipeline on every rank of a
    # torch.distributed mesh: the N residue planes split over its 'residue'
    # dim (falling back to 'model'), m/n like a normal GEMM, and the exact
    # f64 partial planes are summed in one all-reduce, so the result is
    # bitwise identical to execution="kernel" on EVERY mesh shape.  Run
    # under `python -m torch.distributed.run --nproc-per-node R` to span R
    # ranks; alone it is a world of one, where the mesh is trivial but the
    # full sharded machinery still runs (and still bit-matches).
    from repro_torch.launch.mesh import init_world, make_host_mesh

    dev, owned = init_world(dev)
    try:
        mesh = make_host_mesh(1, 1, residue=dist.get_world_size(), device_type=dev.type)
        spol = GemmPolicy(backend="ozaki2_f32", execution="sharded")
        with repro_torch.use_policy(spol, mesh=mesh):  # or GemmPolicy(mesh=mesh)
            cs = repro_torch.linalg.matmul(a32, b32, device=dev)
        print(f"sharded over {dist.get_world_size()} rank(s) bitwise == kernel:", bool(torch.equal(cs, ck)))
    finally:
        if owned:
            dist.destroy_process_group()


if __name__ == "__main__":
    main()
