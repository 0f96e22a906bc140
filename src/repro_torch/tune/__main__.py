"""python -m repro_torch.tune — the calibration microbenchmarks + tile autotuner.

Measures the card (`repro_torch.tune.calibrate`), autotunes the GEMM
kernels' tiles (`repro_torch.tune.autotune`), and persists both to the
calibration cache::

    PYTHONPATH=src python -m repro_torch.tune [--smoke] [--out PATH] [--no-blocks] [-v]

It runs on the card and raises without one; ``--device cpu`` runs the
probes and the kernels' plain versions on the CPU instead (the tests).
"""
from __future__ import annotations

import argparse
import sys


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.tune",
        description="one-shot on-card calibration + GEMM kernel tile autotune",
    )
    ap.add_argument("--smoke", action="store_true",
                    help="tiny probes and shapes (seconds; numbers noisy but "
                         "structurally valid)")
    ap.add_argument("--out", default=None, metavar="PATH",
                    help="cache file to write (default: default_cache_path())")
    ap.add_argument("--no-blocks", dest="blocks", action="store_false",
                    help="skip the tile autotuner (measure HW only)")
    ap.add_argument("-v", "--verbose", action="store_true",
                    help="print every measurement and candidate timing")
    ap.add_argument("--device", default=None,
                    help="'cpu' to calibrate the CPU (the plain versions) "
                         "instead of the card")
    args = ap.parse_args(argv)

    from .cache import calibration_hash, default_cache_path, save_calibration
    from .calibrate import calibrate

    cal = calibrate(smoke=args.smoke, blocks=args.blocks, verbose=args.verbose,
                    device=args.device)
    path = save_calibration(cal, args.out or default_cache_path())
    print(
        f"repro_torch.tune: calibrated {cal.device_kind} x{cal.device_count} "
        f"(torch {cal.torch_version}, cuda {cal.cuda_version}) -> {path}\n"
        f"  hw: mem_bw={cal.hw.mem_bw:.3e} B/s int8={cal.hw.int8_ops:.3e} "
        f"OPS fp8={cal.hw.fp8_ops:.3e} OPS "
        f"launch={cal.hw.gemm_launch_s:.2e} s\n"
        f"  blocks: {len(cal.blocks)} tuned slots; "
        f"cache hash {calibration_hash(cal)}"
    )
    return 0


if __name__ == "__main__":
    sys.exit(main())
