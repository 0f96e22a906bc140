"""Shared ``--calibrate`` argparse surface of the port's CLIs.

The port's copy of `repro.tune.cli`, for the launch CLIs a later slice
ports.  Two flags:

    --calibrate {off,load,run}   off (default): presets + default tiles.
                                 load: read the calibration cache (warn +
                                 presets when missing or stale).  run: run
                                 the microbenchmarks + autotuner now,
                                 persist the cache, then use it.
    --calibration-file PATH      cache location (default:
                                 `default_cache_path()`)

`apply_calibration_args` resolves the flags into a process-global
`set_calibration` default and returns the active `Calibration` (or None).
"""
from __future__ import annotations

from .cache import (
    Calibration,
    default_cache_path,
    load_calibration,
    save_calibration,
    set_calibration,
)


def add_calibration_args(ap) -> None:
    """Install the shared --calibrate / --calibration-file flags on `ap`."""
    ap.add_argument(
        "--calibrate", choices=["off", "load", "run"], default="off",
        help="on-card calibration: 'load' reads the calibration cache "
             "(measured HW + tuned kernel tiles; warns and falls back to "
             "the presets when missing/stale), 'run' measures now and "
             "persists the cache, 'off' (default) keeps the hardware "
             "presets and default tiles",
    )
    ap.add_argument(
        "--calibration-file", default=None, metavar="PATH",
        help="calibration cache location (default: "
             "$REPRO_TORCH_CALIBRATION_DIR/calibration-<kind>-<count>.json)",
    )


def apply_calibration_args(args, *, smoke: bool = False, device=None) -> Calibration | None:
    """Resolve the flags: load/run as requested, install the result as the
    process-global calibration, and return it (None = presets)."""
    mode = getattr(args, "calibrate", "off")
    if mode == "off":
        return None
    path = getattr(args, "calibration_file", None) or default_cache_path()
    if mode == "run":
        from .calibrate import calibrate

        cal = calibrate(smoke=smoke, device=device)
        save_calibration(cal, path)
        print(f"calibration: measured + tuned -> {path}")
    else:
        cal = load_calibration(path)
        if cal is None:
            print(f"calibration: no usable cache at {path} — running on "
                  "hardware presets and default tiles")
        else:
            print(f"calibration: loaded {path} ({cal.hw.name})")
    set_calibration(cal)
    return cal
