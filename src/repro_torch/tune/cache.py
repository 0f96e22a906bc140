"""The calibration cache: measured `HW` + tuned kernel tiles, persisted.

The port's copy of `repro.tune.cache`.  One JSON file holds everything
`repro_torch.tune` measured on a machine, keyed by the (device kind, device
count, torch version, CUDA version) it was measured on:

.. code-block:: text

    {
      "schema": 1,
      "key": {"device_kind": "<torch.cuda.get_device_name>", "device_count": 1,
              "torch_version": "<torch.__version__>",
              "cuda_version": "<torch.version.cuda>"},
      "hw": {"name": "calibrated/<device kind>", "mem_bw": <B/s>,
             "int8_ops": <OPS>, "native_c64": <flop/s>, "native_c128": <flop/s>,
             "ici_bw": <B/s>, "fp8_ops": <OPS>, "gemm_launch_s": <s>,
             "collective_launch_s": <s>},
      "blocks": {"kernel/real/m512n512k1024": [64, 128, 64], ...}
    }

* ``hw`` is a full `perfmodel.HW` field dict (see `HW.from_calibration` for
  which entries come from measurement and which keep the preset);
* ``blocks`` maps ``"{family}/{dclass}/{bucket}"`` keys — family in
  ``kernel``/``fused``/``fp8``, dclass in ``real``/``complex``, bucket the
  power-of-two shape bucket of `shape_bucket`, the reference's keys — to the
  autotuned ``[bm, bn, bk]`` winner for that slot (`repro_torch.tune.
  autotune`), one of the tiles the slot's CUDA kernel compiles
  (`kernels.common.COMPILED_TILES`).

Staleness: `load_calibration` compares the stored key against the live
process and warns + returns None on mismatch (callers then price with the
presets and launch the default tiles), likewise for unreadable or corrupt
files.  A cache written by the reference package keys on a jax version and
no torch version, so it is always stale here.  Loading never raises for a
bad cache.

Scoping: `use_calibration` pushes onto a thread-local stack (innermost
wins), `set_calibration` installs a process-global default underneath it,
and `current_calibration` is what `perfmodel.default_hw` /
`kernels.common.resolve_blocks` consult.  Calibrations are frozen and
hashable.
"""
from __future__ import annotations

import contextlib
import dataclasses
import functools
import hashlib
import json
import os
import threading
import warnings

from ..core.perfmodel import HW

SCHEMA_VERSION = 1

#: kernel families the autotuner covers, by policy execution
FAMILIES = ("kernel", "fused", "fp8")

#: operand dtype classes (complex runs the Karatsuba kernels)
DCLASSES = ("real", "complex")

#: the fields of a cache key, in order
KEY_FIELDS = ("device_kind", "device_count", "torch_version", "cuda_version")


def shape_bucket(m: int, n: int, k: int) -> str:
    """The cache bucket one (m, k) x (k, n) GEMM shape falls into.

    Each dim rounds up to a power of two, floored at 128 and capped at
    16384 (the paper's largest benchmark dim), as in the reference.
    """
    def _b(d: int) -> int:
        v = 128
        while v < d and v < 16384:
            v <<= 1
        return v

    return f"m{_b(m)}n{_b(n)}k{_b(k)}"


def block_key(family: str, dclass: str, m: int, n: int, k: int) -> str:
    """The ``blocks`` mapping key for one (family, dclass, shape) slot."""
    if family not in FAMILIES:
        raise ValueError(f"unknown kernel family {family!r}; one of {FAMILIES}")
    if dclass not in DCLASSES:
        raise ValueError(f"unknown dtype class {dclass!r}; one of {DCLASSES}")
    return f"{family}/{dclass}/{shape_bucket(m, n, k)}"


@dataclasses.dataclass(frozen=True)
class Calibration:
    """One machine's measured model: `HW` + tuned tiles + the key.

    Frozen and hashable (``blocks`` is a sorted tuple of items, not a dict)
    so a calibration can ride wherever a `GemmPolicy` does.  ``torch_version``
    / ``cuda_version`` are None in a cache that lacks them (one written by
    the reference package), which makes it stale.
    """

    device_kind: str
    device_count: int
    torch_version: str | None
    cuda_version: str | None
    hw: HW
    blocks: tuple[tuple[str, tuple[int, int, int]], ...] = ()

    @property
    def key(self) -> dict:
        return {f: getattr(self, f) for f in KEY_FIELDS}

    def block_for(self, key: str) -> tuple[int, int, int] | None:
        """The tuned (bm, bn, bk) for one `block_key`, or None (untuned)."""
        for k, v in self.blocks:
            if k == key:
                return v
        return None

    def with_blocks(self, blocks: dict) -> "Calibration":
        """A copy with `blocks` replaced by the (canonically sorted) dict."""
        items = tuple(
            (str(k), tuple(int(x) for x in v))
            for k, v in sorted(blocks.items())
        )
        return dataclasses.replace(self, blocks=items)

    def to_json(self) -> dict:
        return {
            "schema": SCHEMA_VERSION,
            "key": self.key,
            "hw": dataclasses.asdict(self.hw),
            "blocks": {k: list(v) for k, v in self.blocks},
        }

    @classmethod
    def from_json(cls, obj: dict) -> "Calibration":
        if obj.get("schema") != SCHEMA_VERSION:
            raise ValueError(
                f"calibration schema {obj.get('schema')!r} != {SCHEMA_VERSION}"
            )
        key = obj["key"]
        blocks = obj.get("blocks", {})
        bad = {
            k: v for k, v in blocks.items()
            if not (isinstance(v, (list, tuple)) and len(v) == 3
                    and all(int(x) > 0 for x in v))
        }
        if bad:
            raise ValueError(f"malformed block winners: {bad}")
        return cls(
            device_kind=str(key["device_kind"]),
            device_count=int(key["device_count"]),
            torch_version=key.get("torch_version"),
            cuda_version=key.get("cuda_version"),
            hw=HW(**obj["hw"]),
        ).with_blocks(blocks)


def live_key(device=None) -> dict:
    """The key of this process: the kind and count of the device it
    computes on (the card unless `device` names the CPU), the torch version
    and the CUDA version torch was built with."""
    import torch

    from ..core.executor import resolve_device

    dev = resolve_device(device)
    if dev.type == "cuda":
        kind, count = torch.cuda.get_device_name(dev), torch.cuda.device_count()
    else:
        kind, count = "cpu", 1
    return {
        "device_kind": kind,
        "device_count": count,
        "torch_version": torch.__version__,
        "cuda_version": torch.version.cuda,
    }


def _process_key() -> dict:
    """`live_key` of the card when there is one, else of the CPU: what a
    cache loaded in this process is held to."""
    import torch

    return live_key(None if torch.cuda.is_available() else "cpu")


def calibration_hash(cal: Calibration | None) -> str | None:
    """Short content hash of a calibration (None passes through)."""
    if cal is None:
        return None
    blob = json.dumps(cal.to_json(), sort_keys=True).encode()
    return hashlib.sha256(blob).hexdigest()[:12]


def default_cache_path() -> str:
    """Where the tune CLI persists by default: ``$REPRO_TORCH_CALIBRATION_DIR``
    (else ``~/.cache/repro_torch``) / ``calibration-{device_kind}-{count}.json``.
    The directory differs from the reference's (``~/.cache/repro``), so the
    two packages never overwrite each other's cache."""
    key = _process_key()
    base = os.environ.get(
        "REPRO_TORCH_CALIBRATION_DIR",
        os.path.join(os.path.expanduser("~"), ".cache", "repro_torch"),
    )
    kind = str(key["device_kind"]).replace(" ", "_").replace("/", "_")
    return os.path.join(base, f"calibration-{kind}-{key['device_count']}.json")


def save_calibration(cal: Calibration, path: str) -> str:
    """Write the cache JSON (creating parent dirs); returns `path`."""
    parent = os.path.dirname(os.path.abspath(path))
    os.makedirs(parent, exist_ok=True)
    with open(path, "w") as f:
        json.dump(cal.to_json(), f, indent=1, sort_keys=True)
        f.write("\n")
    return path


def load_calibration(path: str, *, check_staleness: bool = True) -> Calibration | None:
    """Load a calibration cache, or None (with a warning) when it is unfit.

    "Unfit" covers a missing/unreadable file, corrupt or schema-mismatched
    JSON, and — with `check_staleness` — a key that does not match this
    process (another device kind or count, torch or CUDA version, or a cache
    of the reference package).  Returning None makes every consumer fall back
    to the presets and the default tiles.
    """
    try:
        with open(path) as f:
            cal = Calibration.from_json(json.load(f))
    except (OSError, ValueError, KeyError, TypeError) as e:
        warnings.warn(
            f"calibration cache {path!r} is unreadable ({e!r}); "
            "falling back to the hardware presets and default tiles",
            RuntimeWarning,
            stacklevel=2,
        )
        return None
    if check_staleness:
        key = _process_key()
        if cal.key != key:
            warnings.warn(
                f"calibration cache {path!r} is stale: measured on {cal.key}, "
                f"running on {key}; falling back to the hardware presets and "
                "default tiles (re-run `python -m repro_torch.tune` to refresh)",
                RuntimeWarning,
                stacklevel=2,
            )
            return None
    return cal


@functools.lru_cache(maxsize=64)
def load_calibration_cached(path: str) -> Calibration | None:
    """`load_calibration` memoized per path — the `GemmPolicy(calibration=)`
    resolution path, called on every matmul.  The stale/corrupt warning
    fires once per path per process."""
    return load_calibration(path)


# ------------------------------------------- active-calibration scoping

_STATE = threading.local()
_GLOBAL: list[Calibration | None] = [None]


def current_calibration() -> Calibration | None:
    """The innermost `use_calibration` calibration, else the process-global
    `set_calibration` default, else None (presets + default tiles)."""
    stack = getattr(_STATE, "stack", None)
    if stack:
        return stack[-1]
    return _GLOBAL[0]


def set_calibration(cal: Calibration | None) -> Calibration | None:
    """Install `cal` as the process-global default calibration; returns the
    previous default."""
    if cal is not None and not isinstance(cal, Calibration):
        raise TypeError(
            f"set_calibration expects a Calibration or None; got {type(cal).__name__}"
        )
    prev = _GLOBAL[0]
    _GLOBAL[0] = cal
    return prev


@contextlib.contextmanager
def use_calibration(cal: Calibration | str):
    """Scope the thread-local active calibration (innermost wins).

    Accepts a `Calibration` or a cache-file path (loaded via
    `load_calibration`; an unfit file warns and the scope is a no-op, so the
    body runs on presets + default tiles rather than failing).
    """
    if isinstance(cal, (str, os.PathLike)):
        cal = load_calibration(os.fspath(cal))
    if cal is not None and not isinstance(cal, Calibration):
        raise TypeError(
            f"use_calibration expects a Calibration or a cache path; got {type(cal).__name__}"
        )
    if cal is None:
        yield None
        return
    stack = getattr(_STATE, "stack", None)
    if stack is None:
        stack = _STATE.stack = []
    stack.append(cal)
    try:
        yield cal
    finally:
        stack.pop()
