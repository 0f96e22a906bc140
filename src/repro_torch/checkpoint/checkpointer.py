"""Atomic, optionally asynchronous checkpoints with auto-resume.

The port's copy of `repro.checkpoint.checkpointer`, with the same on-disk
layout, so a checkpoint written by either package restores in the other:
``<dir>/step_<N>/arrays.npz`` + ``meta.json``, written to a ``.tmp``
directory and renamed (atomic on POSIX), so a preemption mid-write never
corrupts the latest checkpoint.  `save(..., blocking=False)` writes on a
background thread; `wait()` joins it.

Keys are the tree's paths: dict keys in sorted order and list or tuple
indices, joined by "/".  A `PreparedOperand` leaf (a weight residue-cast
once for serving) is stored by its fields under its own path: `e_scale`,
`res{i}`, `bound{i}`, `e_bound` and `raw`, each only when present.
`restore` rebuilds the operands from the metadata of the `like` tree
(`core.policy.prepared_like` gives it without casting), which is what
lets `ServeEngine(prepare=True, prepared_dir=...)` restore its planes
instead of preparing again.

numpy has no bfloat16 or float8: such leaves are stored as their raw bits
(uint16 or uint8) and their dtype name goes into ``meta.json``'s
``_dtypes``, so they restore bitwise (the reference's own convention).  An
unnamed 2-byte void array (``|V2``, what numpy makes of a bfloat16 array
saved without that metadata) restores as bfloat16 too.
"""
from __future__ import annotations

import json
import os
import shutil
import threading

import numpy as np
import torch

from ..core.executor import PreparedOperand, resolve_device
from ..tree import leaves_with_paths, tree_map, unflatten

#: the dtypes numpy cannot hold, stored as raw bits of this width
_BITS = {
    torch.bfloat16: (torch.int16, np.uint16),
    torch.float8_e4m3fn: (torch.uint8, np.uint8),
    torch.float8_e5m2: (torch.uint8, np.uint8),
}
_BY_NAME = {str(dt).removeprefix("torch."): dt for dt in _BITS}


def _prepared_encode(p: PreparedOperand) -> dict:
    """The array fields of a PreparedOperand as a plain dict; the optional
    ones only when present (the reference's keys)."""
    enc = {}
    if p.e_scale is not None:
        enc["e_scale"] = p.e_scale
    for i, r in enumerate(p.residues):
        enc[f"res{i}"] = r
    for i, b in enumerate(p.bound):
        enc[f"bound{i}"] = b
    if p.e_bound is not None:
        enc["e_bound"] = p.e_bound
    if p.raw is not None:
        enc["raw"] = p.raw
    return enc


def _prepared_decode(like: PreparedOperand, enc: dict) -> PreparedOperand:
    p = object.__new__(PreparedOperand)
    p.side, p.n_moduli, p.n_limbs, p.dtype = like.side, like.n_moduli, like.n_limbs, like.dtype
    p.residues = tuple(enc[f"res{i}"] for i in range(len(like.residues)))
    p.bound = tuple(enc[f"bound{i}"] for i in range(len(like.bound)))
    p.e_scale = enc["e_scale"] if like.e_scale is not None else None
    p.e_bound = enc["e_bound"] if like.e_bound is not None else None
    p.raw = enc["raw"] if like.raw is not None else None
    return p


def _encoded(tree):
    """`tree` with each PreparedOperand replaced by its fields' dict."""
    return tree_map(lambda x: _prepared_encode(x) if isinstance(x, PreparedOperand) else x, tree)


def _flatten(tree):
    """(key, leaf) in `repro_torch.tree`'s order, the key the leaf's path
    joined by "/"."""
    for path, leaf in leaves_with_paths(_encoded(tree)):
        yield "/".join(map(str, path)), leaf


def _unflatten_into(like, flat):
    enc = unflatten(_encoded(like), [flat[k] for k, _ in _flatten(like)])
    return tree_map(lambda l, e: _prepared_decode(l, e) if isinstance(l, PreparedOperand) else e, like, enc)


def _to_host(v) -> tuple[np.ndarray, str | None]:
    """(numpy array, dtype name stored in the metadata or None)."""
    if isinstance(v, torch.Tensor):
        t = v.detach().to("cpu", copy=True)  # a CPU tensor's own copy too: the caller may update it in place
        if t.dtype in _BITS:
            return t.view(_BITS[t.dtype][0]).numpy().view(_BITS[t.dtype][1]), str(t.dtype).removeprefix("torch.")
        return t.numpy(), None
    a = np.asarray(v)
    if a.dtype.kind == "V" or a.dtype.name in _BY_NAME:
        name = a.dtype.name if a.dtype.name in _BY_NAME else "bfloat16"
        return a.view(np.uint16 if a.dtype.itemsize == 2 else np.uint8), name
    return a, None


def _to_tensor(a: np.ndarray, name: str | None, device) -> torch.Tensor:
    if name is None and a.dtype.kind == "V" and a.dtype.itemsize == 2:
        name = "bfloat16"
    if name is not None:
        dt = _BY_NAME[name]
        bits = torch.from_numpy(np.array(a, order="C").view(np.int16 if dt.itemsize == 2 else np.uint8))
        return bits.view(dt).to(device)
    return torch.from_numpy(np.array(a, order="C")).to(device)


def latest_step(directory: str) -> int | None:
    if not os.path.isdir(directory):
        return None
    steps = [
        int(d.split("_", 1)[1])
        for d in os.listdir(directory)
        if d.startswith("step_") and d.split("_", 1)[1].isdigit()
    ]
    return max(steps) if steps else None


class Checkpointer:
    def __init__(self, directory: str, keep: int = 3):
        self.directory = directory
        self.keep = keep
        self._thread: threading.Thread | None = None
        os.makedirs(directory, exist_ok=True)

    def save(self, step: int, tree, blocking: bool = True, extra_meta=None):
        # copied to the host synchronously: the values are a consistent snapshot
        host, dtypes = {}, {}
        for k, v in _flatten(tree):
            host[k], name = _to_host(v)
            if name is not None:
                dtypes[k] = name
        meta = {"step": int(step), "_dtypes": dtypes, **(extra_meta or {})}

        def _write():
            final = os.path.join(self.directory, f"step_{step}")
            tmp = final + ".tmp"
            shutil.rmtree(tmp, ignore_errors=True)
            os.makedirs(tmp)
            np.savez(os.path.join(tmp, "arrays.npz"), **host)
            with open(os.path.join(tmp, "meta.json"), "w") as f:
                json.dump(meta, f)
            shutil.rmtree(final, ignore_errors=True)
            os.rename(tmp, final)
            self._gc()

        self.wait()
        if blocking:
            _write()
        else:
            self._thread = threading.Thread(target=_write, daemon=True)
            self._thread.start()

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def _gc(self):
        steps = sorted(
            int(d.split("_", 1)[1])
            for d in os.listdir(self.directory)
            if d.startswith("step_") and d.split("_", 1)[1].isdigit()
        )
        for s in steps[: -self.keep]:
            shutil.rmtree(os.path.join(self.directory, f"step_{s}"), True)

    def restore(self, step: int, like, device=None, shardings=None):
        """Load `step` into the structure of `like` (a tree of tensors, meta
        tensors or anything else at the leaves; only its structure and its
        prepared operands' metadata are read), as tensors on `device`
        (None: the card).  With `shardings` (a tree like `like` of
        `distributed.sharding.NamedSharding`), each leaf is a `DTensor`
        holding this rank's block of the saved array, on the mesh's
        device; only the block leaves the host."""
        path = os.path.join(self.directory, f"step_{step}")
        dtypes = self.meta(step).get("_dtypes", {})
        host = torch.device("cpu") if shardings is not None else resolve_device(device)
        with np.load(os.path.join(path, "arrays.npz")) as z:
            flat = {k: _to_tensor(z[k], dtypes.get(k), host) for k, _ in _flatten(like)}
        tree = _unflatten_into(like, flat)
        if shardings is not None:
            tree = tree_map(lambda t, s: s.place(t), tree, shardings)
        return tree

    def meta(self, step: int) -> dict:
        with open(os.path.join(self.directory, f"step_{step}", "meta.json")) as f:
            return json.load(f)
