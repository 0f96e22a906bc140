"""Traces of the port: what one eager call launched, computed and sent.

The port's counterpart of `repro.analysis.jaxprs`.  Where the reference
walks the jaxpr of a traced program, `trace(fn, *args, **kwargs)` runs
`fn` once, eagerly, on whatever device its operands lie on, and returns a
:class:`Trace` of three kinds of record:

* :class:`Launch`, one per call of a kernel wrapper (the ten of
  `kernels.WRAPPERS`): the kernel's name, its operands' dtypes and
  shapes, the launch's contraction length ``k``, the megakernels'
  in-launch ``chunk_limit``, the enclosing launches and its products'
  operations (``ops``).  Each wrapper
  writes its record just before it dispatches (`kernels.common.
  traced_launch`), so a CPU run, which takes the plain versions, records
  the launches the card runs; it does not count them in `.launches`.
* :class:`Op`, one per aten op, seen through a `TorchDispatchMode`
  (which sees CUDA tensors as it sees CPU ones).  The product family
  (`PRODUCT_OPS`: ``mm``, ``bmm``, ``addmm``, ... and what ``matmul`` and
  ``tensordot`` decompose into) carries its contraction length ``K``, the
  provenance of each operand and each operand's **provable bound**, the
  torch counterpart of a jaxpr's constvars.  `trace`'s arguments are
  *derived from the input*, and so is any op output with a derived input.
  A tensor that is not derived (a table such as `core.crt.partial_split`'s
  ``u``) is bounded by its value.  A derived tensor has a bound only
  through int8, uint8, bool or float8 provenance, which the shape- and
  value-preserving ops (`PRESERVING_OPS`, the reference's `_PRESERVING`
  set) carry, ``cat`` and ``stack`` taking the largest.
* :class:`Collective`, one per call of `distributed.sharded_gemm.
  collective` (read through `CollectiveLog`).

The dispatch mode only observes: a traced call returns the bits of an
untraced one.  Its per-tensor state lives in a `WeakTensorKeyDictionary`
of the trace, so nothing outlives the tensors it describes.

A backward runs inside the mode only when ``backward()`` (or
``torch.autograd.grad``) is called inside the traced function.
"""
from __future__ import annotations

import collections
import dataclasses
import math

import torch
from torch.utils import _pytree as pytree
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.weak import WeakTensorKeyDictionary

from ..kernels import common

__all__ = [
    "Collective",
    "Launch",
    "Op",
    "PRESERVING_OPS",
    "PRODUCT_OPS",
    "Trace",
    "count_launches",
    "trace",
]

#: aten products, by the positions of their two operands
PRODUCT_OPS = {
    "mm": (0, 1), "bmm": (0, 1), "matmul": (0, 1), "dot": (0, 1), "vdot": (0, 1), "mv": (0, 1),
    "_int_mm": (0, 1), "_scaled_mm": (0, 1),
    "addmm": (1, 2), "baddbmm": (1, 2), "addbmm": (1, 2), "addmv": (1, 2),
}

#: ops whose output's values are some of (or the negation, magnitude or
#: another type's copy of) their first operand's: a bound carries through
PRESERVING_OPS = frozenset({
    "_to_copy", "view", "_unsafe_view", "reshape", "permute", "transpose", "t", "expand", "slice",
    "select", "squeeze", "unsqueeze", "neg", "abs", "clone", "alias", "detach", "lift_fresh",
})

#: ops whose output holds every operand's values: the largest bound
JOIN_OPS = frozenset({"cat", "stack"})

# dtype provenance: residue planes are int8 (|r| <= 127), e4m3 operands are
# balanced base-16 digits (|d| <= 8, `kernels.fp8_mod_gemm.digits`)
_FP8_DIGIT_BOUND = 8.0
_PROVENANCE = {torch.int8: ("int8", 127.0), torch.uint8: ("int8", 255.0), torch.bool: ("int8", 1.0)}
for _name in ("float8_e4m3fn", "float8_e4m3fnuz", "float8_e5m2", "float8_e5m2fnuz"):
    if hasattr(torch, _name):
        _PROVENANCE[getattr(torch, _name)] = ("fp8", _FP8_DIGIT_BOUND)


def dtype_name(dtype) -> str:
    """'int8' for torch.int8: the name the findings print."""
    return str(dtype).removeprefix("torch.")


@dataclasses.dataclass(frozen=True)
class Launch:
    """One kernel launch: `name` is its source's (the `kernels.WRAPPERS`
    key), `k` its contraction length (None for a kernel that multiplies
    nothing), `chunk_limit` the megakernels' in-launch K chunk, `path` the
    launches it ran inside (none for a wrapper called directly), `ops` the
    (engine, operations) of its products ('int8' or 'e4m3', 2 a MAC; None
    for a kernel that multiplies nothing)."""

    name: str
    dtypes: tuple
    shapes: tuple
    k: int | None = None
    chunk_limit: int | None = None
    path: tuple = ()
    ops: tuple | None = None


@dataclasses.dataclass(frozen=True)
class Op:
    """One aten op.  `path` names the launches whose plain version ran it.
    A product also carries `k`, its operands' provenance (`kinds`: 'int8',
    'fp8' or None) and provable bounds (`bounds`: max |value|, None where
    nothing bounds it); both are left None inside a launch, whose own
    record the passes hold instead."""

    name: str
    dtypes: tuple
    out_dtypes: tuple
    path: tuple = ()
    k: int | None = None
    kinds: tuple | None = None
    bounds: tuple | None = None

    @property
    def is_product(self) -> bool:
        return self.name in PRODUCT_OPS


@dataclasses.dataclass(frozen=True)
class Collective:
    """One call of `sharded_gemm.collective`: its op ('sum', 'max' or
    'broadcast'), the tensor's dtype and shape, the mesh dim it spans."""

    op: str
    dtype: torch.dtype
    shape: tuple
    dim: str


@dataclasses.dataclass
class _Info:
    derived: bool
    kind: str | None = None
    bound: float | None = None


class Trace:
    """The records of one traced call (`trace`), and `result`, what the
    call returned.  While the call runs it is also the launch recorder of
    `kernels.common.TRACERS`."""

    def __init__(self):
        self.launches: list[Launch] = []
        self.ops: list[Op] = []
        self.collectives: list[Collective] = []
        self.result = None
        self._open: list[str] = []
        self._info = WeakTensorKeyDictionary()

    # ------------------------------------------------- the launch recorder

    def launch(self, name, tensors, k, chunk_limit, ops=None):
        self.launches.append(Launch(
            name, tuple(t.dtype for t in tensors), tuple(tuple(t.shape) for t in tensors),
            None if k is None else int(k), None if chunk_limit is None else int(chunk_limit),
            tuple(self._open), ops))
        self._open.append(name)

    def end_launch(self):
        self._open.pop()

    # ---------------------------------------------------------- summaries

    def launch_counts(self) -> dict[str, int]:
        """The number of launches of each kernel, by name."""
        return dict(collections.Counter(r.name for r in self.launches))

    def products(self) -> list[Op]:
        return [op for op in self.ops if op.is_product]

    # ------------------------------------------------------ tensor state

    def mark_input(self, t: torch.Tensor) -> None:
        """`t` holds values derived from the traced call's input (and no
        provenance beyond its own dtype's)."""
        self._info[t] = _Info(True)

    def derived(self, t: torch.Tensor) -> bool:
        info = self._info.get(t)
        return info is not None and info.derived

    def kind(self, t: torch.Tensor) -> str | None:
        """'int8' or 'fp8' where `t`'s values came from such a dtype."""
        info = self._info.get(t)
        if info is not None and info.kind is not None:
            return info.kind
        return _PROVENANCE.get(t.dtype, (None,))[0]

    def bound(self, t: torch.Tensor) -> float | None:
        """A provable bound of max |t|: its provenance's for a derived
        tensor (None without one), its value for any other."""
        info = self._info.get(t)
        if info is not None and info.bound is not None:
            return info.bound
        prov = _PROVENANCE.get(t.dtype)
        if prov is not None:
            return prov[1]
        if info is not None and info.derived:
            return None
        return _value_bound(t)


def _value_bound(t: torch.Tensor) -> float | None:
    """max |t| of a concrete tensor, None where not finite or unknowable."""
    if t.device.type == "meta":
        return None
    if t.numel() == 0:
        return 0.0
    t = t.detach()
    v = float((t.abs() if t.is_complex() else t.double().abs()).max())
    return v if math.isfinite(v) else None


def _tensors(tree) -> list:
    return [x for x in pytree.tree_leaves(tree) if isinstance(x, torch.Tensor)]


def _op_tensors(values) -> list:
    """The tensors among an aten op's arguments or results: each one, or
    one inside a list or tuple (`cat`'s operands, a collective's)."""
    out = []
    for v in values:
        if isinstance(v, torch.Tensor):
            out.append(v)
        elif isinstance(v, (list, tuple)):
            out.extend(x for x in v if isinstance(x, torch.Tensor))
    return out


class _Recorder(TorchDispatchMode):
    """Records every aten op into `trace` and carries each output's
    derivation and provenance."""

    def __init__(self, tr: Trace):
        super().__init__()
        self.tr = tr

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        tr = self.tr
        name = func.overloadpacket.__name__
        ins = _op_tensors(args) + _op_tensors(kwargs.values())
        outs = _op_tensors(out if isinstance(out, (list, tuple)) else (out,))
        path = tuple(tr._open)
        dtypes = tuple(t.dtype for t in ins)
        out_dtypes = tuple(t.dtype for t in outs)
        pos = PRODUCT_OPS.get(name)
        if pos is not None and not path:
            lhs, rhs = args[pos[0]], args[pos[1]]
            k = lhs.numel() if name in ("dot", "vdot") else int(lhs.shape[-1])
            tr.ops.append(Op(name, dtypes, out_dtypes, path, k, (tr.kind(lhs), tr.kind(rhs)),
                             (tr.bound(lhs), tr.bound(rhs))))
        else:
            tr.ops.append(Op(name, dtypes, out_dtypes, path))
        derived = any(tr.derived(t) for t in ins)
        kind = bound = None
        if name in PRESERVING_OPS and isinstance(args[0], torch.Tensor):
            src = args[0]
            kind = tr.kind(src)
            bound = tr.bound(src) if tr.derived(src) else None
        elif name in JOIN_OPS:
            parts = list(args[0])
            kinds = {tr.kind(t) for t in parts}
            kind = kinds.pop() if len(kinds) == 1 else None
            if derived:  # (a table's own value bounds it where it is used)
                bounds = [tr.bound(t) for t in parts]
                bound = None if None in bounds else max(bounds)
        for t in outs:
            info = tr._info.get(t)
            if info is None:
                tr._info[t] = _Info(derived, kind, bound)
            elif derived:  # written in place from derived values
                tr.mark_input(t)
            if derived and t._base is not None and not tr.derived(t._base):
                tr.mark_input(t._base)  # a view written: its base holds derived values
        return out


def trace(fn, *args, **kwargs) -> Trace:
    """Run ``fn(*args, **kwargs)`` once, eagerly, and return its `Trace`
    (what it returned in ``.result``).  Every tensor in `args` and
    `kwargs` (through dicts, lists and tuples) is derived from the input."""
    from ..distributed.sharded_gemm import CollectiveLog

    tr = Trace()
    for t in _tensors((args, kwargs)):
        tr.mark_input(t)
    common.TRACERS.append(tr)
    try:
        with CollectiveLog() as log, _Recorder(tr):
            tr.result = fn(*args, **kwargs)
    finally:
        common.TRACERS.remove(tr)
    tr.collectives = [Collective(op, dt, tuple(shape), dim) for op, dt, shape, dim in log.calls]
    return tr


def count_launches(fn, *args, **kwargs) -> int:
    """The number of kernel launches of ``fn(*args, **kwargs)``: the
    counterpart of `repro.analysis.count_pallas_calls` (which counts
    without executing; this runs the call, on the CPU its plain versions)."""
    return len(trace(fn, *args, **kwargs).launches)
