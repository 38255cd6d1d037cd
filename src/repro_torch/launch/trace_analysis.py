"""Analysis of a step traced on the ``meta`` device: the port's counterpart
of the JAX package's ``repro.launch.hlo_analysis``.

The JAX package lowers a step to partitioned HLO and parses its text for
dot FLOPs, memory traffic and collective bytes, recovering while-loop
trip counts because XLA's own cost analysis visits a scanned layer body
once.  No PyTorch program yields HLO, so that parser has no counterpart
here.  Instead the step runs on ``meta`` tensors, which carry shapes and
types and no values, under :class:`Tracer`, a ``TorchDispatchMode`` that
records every aten op the step dispatches (its name, operand and result
shapes and types) and the live bytes of the storages the step allocates
(each storage's bytes added when an op first returns it, and taken off by
a ``weakref`` finalizer on its ``untyped_storage()`` when it dies), so
the trace also gives the step's peak memory.  Eager PyTorch runs every
layer as its own ops, so nothing is counted once for many layers: every
op's multiplier is 1.  The hand-written kernels are no aten ops; their
dispatch takes a ``meta`` branch that books each launch's own FLOPs and
bytes (``repro_torch.kernels._meta``), and :func:`analyze` adds those.

:func:`analyze` returns the reference's keys:

  · ``dot_flops``           2 · |result| · K of every mm / addmm / bmm /
                            baddbmm, plus the kernels' booked FLOPs;
  · ``hbm_traffic_bytes``   the dots' operands and results, in-place
                            slice writes (``copy_`` into a view,
                            ``index_put_``, ``scatter``, ``index_add_``)
                            at 2 × the update bytes, plus the kernels'
                            booked bytes;
  · ``unfused_traffic_bytes`` every op's operands and results (views and
                            empty allocations aside): an upper bound, as
                            no op is fused;
  · ``dus_traffic_bytes``   the slice writes alone;
  · ``collective_bytes``    the :data:`COLLECTIVES` keys, ``total`` and
                            ``count``;
  · ``n_ops``               the ops recorded (the reference counts HLO
                            computations instead).

Collectives.  One process issues none, so they come from the sharding
rules (:class:`CollectiveRules`), by this port's own rule, not XLA's:

  · in training, each parameter leaf's gradient is reduced over the data
    axes once a step: by reduce-scatter where
    ``param_shardings(..., zero=True)`` shards its moments over data, else
    by all-reduce (operand: the leaf's per-device gradient); where the
    moments are ZeRO-sharded, the updated leaf is then all-gathered over
    data (operand: its per-device shard);
  · every matmul whose weight operand is a parameter leaf that the rules
    shard over ``"model"`` gets one all-reduce of its per-device output
    where the sharded dim is the contraction dim, else one all-gather
    (operand: the output's per-device share).  This is a local rule with
    no propagation, so it is an upper bound of what a partitioner moves.
"""
from __future__ import annotations

import dataclasses
import math
import weakref

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.kernels import _meta

COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
               "collective-permute")
#: aten matmuls → (index of the weight-side operand, its contraction dim)
DOTS = {"mm": (1, 0), "addmm": (2, 0), "bmm": (1, 1), "baddbmm": (2, 1)}
#: in-place slice writes → index of the operand holding the update
SLICE_WRITES = {"index_put_": 2, "index_put": 2, "scatter_": 2,
                "scatter": 2, "scatter_add_": 3, "scatter_add": 3,
                "index_add_": 3, "index_add": 3, "index_copy_": 3,
                "slice_scatter": 1}
_EMPTY = ("empty", "empty_strided", "empty_like", "new_empty",
          "new_empty_strided")


def _base(func) -> str:
    """``aten.mm.default`` → ``mm``."""
    return func.__name__.split(".")[0]


@dataclasses.dataclass(frozen=True)
class TensorInfo:
    """What the trace keeps of one operand or result."""
    shape: tuple
    dtype: torch.dtype
    stride: tuple
    nbytes: int                  # numel · itemsize (not the storage's)
    storage: int                 # the storage's identity in this trace
    leaf: str | None             # the parameter leaf it views, if any


@dataclasses.dataclass(frozen=True)
class Op:
    """One dispatched aten op."""
    name: str                    # e.g. "aten.mm.default"
    operands: tuple              # TensorInfo of every tensor argument
    results: tuple               # TensorInfo of every tensor result
    view: bool                   # every result aliases an operand, no write
    update_bytes: int            # bytes an in-place slice write stores

    @property
    def base(self) -> str:
        return self.name.split(".")[1] if self.name.count(".") else \
            self.name


@dataclasses.dataclass
class Trace:
    """A step's ops, the kernels' bookings and its memory: ``peak_bytes``
    is the most bytes live at once of the storages the step allocated
    (its results included), ``end_bytes`` those still live when it
    returned; ``leaves`` maps a parameter leaf's name to its (shape,
    stride)."""
    ops: list
    bookings: list
    peak_bytes: int = 0
    end_bytes: int = 0
    leaves: dict = dataclasses.field(default_factory=dict)


def _tensors(items) -> list:
    """The tensors among an op's arguments or results (aten passes them
    bare or in one level of lists)."""
    out = []
    for x in items:
        if isinstance(x, torch.Tensor):
            out.append(x)
        elif isinstance(x, (tuple, list)):
            out += [t for t in x if isinstance(t, torch.Tensor)]
    return out


def _key(t: torch.Tensor) -> int:
    return t.untyped_storage()._cdata


class Tracer(TorchDispatchMode):
    """Record every aten op dispatched inside the block and the live
    bytes of the storages they allocate.  ``leaves`` (name → tensor)
    names the parameters whose views the trace should recognise."""

    def __init__(self, leaves: dict | None = None):
        super().__init__()
        self.trace = Trace([], [])
        self._leaf_of = {}
        for name, t in (leaves or {}).items():
            self._leaf_of[_key(t)] = name
            self.trace.leaves[name] = (tuple(t.shape), tuple(t.stride()))
        self._live = {}
        self._bytes = 0

    def _info(self, t: torch.Tensor) -> TensorInfo:
        key = _key(t)
        return TensorInfo(tuple(t.shape), t.dtype, tuple(t.stride()),
                          t.numel() * t.element_size(), key,
                          self._leaf_of.get(key))

    def _dead(self, key: int, nbytes: int) -> None:
        if self._live.pop(key, None) is not None:
            self._bytes -= nbytes

    def _born(self, t: torch.Tensor) -> None:
        st = t.untyped_storage()
        key, nbytes = st._cdata, st.nbytes()
        self._live[key] = nbytes
        self._bytes += nbytes
        self.trace.peak_bytes = max(self.trace.peak_bytes, self._bytes)
        weakref.finalize(st, self._dead, key, nbytes)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        ins = _tensors((*args, *kwargs.values()))
        outs = _tensors(out if isinstance(out, (tuple, list)) else (out,))
        in_keys = {_key(t) for t in ins}
        for t in outs:
            key = _key(t)
            if key not in in_keys and key not in self._live:
                self._born(t)
        operands = tuple(self._info(t) for t in ins)
        results = tuple(self._info(t) for t in outs)
        base = _base(func)
        name = str(func)
        update = 0
        if base in SLICE_WRITES and len(args) > SLICE_WRITES[base] \
                and isinstance(args[SLICE_WRITES[base]], torch.Tensor):
            upd = args[SLICE_WRITES[base]]
            update = upd.numel() * upd.element_size()
        elif base == "copy_":
            dst, src = args[0], args[1]
            if dst.numel() * dst.element_size() \
                    < dst.untyped_storage().nbytes():
                update = src.numel() * src.element_size()
        view = bool(outs) and not base.endswith("_") \
            and all(_key(t) in in_keys for t in outs)
        self.trace.ops.append(Op(name, operands, results, view, update))
        return out


def trace(fn, *args, leaves: dict | None = None, **kwargs):
    """Run ``fn(*args, **kwargs)`` (on meta tensors) under a
    :class:`Tracer` with the kernels' bookings recorded → (its result,
    the :class:`Trace`)."""
    tracer = Tracer(leaves)
    with _meta.recording(tracer.trace.bookings), tracer:
        out = fn(*args, **kwargs)
    tracer.trace.end_bytes = tracer._bytes
    return out, tracer.trace


def _numel(shape) -> int:
    return math.prod(shape)


def dot_shape(op: Op) -> tuple:
    """(result shape, contraction size) of a matmul op."""
    wi, wc = DOTS[op.base]
    return op.results[0].shape, op.operands[wi].shape[wc]


# ---------------------------------------------------------------------------
# collectives from the rules
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class CollectiveRules:
    """What the collective rule reads: the mesh's axis sizes, each
    parameter leaf's spec under ``param_shardings`` (a ``PartitionSpec``
    over the leaf as the port holds it, one layer of a stacked leaf) and,
    for a training step, each leaf's ZeRO moment spec over the JAX tree's
    leaf (``zero``: name → (per-device bytes of the gradient, of the
    ZeRO shard, whether the moments are data-sharded)) — see the module
    docstring."""
    axis_sizes: dict
    specs: dict
    zero: dict | None = None

    @property
    def model(self) -> int:
        return self.axis_sizes.get("model", 1)

    @property
    def data(self) -> int:
        return math.prod(n for a, n in self.axis_sizes.items()
                         if a in ("pod", "data"))


def _operand_dim(info: TensorInfo, leaf_shape, leaf_stride, dim: int):
    """The dim of an operand (a view of a leaf) that is the leaf's ``dim``
    (same stride and size), or None."""
    for i, (n, s) in enumerate(zip(info.shape, info.stride)):
        if s == leaf_stride[dim] and n == leaf_shape[dim]:
            return i
    return None


def collectives(trace: Trace, rules: CollectiveRules | None) -> dict:
    """The collective bytes the rules imply for ``trace``."""
    coll = {k: 0.0 for k in COLLECTIVES}
    count = 0
    if rules is None:
        return {**coll, "total": 0.0, "count": 0}
    if rules.model > 1:
        for op in trace.ops:
            if op.base not in DOTS:
                continue
            wi, wc = DOTS[op.base]
            # the two matmul operands and their contraction dims
            sides = ((wi - 1, len(op.operands[wi - 1].shape) - 1), (wi, wc))
            for oi, cdim in sides:
                info = op.operands[oi]
                spec = rules.specs.get(info.leaf)
                if spec is None or "model" not in tuple(spec):
                    continue
                shape, stride = trace.leaves[info.leaf]
                d = _operand_dim(info, shape, stride,
                                 tuple(spec).index("model"))
                if d is None:
                    continue
                out = op.results[0].nbytes
                if d == cdim:
                    coll["all-reduce"] += out
                else:
                    coll["all-gather"] += out / rules.model
                count += 1
                break
    if rules.zero and rules.data > 1:
        for grad_bytes, shard_bytes, zeroed in rules.zero.values():
            if zeroed:
                coll["reduce-scatter"] += grad_bytes
                coll["all-gather"] += shard_bytes
                count += 2
            else:
                coll["all-reduce"] += grad_bytes
                count += 1
    return {**coll, "total": sum(coll.values()), "count": count}


# ---------------------------------------------------------------------------
# the analysis
# ---------------------------------------------------------------------------
def analyze(trace: Trace, rules: CollectiveRules | None = None) -> dict:
    """The reference's roofline keys for a traced step (module
    docstring); ``rules`` adds the collectives (none without)."""
    flops = dot_traffic = dus = unfused = 0.0
    for op in trace.ops:
        rw = sum(i.nbytes for i in op.operands) \
            + sum(i.nbytes for i in op.results)
        if op.base in DOTS:
            shape, K = dot_shape(op)
            flops += 2.0 * _numel(shape) * K
            dot_traffic += rw
        dus += 2.0 * op.update_bytes
        if not op.view and op.base not in _EMPTY:
            unfused += rw
    booked_flops = sum(b.flops for b in trace.bookings)
    booked_bytes = sum(b.bytes for b in trace.bookings)
    return {
        "dot_flops": flops + booked_flops,
        "hbm_traffic_bytes": dot_traffic + dus + booked_bytes,
        "unfused_traffic_bytes": unfused + booked_bytes,
        "dus_traffic_bytes": dus,
        "collective_bytes": collectives(trace, rules),
        "n_ops": len(trace.ops),
    }


def top_dots(trace: Trace, k: int = 15) -> list:
    """The k biggest matmuls by FLOPs, with the reference's fields.
    ``mult`` is always 1: eager PyTorch runs every layer as its own ops,
    so there is no loop body counted once to correct.  ``comp`` is the
    aten op and ``op_name`` the parameter leaf the op reads, if any."""
    out = []
    for i, op in enumerate(trace.ops):
        if op.base not in DOTS:
            continue
        shape, K = dot_shape(op)
        leaf = next((x.leaf for x in op.operands if x.leaf), None)
        out.append({"flops": 2.0 * _numel(shape) * K,
                    "result": list(shape), "contract": K, "mult": 1,
                    "comp": op.name, "op_name": leaf or f"op {i}"})
    out.sort(key=lambda d: -d["flops"])
    return out[:k]
