"""Semantic cost of one step on the ``meta`` device: the counterpart of
``jaxpr_cost`` in ``repro/launch/costs.py``.

``step_cost(fn, *args)`` runs ``fn`` once under a dispatch mode and
counts, for the whole step (the backward and remat's recompute included,
since both run through the same dispatcher):

- matmul FLOPs, into a ``torch.utils.flop_counter.FlopCounterMode``
  (its formulas and its per-op table, ``flops_by_op``), fed every op
  without the mode's own decomposition of the ops it has no formula for
  (matmuls reach the dispatcher as ``mm``/``bmm``/``addmm`` already; the
  decomposition would only cost time);
- HBM bytes by the reference's model: each matmul's operands and output
  once a use, a gather's or index's output, a scatter's or copy's update;
  elementwise ops and reductions are taken as fused (no bytes, one FLOP an
  output element, ``ew_flops``);
- the peak of the bytes the step itself holds at once
  (``transient_peak_bytes``): every tensor an op allocates counts from its
  creation until it is freed, a view under its base's bytes.

A meta scan (``layers/scan_utils.py``) runs a loop's first and last
steps and one middle step standing for the rest; every count is scaled
by ``trip_scale()``, as the reference multiplies a scan body by its trip
count.  Matmul FLOPs and bytes then equal a real run's; elementwise FLOPs
of a training step come out low (autograd's gradient sums between a
loop's steps are not scaled), and the peak is an estimate.  Repeated
``meta`` ops reuse their first call's output metadata.  On one card there
are no collectives to parse (the reference's HLO collective parse waits
for placement over several cards, ROADMAP item 15).
"""
from __future__ import annotations

import weakref
from collections import defaultdict

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import FlopCounterMode, flop_registry

from repro_torch.layers.scan_utils import trip_scale

_GATHERS = ("index", "index_select", "gather", "embedding",
            "take_along_dim", "masked_select")
_SCATTERS = ("index_put", "index_put_", "_index_put_impl_", "scatter",
             "scatter_", "scatter_add", "scatter_add_", "scatter_reduce",
             "scatter_reduce_", "index_add", "index_add_", "index_copy",
             "index_copy_", "masked_scatter", "masked_scatter_", "copy_",
             "slice_scatter", "select_scatter")


_PLAIN = (int, float, bool, str, type(None), torch.dtype, torch.device,
          torch.memory_format, torch.layout)


def _flat(x, out: list) -> list:
    """The leaves of nested lists, tuples and dicts (an op's arguments
    and outputs), in order."""
    if isinstance(x, (list, tuple)):
        for v in x:
            _flat(v, out)
    elif isinstance(x, dict):
        for v in x.values():
            _flat(v, out)
    else:
        out.append(x)
    return out


def _meta_key(func, ins: list):
    """A key that fixes a ``meta`` op's outputs: the op and each argument's
    metadata (tensors: shape, strides, offset, dtype) or value; None when
    an argument is of another kind or nothing is on ``meta``."""
    key = [func]
    meta = False
    for a in ins:
        if isinstance(a, torch.Tensor):
            if a.device.type != "meta":
                return None
            meta = True
            key.append((a.shape, a.stride(), a.storage_offset(), a.dtype))
        elif isinstance(a, _PLAIN):
            meta |= isinstance(a, torch.device) and a.type == "meta"
            key.append((type(a), a))
        else:
            return None
    return tuple(key) if meta else None


def _nbytes(t) -> int:
    return t.numel() * t.element_size() if isinstance(t, torch.Tensor) else 0


class _OpInfo:
    """What the counters need of an op, read once from its schema."""
    __slots__ = ("kind", "fresh", "aliases")

    def __init__(self, func):
        schema = func._schema
        self.aliases = [r.alias_info for r in schema.returns]
        # allocates its outputs and writes none of its arguments
        self.fresh = (all(a is None for a in self.aliases)
                      and all(a.alias_info is None
                              for a in schema.arguments))
        name = func.overloadpacket.__name__
        if func.overloadpacket in flop_registry:
            self.kind = "matmul"
        elif name in _GATHERS:
            self.kind = "gather"
        elif name in _SCATTERS:
            self.kind = "scatter"
        elif self.aliases and all(a is not None and not a.is_write
                                  for a in self.aliases):
            self.kind = "view"
        else:
            self.kind = "elementwise"


_INFO: dict = {}


class _TripFlopCounter(FlopCounterMode):
    """``FlopCounterMode`` whose counts are scaled by the meta scans'
    trip count; ``_ByteCounter`` feeds it (it is not entered itself)."""

    def __init__(self):
        super().__init__(display=False)

    def _count_flops(self, func_packet, out, args, kwargs):
        if func_packet in self.flop_registry:
            n = self.flop_registry[func_packet](*args, **kwargs,
                                                out_val=out) * trip_scale()
            for par in set(self.mod_tracker.parents):
                self.flop_counts[par][func_packet] += n
        return out


class _Holding:
    """The bytes of one allocation, held while a tensor refers to it."""
    __slots__ = ("__weakref__",)


class _ByteCounter(TorchDispatchMode):
    """Semantic HBM bytes, elementwise FLOPs and the live bytes of the
    tensors allocated while it is on."""

    def __init__(self, flops: _TripFlopCounter):
        super().__init__()
        self.flops = flops
        self.acc: dict = defaultdict(int)
        self.live = 0
        self.peak = 0
        # outputs of ``meta`` ops that allocate and write nothing else,
        # by ``_meta_key``: a layer repeated L times runs its meta
        # kernels (shape inference in Python) once
        self._known: dict = {}

    def _run(self, func, info: _OpInfo, args, kwargs, ins: list):
        key = _meta_key(func, ins) if info.fresh else None
        if key is not None and key in self._known:
            many, specs = self._known[key]
            outs = [torch.empty_strided(shape, stride, dtype=dtype,
                                        device="meta")
                    for shape, stride, dtype in specs]
            return tuple(outs) if many else outs[0]
        out = func(*args, **kwargs)
        if key is not None:
            outs = out if isinstance(out, tuple) else (out,)
            if all(isinstance(t, torch.Tensor) and t.device.type == "meta"
                   for t in outs):
                self._known[key] = (isinstance(out, tuple), [
                    (t.shape, t.stride(), t.dtype) for t in outs])
        return out

    def _hold(self, t: torch.Tensor) -> None:
        n = _nbytes(t)
        tok = _Holding()
        t._cost_holding = tok
        self.live += n
        if self.live > self.peak:
            self.peak = self.live
        weakref.finalize(tok, self._free, n)

    def _free(self, n: int) -> None:
        self.live -= n

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        info = _INFO.get(func)
        if info is None:
            info = _INFO[func] = _OpInfo(func)
        ins = _flat((args, kwargs), [])
        out = self._run(func, info, args, kwargs, ins)
        outs = [t for t in _flat(out, []) if isinstance(t, torch.Tensor)]
        aliases = info.aliases
        for i, t in enumerate(outs):
            alias = aliases[min(i, len(aliases) - 1)] if aliases else None
            if alias is None:
                self._hold(t)
            elif not alias.is_write and args \
                    and isinstance(args[0], torch.Tensor) \
                    and hasattr(args[0], "_cost_holding"):
                t._cost_holding = args[0]._cost_holding
        kind = info.kind
        if kind == "view":
            return out
        scale = trip_scale()
        acc = self.acc
        if kind == "matmul":
            self.flops._count_flops(func.overloadpacket, out, args, kwargs)
            acc["bytes"] += (sum(map(_nbytes, ins))
                             + sum(map(_nbytes, outs))) * scale
        elif kind == "gather":
            moved = sum(map(_nbytes, outs)) * scale
            acc["bytes"] += moved
            acc["gather_bytes"] += moved
        elif kind == "scatter":
            src = [a for a in _flat((args[1:], kwargs), [])
                   if isinstance(a, torch.Tensor)]
            upd = _nbytes(src[-1]) if src else 0
            acc["bytes"] += upd * scale
            acc["scatter_bytes"] += upd * scale
        else:
            acc["ew_flops"] += sum(t.numel() for t in outs) * scale
        return out


def step_cost(fn, *args, **kwargs) -> dict:
    """The cost of ``fn(*args, **kwargs)`` (module docstring): ``flops``
    (matmul + elementwise), ``dot_flops``, ``ew_flops``, ``bytes``,
    ``gather_bytes``, ``scatter_bytes``, ``transient_peak_bytes`` and
    ``flops_by_op``.  Meant for tensors on ``meta``; it runs anywhere."""
    counter = _TripFlopCounter()
    with _ByteCounter(counter) as bc:
        fn(*args, **kwargs)
        peak = bc.peak
    by_op = {str(k): int(v) for k, v in
             counter.get_flop_counts().get("Global", {}).items()}
    dot = sum(by_op.values())
    out = {k: int(bc.acc[k]) for k in ("bytes", "gather_bytes",
                                       "scatter_bytes", "ew_flops")}
    out.update(dot_flops=dot, flops=dot + out["ew_flops"],
               transient_peak_bytes=int(peak), flops_by_op=by_op)
    return out
