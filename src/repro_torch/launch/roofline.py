"""Roofline analysis from a traced step (no card needed).

Three terms per (arch × shape × mesh), all in seconds a step a device:

    compute    = FLOPs / PEAK_FLOPS_BF16
    memory     = bytes / HBM_BW
    collective = Σ link_bytes(op) / LINK_BW

The algebra (``CollectiveStats``, ``GraphCost``, ``Roofline``,
``roofline_terms``, ``analytic_model_flops``) and the HLO-text reader
``parse_collectives`` are the reference's (``repro/launch/roofline.py``),
divided by the H100's figures (:mod:`.mesh`).  Where the reference asks
XLA's ``compiled.cost_analysis()`` of a lowered program, the port runs the
step once, eagerly, on fake tensors: :func:`trace_cost`.

What ``trace_cost`` counts, and how it differs from XLA's figures:

* FLOPs: ``torch.utils.flop_counter.FlopCounterMode``, which counts the
  products (``mm``, ``bmm``, ``addmm``, convolutions, attention) and the
  formula registered for the flash kernel's op (``4·D`` a valid query-key
  pair and head, :mod:`repro_torch.kernels.flash_attention`).  XLA also
  counts elementwise and reduction FLOPs; those are left out here.
* bytes: every aten op's tensor inputs and outputs, once each; an op whose
  output aliases an input without writing it (a view) moves nothing.  This
  is the traffic of the eager program, which fuses nothing: each
  elementwise op reads and writes HBM.  XLA's ``bytes accessed`` is that of
  its fused program, so the port's figure is an upper bound on what a fused
  program would move.
* memory: the bytes of the arguments at entry, the peak of the live
  storages during the run, and the outputs — each storage once, whatever
  views of it exist.  An op's internal scratch (a reduction's workspace) is
  not seen.  XLA reports the same split from its buffer assignment.
* collectives: none on one card: ``{}`` and 0 link bytes.

Scan-awareness: the reference composes ``full + (count - 1)·block``
because XLA counts a ``lax.scan`` body once.  An eager trace runs every
layer, so its total is the whole step and needs no composition.
"""
from __future__ import annotations

import re
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, Tuple

import torch
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.multiprocessing.reductions import StorageWeakRef
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten
from torch.utils.flop_counter import FlopCounterMode

from .. import tree as tree_util
from .mesh import HBM_BW, LINK_BW, PEAK_FLOPS_BF16

_DTYPE_BYTES = {
    "f64": 8, "f32": 4, "f16": 2, "bf16": 2, "f8e4m3fn": 1, "f8e5m2": 1,
    "s64": 8, "s32": 4, "s16": 2, "s8": 1, "u64": 8, "u32": 4, "u16": 2,
    "u8": 1, "pred": 1, "c64": 8, "c128": 16, "s4": 1, "u4": 1,
}

_COLL_RE = re.compile(
    r"=\s+(?:\()?([a-z0-9]+)\[([\d,]*)\][^ ]*\s+"
    r"(all-reduce|all-gather|reduce-scatter|all-to-all|collective-permute)"
    r"(?:-start)?\(")
_GROUPS_RE = re.compile(r"replica_groups=\[(\d+),(\d+)\]")
_GROUPS_BRACE_RE = re.compile(r"replica_groups=\{\{([^}]*)\}")


@dataclass
class CollectiveStats:
    counts: Dict[str, int] = field(default_factory=dict)
    link_bytes: float = 0.0
    raw_bytes: float = 0.0
    by_op: Dict[str, float] = field(default_factory=dict)


def _shape_bytes(dtype: str, dims: str) -> float:
    n = 1
    for d in dims.split(","):
        if d:
            n *= int(d)
    return n * _DTYPE_BYTES.get(dtype, 4)


def parse_collectives(hlo_text: str) -> CollectiveStats:
    """Sum per-device collective traffic from post-SPMD HLO text."""
    stats = CollectiveStats()
    for line in hlo_text.splitlines():
        m = _COLL_RE.search(line)
        if not m:
            continue
        dtype, dims, op = m.groups()
        nbytes = _shape_bytes(dtype, dims)
        g = _GROUPS_RE.search(line)
        if g:
            group_size = int(g.group(2))
        else:
            gb = _GROUPS_BRACE_RE.search(line)
            group_size = len(gb.group(1).split(",")) if gb else 2
        n = max(group_size, 2)
        if op == "all-reduce":
            moved = 2.0 * (n - 1) / n * nbytes
        elif op == "all-gather":
            moved = (n - 1) / n * nbytes          # printed shape = output
        elif op == "reduce-scatter":
            moved = (n - 1) * nbytes              # printed shape = output (1/n)
        elif op == "all-to-all":
            moved = (n - 1) / n * nbytes
        else:                                     # collective-permute
            moved = nbytes
        stats.counts[op] = stats.counts.get(op, 0) + 1
        stats.by_op[op] = stats.by_op.get(op, 0.0) + moved
        stats.link_bytes += moved
        stats.raw_bytes += nbytes
    return stats


@dataclass
class GraphCost:
    flops: float = 0.0              # per device
    bytes_accessed: float = 0.0     # per device
    collectives: CollectiveStats = field(default_factory=CollectiveStats)

    def scaled(self, k: float) -> "GraphCost":
        c = CollectiveStats(dict(self.collectives.counts),
                            self.collectives.link_bytes * k,
                            self.collectives.raw_bytes * k,
                            {o: b * k for o, b in self.collectives.by_op.items()})
        return GraphCost(self.flops * k, self.bytes_accessed * k, c)

    def __add__(self, other: "GraphCost") -> "GraphCost":
        c = CollectiveStats(
            {o: self.collectives.counts.get(o, 0) + other.collectives.counts.get(o, 0)
             for o in set(self.collectives.counts) | set(other.collectives.counts)},
            self.collectives.link_bytes + other.collectives.link_bytes,
            self.collectives.raw_bytes + other.collectives.raw_bytes,
            {o: self.collectives.by_op.get(o, 0.0) + other.collectives.by_op.get(o, 0.0)
             for o in set(self.collectives.by_op) | set(other.collectives.by_op)})
        return GraphCost(self.flops + other.flops,
                         self.bytes_accessed + other.bytes_accessed, c)


# ------------------------------------------------------------- the trace

def trace_device() -> torch.device:
    """The device of the fake tensors: ``cuda:0`` where a card is present,
    else ``meta``.  Without a card fake CUDA tensors do not get through a
    step: a torch built without CUDA has no CUDA device guard (indexing
    raises), and with CUDA the autograd engine asks CUDA for device
    0's context (the backward raises).  The port's step functions branch on
    ``device.type == "cpu"`` only, so both trace the same program."""
    return torch.device("cuda", 0) if torch.cuda.is_available() \
        else torch.device("meta")


def _storage_key(t: torch.Tensor) -> int:
    return t.untyped_storage()._cdata


class _Traffic(TorchDispatchMode):
    """Bytes each aten op reads and writes, and the bytes of live storages:
    each storage is held by a weak reference and counted while it lives."""

    def __init__(self):
        super().__init__()
        self.bytes = 0
        self.live: Dict[int, Tuple[StorageWeakRef, int]] = {}
        self.live_bytes = 0      # an upper bound between sweeps
        self.peak = 0

    def sweep(self) -> None:
        for key in [k for k, (ref, _) in self.live.items() if ref.expired()]:
            self.live_bytes -= self.live.pop(key)[1]

    def track(self, t: torch.Tensor) -> None:
        s = t.untyped_storage()
        if s._cdata in self.live:   # a held weak reference pins the address
            return
        n = s.nbytes()
        self.live[s._cdata] = (StorageWeakRef(s), n)
        self.live_bytes += n
        if self.live_bytes > self.peak:
            self.sweep()
            self.peak = max(self.peak, self.live_bytes)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        ins = [t for t in tree_flatten((args, kwargs))[0]
               if isinstance(t, torch.Tensor)]
        outs = [t for t in tree_flatten(out)[0] if isinstance(t, torch.Tensor)]
        in_keys = {_storage_key(t) for t in ins}
        view = not func._schema.is_mutable and any(
            _storage_key(t) in in_keys for t in outs)
        if outs and not view:      # a query (``prim.device``) moves nothing
            self.bytes += sum(t.numel() * t.element_size() for t in ins + outs)
        for t in outs:
            self.track(t)
        return out


def _storage_bytes(tensors) -> Dict[int, int]:
    return {_storage_key(t): t.untyped_storage().nbytes() for t in tensors}


def trace_cost(fn: Callable[..., Any], *args: Any
               ) -> Tuple[GraphCost, Dict[str, int]]:
    """Run ``fn(*args)`` once on fake tensors and return its cost and
    memory.  ``args`` are trees (:mod:`repro_torch.tree`) whose tensor
    leaves give shapes, strides and dtypes (``meta`` tensors will do); each
    becomes a fake tensor on :func:`trace_device`; other leaves pass as
    they are.  Nothing is allocated on, or launched to, a card.

    Memory: ``args_bytes`` (the arguments' storages), ``output_bytes`` (the
    outputs' storages that are not arguments'), ``peak_bytes`` (the most
    bytes of storage alive at once, arguments included) and ``temp_bytes``
    (``peak - args - output``)."""
    dev = trace_device()
    traffic = _Traffic()
    # a constant the step makes on the trace device (``torch.tensor(b1,
    # device=...)``) is a plain ``meta`` tensor there: it joins as a fake
    with FakeTensorMode(allow_non_fake_inputs=True):
        fake = [tree_util.map(
            lambda t: torch.empty_strided(t.shape, t.stride(), dtype=t.dtype,
                                          device=dev)
            if isinstance(t, torch.Tensor) else t, a) for a in args]
        in_tensors = [t for a in fake for t in tree_util.leaves(a)
                      if isinstance(t, torch.Tensor)]
        arg_storages = _storage_bytes(in_tensors)
        for t in in_tensors:
            traffic.track(t)
        flops = FlopCounterMode(display=False)
        with flops, traffic:
            out = fn(*fake)
        out_tensors = [t for t in tree_util.leaves(out)
                       if isinstance(t, torch.Tensor)]
        new = {k: n for k, n in _storage_bytes(out_tensors).items()
               if k not in arg_storages}
    args_bytes = sum(arg_storages.values())
    output_bytes = sum(new.values())
    memory = {"args_bytes": args_bytes, "output_bytes": output_bytes,
              "temp_bytes": traffic.peak - args_bytes - output_bytes,
              "peak_bytes": traffic.peak}
    return GraphCost(float(flops.get_total_flops()), float(traffic.bytes),
                     CollectiveStats()), memory


# ------------------------------------------------------------- roofline

@dataclass
class Roofline:
    compute_s: float
    memory_s: float
    collective_s: float
    flops_per_dev: float
    bytes_per_dev: float
    link_bytes_per_dev: float
    model_flops: float              # analytic 6·N·D (global)
    hlo_total_flops: float          # per-dev flops × n_devices
    useful_ratio: float             # model_flops / hlo_total_flops
    bottleneck: str
    step_time_s: float              # max of the three terms (no overlap)
    mfu_bound: float                # model_flops / (chips·peak·step_time)

    def as_dict(self) -> Dict[str, Any]:
        return dict(self.__dict__)


def roofline_terms(total: GraphCost, n_devices: int, model_flops: float
                   ) -> Roofline:
    compute_s = total.flops / PEAK_FLOPS_BF16
    memory_s = total.bytes_accessed / HBM_BW
    collective_s = total.collectives.link_bytes / LINK_BW
    terms = {"compute": compute_s, "memory": memory_s,
             "collective": collective_s}
    bottleneck = max(terms, key=terms.get)
    step = max(terms.values())
    hlo_total = total.flops * n_devices
    return Roofline(
        compute_s=compute_s, memory_s=memory_s, collective_s=collective_s,
        flops_per_dev=total.flops, bytes_per_dev=total.bytes_accessed,
        link_bytes_per_dev=total.collectives.link_bytes,
        model_flops=model_flops, hlo_total_flops=hlo_total,
        useful_ratio=model_flops / hlo_total if hlo_total else 0.0,
        bottleneck=bottleneck, step_time_s=step,
        mfu_bound=(model_flops / (n_devices * PEAK_FLOPS_BF16 * step)
                   if step > 0 else 0.0),
    )


def analytic_model_flops(cfg, seq_len: int, global_batch: int, kind: str,
                         n_params: int, n_active: int) -> float:
    """6·N·D train / 2·N·D per forward-token (prefill & decode)."""
    if kind == "train":
        return 6.0 * n_active * seq_len * global_batch
    if kind == "prefill":
        return 2.0 * n_active * seq_len * global_batch
    return 2.0 * n_active * global_batch        # decode: one token per row
