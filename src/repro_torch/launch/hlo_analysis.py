"""Roofline terms of a step, counted from the ATen ops it dispatches.

The counterpart of the reference's ``launch/hlo_analysis.py``, which reads
XLA's ``cost_analysis()`` and the optimized per-device HLO.  Eager
PyTorch compiles no program, so there is no HLO here: :class:`OpMeter`
is a ``TorchDispatchMode`` that counts the ATen ops one rank dispatches.
On DTensors it returns ``NotImplemented`` (as ``CommDebugMode`` does), so
DTensor lowers each op first and the meter sees rank 0's local program:
its ops at local shard shapes and the ``_c10d_functional`` collectives
that DTensor inserts, the counterpart of XLA's per-device module.  Steps
run on meta tensors, so nothing is allocated or computed.

What is counted, per op:

* **FLOPs**: ``torch.utils.flop_counter``'s formula for the op (matmuls,
  convolutions, attention), on the local shapes; every other op counts 0.
* **Bytes**: each tensor argument read once (its distinct elements: a
  broadcast dim of stride 0 counts once) plus each tensor result written
  once.  Views and aliases (``func.is_view``: ``view``, ``t``,
  ``expand``, ``split``, ``chunk``, ``detach``, ...; and
  ``_unsafe_view``, ``_wrap_tensor_autograd``, ``wait_tensor``) and
  allocations (``empty``, ``empty_like``, ``empty_strided``,
  ``new_empty``) move 0 bytes.  An in-place
  op reads and writes its target.  Ops run eagerly and unfused, so this is
  an upper bound on what XLA's fused program moves.
* **Collective bytes**: the result's bytes on this rank times the ring
  factor of its kind (the reference's ``_WIRE_FACTOR``), for
  ``all_reduce``, ``all_gather_into_tensor``, ``reduce_scatter_tensor``
  and ``all_to_all_single`` (their in-place, coalesced and autograd
  forms).  Collectives count here and not under bytes.  Any other c10d op
  raises, so none is dropped silently.

:func:`roofline_from_count` globalizes by ``chips`` as the reference's
``roofline_from_compiled`` does, so the three terms divide by
``chips x`` one card's rate.

Rates of one NVIDIA H100 80GB HBM3 (SXM) at its 700 W power limit, from
NVIDIA's H100 data sheet (dense, without sparsity):

* ``PEAK_FLOPS`` 989 TFLOP/s in bf16;
* ``HBM_BW`` 3.35 TB/s;
* ``NET_BW`` 50 GB/s per GPU: one 400 Gb/s NDR InfiniBand port per GPU,
  as in a DGX H100.  Both axes of a 16x16 mesh cross 8-GPU nodes, so the
  collective term takes the network rate; NVLink's 450 GB/s per
  direction holds only inside a node.
"""

from __future__ import annotations

import math
from collections import Counter
from dataclasses import dataclass, field

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

PEAK_FLOPS = 989e12  # bf16 dense, per GPU
HBM_BW = 3.35e12  # B/s per GPU
NET_BW = 50e9  # B/s per GPU, one 400 Gb/s NDR port

# ring-algorithm wire factor per byte of per-device buffer
_WIRE_FACTOR = {
    "all-reduce": 2.0,  # reduce-scatter + all-gather phases
    "all-gather": 1.0,
    "reduce-scatter": 1.0,
    "all-to-all": 1.0,
    "collective-permute": 1.0,
}

_C10D = ("_c10d_functional", "_c10d_functional_autograd", "c10d")
_COLLECTIVES = {
    "all_reduce": "all-reduce",
    "all_reduce_": "all-reduce",
    "all_reduce_coalesced": "all-reduce",
    "all_reduce_coalesced_": "all-reduce",
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_out": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "all_to_all_single": "all-to-all",
}
_ALIASES = {
    "aten::_unsafe_view",
    "aten::empty",
    "aten::empty_like",
    "aten::empty_strided",
    "aten::new_empty",
    "aten::new_empty_strided",
    "_c10d_functional::wait_tensor",
    "_c10d_functional::_wrap_tensor_autograd",
}


def _read_bytes(t: torch.Tensor) -> int:
    """Bytes of ``t``'s distinct elements (a dim of stride 0 counts once)."""
    n = math.prod(s for s, st in zip(t.shape, t.stride()) if st != 0)
    return n * t.element_size()


def _tensors(tree) -> list[torch.Tensor]:
    return [x for x in tree_leaves(tree) if isinstance(x, torch.Tensor)]


@dataclass
class CollectiveStats:
    """Per-device wire bytes by collective kind (result-shard sizes x ring
    factor)."""

    bytes_by_kind: dict[str, int] = field(default_factory=dict)
    count_by_kind: dict[str, int] = field(default_factory=dict)

    @property
    def total_bytes(self) -> int:
        return sum(self.bytes_by_kind.values())

    @property
    def total_count(self) -> int:
        return sum(self.count_by_kind.values())


@dataclass
class RooflineTerms:
    flops: float
    bytes_accessed: float
    collective_bytes: float
    chips: int
    collective_detail: dict = field(default_factory=dict)

    @property
    def compute_s(self) -> float:
        return self.flops / (self.chips * PEAK_FLOPS)

    @property
    def memory_s(self) -> float:
        return self.bytes_accessed / (self.chips * HBM_BW)

    @property
    def collective_s(self) -> float:
        return self.collective_bytes / (self.chips * NET_BW)

    @property
    def dominant(self) -> str:
        terms = {
            "compute": self.compute_s,
            "memory": self.memory_s,
            "collective": self.collective_s,
        }
        return max(terms, key=terms.get)

    @property
    def bound_s(self) -> float:
        return max(self.compute_s, self.memory_s, self.collective_s)

    def as_dict(self) -> dict:
        return {
            "flops": self.flops,
            "bytes_accessed": self.bytes_accessed,
            "collective_bytes": self.collective_bytes,
            "chips": self.chips,
            "compute_s": self.compute_s,
            "memory_s": self.memory_s,
            "collective_s": self.collective_s,
            "dominant": self.dominant,
            "collective_detail": self.collective_detail,
        }


class OpMeter(TorchDispatchMode):
    """Counts one rank's dispatched ops: ``flops``, ``bytes``, ``ops``
    (every op seen, views included), ``by_op`` (ops per overload name) and
    ``collectives``.  Use as a context manager around one step."""

    def __init__(self):
        super().__init__()
        from torch.distributed.tensor import DTensor
        from torch.utils.flop_counter import flop_registry

        self._dtensor = DTensor
        self._flops = flop_registry
        self.flops = 0
        self.bytes = 0
        self.ops = 0
        self.by_op: Counter = Counter()
        self.collectives = CollectiveStats()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if any(issubclass(t, self._dtensor) for t in types):
            return NotImplemented  # let DTensor lower it to local ops first
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        self._count(func, args, kwargs, out)
        return out

    def _count(self, func, args, kwargs, out) -> None:
        packet = func._overloadpacket
        name = func._schema.name  # "aten::mm"
        self.ops += 1
        self.by_op[str(func)] += 1
        namespace, _, op = name.partition("::")
        if namespace in _C10D and name not in _ALIASES:
            kind = _COLLECTIVES.get(op)
            if kind is None:
                raise ValueError(f"unmetered collective {func}")
            nbytes = int(sum(t.numel() * t.element_size() for t in _tensors(out)) * _WIRE_FACTOR[kind])
            c = self.collectives
            c.bytes_by_kind[kind] = c.bytes_by_kind.get(kind, 0) + nbytes
            c.count_by_kind[kind] = c.count_by_kind.get(kind, 0) + 1
            return
        if packet in self._flops:
            self.flops += int(self._flops[packet](*args, **kwargs, out_val=out))
        if func.is_view or name in _ALIASES:
            return
        self.bytes += sum(_read_bytes(t) for t in _tensors((args, kwargs)))
        self.bytes += sum(t.numel() * t.element_size() for t in _tensors(out))

    def terms(self, chips: int) -> RooflineTerms:
        """This rank's counts globalized by ``chips``."""
        c = self.collectives
        return RooflineTerms(
            flops=float(self.flops) * chips,
            bytes_accessed=float(self.bytes) * chips,
            collective_bytes=float(c.total_bytes) * chips,
            chips=chips,
            collective_detail={"bytes": dict(c.bytes_by_kind), "count": dict(c.count_by_kind)},
        )


def count_step(step, args) -> OpMeter:
    """One call of ``step(*args)`` under a fresh :class:`OpMeter`."""
    meter = OpMeter()
    with meter:
        step(*args)
    return meter


def roofline_from_count(step, args, chips: int) -> RooflineTerms:
    """The counterpart of ``roofline_from_compiled``: ``step(*args)`` runs
    once uncounted, then once counted on this rank, globalized by
    ``chips``.  The first call of a step does work no later call repeats:
    DTensor infers each op signature's sharding (running ops at global
    shapes, or a decomposition at local ones) and caches it, and the RoPE
    table is copied to the device once.  The caller holds the mesh
    context the step needs."""
    step(*args)
    return count_step(step, args).terms(chips)


def model_flops(cfg, shape, params_total: int, params_active: int) -> float:
    """6·N·D for train (N = active params, D = tokens); 2·N·B for decode."""
    tokens = shape.global_batch * shape.seq_len
    n = params_active
    if shape.kind == "train":
        return 6.0 * n * tokens
    if shape.kind == "prefill":
        return 2.0 * n * tokens
    return 2.0 * n * shape.global_batch  # decode: one token per sequence
