"""Op cost model: flops, device-memory traffic, collective traffic and
per-device memory of one eager call, counted op by op as it dispatches.

The counterpart of ``repro/parallel/hlo_analysis.py``.  The reference parses
the compiled per-device HLO module; torch has no HLO and no compiler that
takes shardings, so :func:`analyze` runs the call once under a
``TorchDispatchMode`` (the *cost mode*) and counts every op that reaches the
dispatcher.  Run on meta tensors on rank 0 of a fake process group, it reads
the per-device program of a sharded step at any world size without a card:
shapes only, nothing computed.

Conventions (the reference's, where they carry over):

* **FLOPs** (``dot_flops``) — matrix products and convolutions only
  (2·M·N·K), the MFU convention, through ``torch.utils.flop_counter``'s
  registry (``mm``, ``addmm``, ``bmm``, ``baddbmm``, convolutions; an
  ``einsum`` or ``matmul`` reaches the dispatcher as those), plus each
  hand-written kernel op's own formula (``KERNEL_COSTS``: attention 4·D a
  pair, its backward 10·D, the scan 5·P·N a step and head, wkv6 its block
  form's flops).
  Elementwise ops are excluded.
* **Traffic** (``traffic_bytes``) — per op, its tensor operands' bytes plus
  its results' bytes.  In eager torch every op is its own kernel, so this is
  what the card moves; there are no fusions to count at the boundary of.
  Views, ``empty`` and metadata ops are free; an op that overwrites its
  first argument without reading it (``copy_``, ``fill_``, ``zero_``) does
  not count it as read; a kernel op counts its formula's bytes (inputs read
  once, outputs written once).
* **Converts** (``convert_traffic``) — the traffic of dtype casts
  (``_to_copy`` and ``copy_`` between dtypes).  On the card these are real
  kernels, so they stay in ``traffic_bytes`` too; nothing is subtracted.
* **Collectives** — per kind, ``count``, result ``bytes`` and ``traffic``
  (bytes × the reference's ``_COLL_MULT``: all-gather 1.0, all-reduce 2.0,
  reduce-scatter 1.0, all-to-all 1.0; send, recv and broadcast 1.0), for
  the ``c10d`` and ``_c10d_functional`` ops.  A result is the gathered,
  reduced or scattered tensor this rank holds after the op.
* **Memory** — the live bytes of every storage the call's tensors hold on
  this rank: the arguments' at the start (``argument_bytes``), each op's
  new results as they appear, each freed when its last tensor goes
  (storage weakrefs), and their peak (``peak_bytes``); ``output_bytes`` are
  the storages the result holds.  A kernel's scratch, allocated inside its
  launch, is not seen.

The cost mode reads the card's program on meta tensors only, and refuses
a tensor on the card (an argument, a DTensor's local shard or any op's
operand): there the wrappers launch their kernels directly, outside the
dispatcher, so the kernel ops would go uncounted.

All numbers are **per device**: the ops one rank dispatches.  Ops on a
tensor subclass (a ``DTensor``) are handed to it and counted as the ops on
local tensors it runs.

Fields of the reference with no counterpart, not faked:

* ``while_trips`` and ``unknown_trip_whiles`` — eager Python unrolls every
  loop (the layers, the microbatches), so each iteration's ops are counted
  as they run; there is no loop body to multiply.
* ``collective_traffic_raw`` and the TPU dtype correction — the reference
  corrects for the XLA CPU backend's float32 upcast of bf16 dots; here
  every collective runs at the dtype the program gives it.
* ``xla_cost_analysis`` and fusion-boundary traffic — there is no compiler
  and no fusion.
"""

from __future__ import annotations

import threading
import weakref
from collections import Counter
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, Tuple

import torch
from torch.distributed.tensor import DTensor
from torch.utils import _pytree as pytree
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

from ..kernels import flash_attention, rwkv6, ssm_scan

_COLL_MULT = {
    "all-gather": 1.0,
    "all-reduce": 2.0,
    "reduce-scatter": 1.0,
    "all-to-all": 1.0,
    "broadcast": 1.0,
    "send": 1.0,
    "recv": 1.0,
}

# functional collectives return their result; the c10d ops write it into
# their first argument
_FUNCTIONAL_COLLECTIVES = {
    "_c10d_functional::all_gather_into_tensor": "all-gather",
    "_c10d_functional::all_reduce": "all-reduce",
    "_c10d_functional::reduce_scatter_tensor": "reduce-scatter",
    "_c10d_functional::all_to_all_single": "all-to-all",
    "_c10d_functional::broadcast": "broadcast",
}
_C10D_COLLECTIVES = {
    "c10d::allreduce_": "all-reduce",
    "c10d::allgather_": "all-gather",
    "c10d::_allgather_base_": "all-gather",
    "c10d::reduce_scatter_": "reduce-scatter",
    "c10d::_reduce_scatter_base_": "reduce-scatter",
    "c10d::alltoall_": "all-to-all",
    "c10d::alltoall_base_": "all-to-all",
    "c10d::broadcast_": "broadcast",
    "c10d::send": "send",
    "c10d::recv_": "recv",
}

# ops that move no device memory (views are found by their schema)
_FREE_OPS = {
    "aten::empty", "aten::empty_like", "aten::empty_strided", "aten::new_empty",
    "aten::new_empty_strided", "aten::detach", "aten::alias", "aten::lift_fresh",
    "aten::_unsafe_view", "aten::set_", "aten::resize_", "aten::is_same_size",
    "aten::sym_size", "aten::sym_stride", "aten::sym_numel", "aten::sym_storage_offset",
    "_c10d_functional::wait_tensor", "_c10d_functional::_wrap_tensor_autograd",
}
# ops that overwrite their first argument without reading it
_WRITE_ONLY = {"aten::copy_", "aten::fill_", "aten::zero_"}

#: flops and bytes of one call of each hand-written kernel op
KERNEL_COSTS: Dict[Any, Tuple[str, Callable]] = {
    flash_attention.OP: ("flash_attention", flash_attention.op_cost),
    flash_attention.OP_BWD: ("flash_attention_bwd", flash_attention.op_cost_bwd),
    ssm_scan.OP: ("ssm_scan_chunked", ssm_scan.op_cost),
    rwkv6.OP: ("rwkv6_chunked", rwkv6.op_cost),
}


@dataclass
class OpCost:
    dot_flops: float = 0.0
    traffic_bytes: float = 0.0
    convert_traffic: float = 0.0
    collective_traffic: float = 0.0
    collectives: Dict[str, Dict[str, float]] = field(default_factory=dict)
    kernel_ops: Dict[str, int] = field(default_factory=dict)   # calls per kernel op
    kernel_flops: float = 0.0                                  # their part of dot_flops
    ops: Counter = field(default_factory=Counter)              # calls per op name
    argument_bytes: int = 0
    output_bytes: int = 0
    peak_bytes: int = 0
    result: Any = field(default=None, repr=False)


def _tensors(tree):
    return [t for t in pytree.tree_leaves(tree) if isinstance(t, torch.Tensor)]


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _local(t: torch.Tensor) -> torch.Tensor:
    """The tensor this rank holds: a DTensor's local shard, else ``t``."""
    return t.to_local() if isinstance(t, DTensor) else t


def _refuse_cuda(tensors) -> None:
    if any(t.device.type == "cuda" for t in tensors):
        raise ValueError("cost mode: a tensor is on the card; the cost mode counts the card's "
                         "program on meta tensors only (on the card the kernels launch outside "
                         "the dispatcher and would go uncounted)")


class _LiveBytes:
    """Bytes of the live storages among the tensors shown to :meth:`add`,
    each counted once and dropped when its storage is freed, and their
    peak."""

    def __init__(self):
        self.live = 0
        self.peak = 0
        self._sizes: Dict[int, int] = {}
        # a storage may be freed on another thread, or by a garbage collection
        # that runs inside add() on this one
        self._lock = threading.RLock()

    def add(self, t: torch.Tensor) -> None:
        st = t.untyped_storage()
        key, n = st._cdata, st.nbytes()
        with self._lock:
            old = self._sizes.get(key)
            if old is None:
                weakref.finalize(st, self._drop, key)
                old = 0
            elif old >= n:
                return
            self._sizes[key] = n
            self.live += n - old
            self.peak = max(self.peak, self.live)

    def _drop(self, key: int) -> None:
        with self._lock:
            self.live -= self._sizes.pop(key, 0)


class _CostMode(TorchDispatchMode):
    """Counts every op dispatched while it is active into :attr:`cost` (see
    the module's conventions) and tracks the live storages in :attr:`mem`."""

    def __init__(self):
        super().__init__()
        self.cost = OpCost()
        self.mem = _LiveBytes()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        inputs = _tensors((args, kwargs))
        _refuse_cuda(inputs)
        if any(t is not torch.Tensor and issubclass(t, torch.Tensor) for t in types):
            return NotImplemented        # a DTensor runs its local ops, counted here
        out = func(*args, **kwargs)
        name = func._schema.name
        c = self.cost
        c.ops[name] += 1
        results = _tensors(out)
        for t in results:
            self.mem.add(t)
        if func.is_view or name in _FREE_OPS:
            return out
        if func in KERNEL_COSTS:
            kname, cost_fn = KERNEL_COSTS[func]
            flops, nbytes = cost_fn(*args, **kwargs)
            c.kernel_ops[kname] = c.kernel_ops.get(kname, 0) + 1
            c.kernel_flops += flops
            c.dot_flops += flops
            c.traffic_bytes += nbytes
            return out
        if func.overloadpacket in flop_registry:
            c.dot_flops += flop_registry[func.overloadpacket](*args, **kwargs, out_val=out)
        read = inputs[1:] if name in _WRITE_ONLY else inputs
        nbytes = sum(map(_nbytes, read)) + sum(map(_nbytes, results))
        c.traffic_bytes += nbytes
        if name == "aten::_to_copy" and results and inputs and results[0].dtype != inputs[0].dtype:
            c.convert_traffic += nbytes
        elif name == "aten::copy_" and inputs[0].dtype != inputs[1].dtype:
            c.convert_traffic += nbytes
        if name in _FUNCTIONAL_COLLECTIVES:
            self._collective(_FUNCTIONAL_COLLECTIVES[name], results)
        elif name in _C10D_COLLECTIVES:
            self._collective(_C10D_COLLECTIVES[name], _tensors(args[0]))
        return out

    def _collective(self, kind: str, results) -> None:
        rb = float(sum(map(_nbytes, results)))
        st = self.cost.collectives.setdefault(kind, {"count": 0.0, "bytes": 0.0, "traffic": 0.0})
        st["count"] += 1
        st["bytes"] += rb
        st["traffic"] += rb * _COLL_MULT[kind]
        self.cost.collective_traffic += rb * _COLL_MULT[kind]


def analyze(fn: Callable, *args, **kwargs) -> OpCost:
    """Run ``fn(*args, **kwargs)`` once under the cost mode.  Returns its
    :class:`OpCost`, with ``result`` holding what ``fn`` returned.  The
    arguments' tensors (a DTensor's local shards) are live from the start;
    ``peak_bytes`` includes them.  Raises ``ValueError`` on a tensor on the
    card."""
    mode = _CostMode()
    local = [_local(t) for t in _tensors((args, kwargs))]
    _refuse_cuda(local)
    for t in local:
        mode.mem.add(t)
    cost = mode.cost
    cost.argument_bytes = mode.mem.live
    with mode:
        out = fn(*args, **kwargs)
    seen: Dict[int, int] = {}
    for t in _tensors(out):
        st = _local(t).untyped_storage()
        seen[st._cdata] = st.nbytes()
    cost.output_bytes = sum(seen.values())
    cost.peak_bytes = mode.mem.peak
    cost.result = out
    return cost


def op_histogram(fn: Callable, *args, top: int = 25, **kwargs) -> Dict[str, int]:
    """The ``top`` most dispatched ops of one call of ``fn``, by count."""
    return dict(analyze(fn, *args, **kwargs).ops.most_common(top))
