"""FLOPs, bytes and memory of one step, counted over the aten ops it runs.

Port of ``repro.launch.hlo_cost``.  The reference walks the compiled HLO
text of a step and multiplies a loop body by its trip count.  The port
runs the step eagerly under a ``TorchDispatchMode`` (`step_cost`) and
counts each aten op as it runs, on meta, CPU or CUDA tensors alike: an
eager loop runs every iteration, which is the trip-count walk's
counterpart.  On the meta device a full-size step allocates nothing.

Counting rules, the reference's (``hlo_cost.py``):

* FLOPs: a contraction (``mm``, ``bmm``, ``addmm``, ``baddbmm``,
  ``convolution``) counts 2 x numel(result) x the contracted size;
  elementwise and reduce ops count numel(result); transcendentals count 1
  per element.
* Bytes, two conventions side by side:
    - ``bytes`` (unfused): operands + result of every op;
    - ``bytes_fused`` (the fusion model): elementwise, convert and view
      chains are free (they ride in registers); matmul IO, reduction
      outputs, layout-changing copies (a copy of a non-contiguous tensor,
      gather and index reads, scatter and ``index_put_`` writes, ``cat``)
      and collectives count.
  A slice read counts its result: a view moves nothing, and the op that
  reads it counts the slice's bytes.  A write into a slice (``copy_``
  into a view, ``index_put_``) counts 2 x the update, not the buffer.
  Bookkeeping (views, allocations, factories) is free.
* Collectives: the rank loop's transfers (`repro_torch.launch.op_stats`)
  with its byte conventions.
* Kernels: a hand-written kernel's ctypes launch is not an aten op and
  costs zero here, as a ``custom-call`` does in the reference; the record
  lists the launches by kernel (``kernel_launches``, from the wrappers'
  launch counters) so that a reader sees what went uncounted.

Memory: the bytes of the arguments' storages, of the outputs' (``alias``:
output storage that is an argument's, written in place), and the peak of
the storages the run allocated and had not yet freed (``peak_temp_bytes``;
a storage is freed when its last reference, autograd's saved tensors
included, goes).
"""

from __future__ import annotations

import dataclasses
import math
import weakref

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.launch import op_stats

_TRANSCENDENTAL = {
    "exp", "exp2", "expm1", "log", "log1p", "log2", "tanh", "rsqrt", "sqrt",
    "pow", "cos", "sin", "sigmoid", "erf", "silu", "gelu", "softplus",
    "_softmax", "_log_softmax", "logsumexp", "reciprocal"}
_CONTRACTIONS = {"mm", "bmm", "addmm", "baddbmm", "convolution", "dot", "mv"}
# reads of a gathered index set (the reference's gather: 2 x result)
_GATHERS = {"index", "index_select", "gather", "embedding", "take",
            "take_along_dim"}
# writes of an update into a buffer (2 x the update)
_SCATTERS = {"index_put", "index_put_", "scatter", "scatter_", "scatter_add",
             "scatter_add_", "index_add", "index_add_", "index_copy",
             "index_copy_", "copy_", "masked_scatter", "masked_scatter_",
             "embedding_dense_backward"}
_MATERIALIZE = {"cat", "constant_pad_nd"}
_SORTS = {"sort", "topk", "argsort"}
_CONVERTS = {"_to_copy", "clone", "lift_fresh_copy"}
_FREE = {
    "empty", "empty_like", "empty_strided", "new_empty", "new_empty_strided",
    "zeros", "zeros_like", "new_zeros", "ones", "ones_like", "new_ones",
    "full", "full_like", "new_full", "arange", "scalar_tensor",
    "lift_fresh", "_local_scalar_dense", "detach", "alias", "set_",
    "resize_", "_unsafe_view", "view", "expand", "as_strided", "unsqueeze",
    "squeeze", "permute", "transpose", "t", "slice", "select", "split",
    "split_with_sizes", "unbind", "chunk", "narrow", "reshape",
    "_reshape_alias", "unfold", "diagonal", "expand_as", "view_as",
    "record_stream", "is_same_size", "fill_", "zero_", "fill"}
_REDUCTION = getattr(torch.Tag, "reduction", None)


def _nbytes(t) -> int:
    return t.numel() * t.element_size()


def _tensors(x) -> list:
    if isinstance(x, torch.Tensor):
        return [x]
    if isinstance(x, (list, tuple)):
        return [t for v in x for t in _tensors(v)]
    if isinstance(x, dict):
        return [t for v in x.values() for t in _tensors(v)]
    return []


@dataclasses.dataclass
class ModuleCost:
    flops: float = 0.0
    bytes: float = 0.0            # unfused: every op's operands+results
    bytes_fused: float = 0.0      # the fusion model: module docstring
    transcendentals: float = 0.0
    collective_bytes: dict[str, float] = dataclasses.field(
        default_factory=dict)
    collective_counts: dict[str, float] = dataclasses.field(
        default_factory=dict)
    collective_raw_bytes: dict[str, float] = dataclasses.field(
        default_factory=dict)
    # (op, type_str, trips) -> total weighted bytes; top contributors
    collective_detail: dict[tuple, float] = dataclasses.field(
        default_factory=dict)
    # (op, type_str) -> total fused bytes (diagnostic breakdown)
    bytes_detail: dict[tuple, float] = dataclasses.field(default_factory=dict)
    # aten op -> calls, for every op the walk saw
    op_counts: dict[str, int] = dataclasses.field(default_factory=dict)
    # contraction op -> its FLOPs (the products alone, bias adds apart)
    contraction_flops: dict[str, float] = dataclasses.field(
        default_factory=dict)
    # hand-written kernel -> launches during the run (counted as zero)
    kernel_launches: dict[str, int] = dataclasses.field(default_factory=dict)
    argument_bytes: int = 0
    output_bytes: int = 0
    alias_bytes: int = 0
    peak_temp_bytes: int = 0

    @property
    def total_collective_bytes(self) -> float:
        return sum(self.collective_bytes.values())

    def top_collectives(self, k: int = 12) -> list[tuple]:
        return sorted(self.collective_detail.items(),
                      key=lambda kv: -kv[1])[:k]

    def top_bytes(self, k: int = 12) -> list[tuple]:
        return sorted(self.bytes_detail.items(), key=lambda kv: -kv[1])[:k]

    # ---- what the walk and the rank loop report --------------------------

    def _fused(self, op: str, out, nbytes: float):
        self.bytes_fused += nbytes
        key = (op, op_stats.tensor_type(out) if out is not None else "")
        self.bytes_detail[key] = self.bytes_detail.get(key, 0.0) + nbytes

    def collective(self, op, result_bytes, operand_bytes, type_str):
        nb = op_stats.weighted_bytes(op, result_bytes, operand_bytes)
        self.collective_bytes[op] = self.collective_bytes.get(op, 0.0) + nb
        self.collective_counts[op] = self.collective_counts.get(op, 0.0) + 1
        self.collective_raw_bytes[op] = (
            self.collective_raw_bytes.get(op, 0.0) + result_bytes)
        key = (op, type_str, 1)
        self.collective_detail[key] = self.collective_detail.get(key, 0.0) + nb
        self.bytes += 2 * result_bytes            # they also touch HBM
        self.bytes_fused += 2 * result_bytes
        dkey = (op, type_str)
        self.bytes_detail[dkey] = (self.bytes_detail.get(dkey, 0.0)
                                   + 2 * result_bytes)

    def count(self, func, args, kwargs, out):
        name = func.overloadpacket.__name__
        self.op_counts[name] = self.op_counts.get(name, 0) + 1
        if name in _FREE or func.is_view:
            return
        ins = _tensors(args) + _tensors(kwargs)
        outs = _tensors(out)
        first = outs[0] if outs else None
        rb = sum(_nbytes(t) for t in outs)
        rn = sum(t.numel() for t in outs)
        ob = sum(_nbytes(t) for t in ins)
        if name in _CONTRACTIONS:
            f = _contraction_flops(name, ins, first)
            self.flops += f
            self.contraction_flops[name] = (
                self.contraction_flops.get(name, 0.0) + f)
            if name in ("addmm", "baddbmm"):
                self.flops += rn                   # the bias add
            self.bytes += ob + rb
            self._fused(name, first, ob + rb)      # matmul IO always real
        elif name in _SCATTERS:
            upd = _update_bytes(name, args, kwargs)
            self.bytes += 2 * upd
            self._fused(name, first, 2 * upd)
        elif name in _GATHERS or name in _SORTS:
            self.bytes += 2 * rb
            self._fused(name, first, 2 * rb)       # these do materialize
        elif name in _MATERIALIZE:
            self.bytes += rb
            self._fused(name, first, rb)
        elif name in _CONVERTS:
            # a convert or a copy fuses into its consumer unless it changes
            # the layout (a transposed tensor made contiguous)
            src = args[0] if args and isinstance(args[0], torch.Tensor) else None
            self.bytes += 2 * rb if name == "clone" else rb
            if src is not None and not src.is_contiguous() and src.numel() > 1:
                self._fused(name, first, 2 * rb)
        elif ((_REDUCTION is not None and _REDUCTION in func.tags)
              or name in ("_softmax", "_log_softmax", "cumsum",
                          "nll_loss_forward", "nll_loss2d_forward")):
            if name in ("_softmax", "_log_softmax"):
                # max, subtract, exp, sum, divide over the input
                self.flops += 3 * rn
                self.transcendentals += rn
            else:
                self.flops += rn
                if name in _TRANSCENDENTAL:
                    self.transcendentals += rn
            self.bytes += ob + rb
            self._fused(name, first, rb)           # input fused into producer
        else:
            # elementwise / compare / select / rng / a backward of one
            if name in _TRANSCENDENTAL:
                self.transcendentals += rn
            self.flops += rn
            self.bytes += ob + rb
            # fused model: elementwise chains ride in registers


def _contraction_flops(name, ins, out) -> float:
    if out is None:
        return 0.0
    if name == "convolution":
        w = ins[1]                      # (out, in / groups, *kernel)
        return 2.0 * out.numel() * (w.shape[1] * math.prod(w.shape[2:]))
    a = ins[1] if name in ("addmm", "baddbmm") else ins[0]
    return 2.0 * out.numel() * a.shape[-1]


def _update_bytes(name, args, kwargs) -> int:
    """The bytes an in-place write moves: the update's, not the buffer's."""
    if name in ("index_put", "index_put_"):
        upd = args[2] if len(args) > 2 else kwargs["values"]
    elif name == "embedding_dense_backward":
        upd = args[0]                            # the lookup's gradient
    elif name == "copy_":
        dst, src = args[0], args[1]
        return _nbytes(dst) if dst.numel() <= src.numel() else _nbytes(src)
    elif name.startswith(("scatter", "index_add", "index_copy")):
        upd = args[3] if len(args) > 3 else kwargs.get("src", args[-1])
    else:                                        # masked_scatter
        upd = args[2]
    if not isinstance(upd, torch.Tensor):
        return 0
    return _nbytes(upd)


class _Live:
    """The bytes of the storages a run allocated that are still alive, and
    their peak.  A storage's Python object lives as long as its storage
    (PyTorch keeps it), so a finalizer on it fires when the last tensor,
    autograd's saved ones included, lets go."""

    def __init__(self, known):
        self.known = set(known)
        self.live = 0
        self.peak = 0

    def _free(self, key, nbytes):
        self.known.discard(key)
        self.live -= nbytes

    def add(self, t):
        st = t.untyped_storage()
        key = id(st)
        if key in self.known:
            return
        nb = st.nbytes()
        self.known.add(key)
        self.live += nb
        self.peak = max(self.peak, self.live)
        weakref.finalize(st, self._free, key, nb)


class _Walk(TorchDispatchMode):
    def __init__(self, cost: ModuleCost, live: _Live):
        super().__init__()
        self.cost = cost
        self.live = live

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        self.cost.count(func, args, kwargs, out)
        for t in _tensors(out):
            self.live.add(t)
        return out


def _wrappers():
    """The hand-written kernels' wrappers (each counts its launches)."""
    from repro_torch.kernels.decode_attention.ops import decode_attention
    from repro_torch.kernels.flash_attention.ops import flash_attention
    from repro_torch.kernels.grouped_matmul.ops import grouped_matmul
    from repro_torch.kernels.paged_attention.ops import (
        paged_decode_attention, paged_verify_attention)
    from repro_torch.kernels.rmsnorm.ops import rmsnorm_fused
    from repro_torch.kernels.ssd_scan.ops import ssd_scan
    return (decode_attention, flash_attention, grouped_matmul,
            paged_decode_attention, paged_verify_attention, rmsnorm_fused,
            ssd_scan)


def _storages(x) -> dict:
    """{storage id: bytes} of the tensors in ``x`` (trees, params objects
    and `Shards` parts included), each storage once."""
    out = {}
    for t in _leaf_tensors(x):
        st = t.untyped_storage()
        out[id(st)] = st.nbytes()
    return out


def _leaf_tensors(x) -> list:
    from repro_torch.runtime.sharding import Shards, Whole, as_tree, parts

    def walk(t):
        if isinstance(t, (Shards, Whole)):
            return list(parts(t))
        if isinstance(t, dict):
            t = list(t.values())
        if isinstance(t, (list, tuple)):
            return [p for v in t for p in walk(v)]
        return _tensors(t)
    return walk(as_tree(x))


def step_cost(fn, *args, **kwargs):
    """``(fn(*args, **kwargs), ModuleCost)``: the step run once with every
    aten op it dispatches counted (module docstring)."""
    wrappers = _wrappers()
    before = {w.__name__: w.launches for w in wrappers}
    cost = ModuleCost()
    arg_storages = _storages(list(args) + list(kwargs.values()))
    live = _Live(arg_storages)
    with op_stats.recording(cost), _Walk(cost, live):
        out = fn(*args, **kwargs)
    cost.kernel_launches = {w.__name__: w.launches - before[w.__name__]
                            for w in wrappers
                            if w.launches != before[w.__name__]}
    cost.argument_bytes = sum(arg_storages.values())
    outs = _storages(out)
    cost.output_bytes = sum(outs.values())
    cost.alias_bytes = sum(b for k, b in outs.items() if k in arg_storages)
    cost.peak_temp_bytes = live.peak
    return out, cost
