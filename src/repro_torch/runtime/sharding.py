"""Serve-path tensor parallelism of the port: the partition rules and the
rank loop's placements.

Port of the serve half of ``repro.runtime.sharding``.  The rules are the
reference's: one table maps each parameter leaf name to its
(tensor-parallel dim, FSDP dim) pair in negative indexing; serving splits
only the COLUMN-parallel leaves (`_SERVE_TP_SAFE`: their TP dim is an
output dim of the forward product, so each rank's outputs are the
single-device outputs' slice) and the KV pools on their head or latent
dim; a rule falls back to replication when the model axis does not divide
the dim.  `serve_param_shardings` and `serve_state_shardings` return the
split dim of each leaf (None: replicated) where the reference returns a
``NamedSharding``; `serve_param_shard_factor` and
`serve_state_shard_factor` are its pure mirrors.

The reference runs one SPMD program and lets GSPMD place each op; the port
runs one process over a `DeviceMesh` and loops over the model ranks inside
each layer.  A split leaf is a `Shards` (one part per rank, on the rank's
device); a replicated one stays one tensor on the lead device (rank 0's),
which both ranks read when they share it.  `on_ranks` is the loop: it
runs a function once per rank on the ranks' parts, or once on the lead
device when nothing is split.  `gather` is the counterpart of the
reference's ``constrain_replicated``: it concatenates the parts onto the
lead device before every product whose contraction dim was split (the
out-projection over heads, the MLP's ``down`` over d_ff, MLA's score over
the latent), so the product runs whole, in the single-device engine's
order, and the tokens stay bitwise the single-device engine's.

A column slice of a product is not always bitwise the whole product's
slice: the library may pick another algorithm (another split of the
contraction) for another width.  `shard_params` checks each column leaf at
the row counts its engine multiplies by (`slices_exact`; for an MoE
``up``/``gate``, the decode product and the capacity-bucket products the
engine runs) and keeps a leaf that differs whole on the lead device, as a
`Whole`: `on_ranks` runs its product there and splits the output over the
ranks.

The data axis of a serve mesh is the reference's replication headroom:
slots are not batch-sharded.  The rank loop runs on data row 0; every
other data row holds a copy of row 0's placement of the params
(`replicate`, `ShardedParams.replicas`) and of the decode state
(`state_replicas`), so each device holds the bytes the dry run predicts.
The one thing the reference computes over the data axis is MoE decode
expert parallelism (its ``constrain(h, "..dm")``): each data row computes
its slice of the experts from its own copy (`Experts`), where the slices
are bitwise (`experts_exact`).

The train half (``param_spec``, ``param_shardings``, ``batch_shardings``,
``decode_state_shardings``, ``train_state_shardings``, ``constrain``) is
the reference's rules over a `MeshSpec` (or a `DeviceMesh`, or any object
with ``axis_names`` and ``devices.shape``, as a JAX mesh has): TP on the
model axis plus FSDP (ZeRO-3) over the batch axes for params and moments
in "train" mode, TP only in "serve" mode, batch over ("pod", "data"), and
under the "fsdp" layout the model axis folded into the batch.  A spec is
a plain tuple with one entry per dim (None, an axis name, or a tuple of
names) where the reference builds a ``PartitionSpec``; an unruled leaf's
is ``()``, as ``P()``.  No process runs them on devices: the dry run
(`repro_torch.launch.dryrun`) divides each leaf's bytes by
`spec_shard_factor` of its spec.  `constrain` resolves an activation's
spec as the reference does and returns the tensor itself: the port places
tensors explicitly and has no partitioner to hand a constraint to.

The rank loop's transfers (`gather`, `split`, the per-rank moves of
`on_ranks`) are reported to `repro_torch.launch.op_stats` as they happen,
so a step counted by `repro_torch.launch.op_cost` counts them as
collectives.
"""

from __future__ import annotations

import threading
from contextlib import contextmanager

import torch

from repro_torch.launch import op_stats
from repro_torch.runtime.mesh import (
    DATA_AXIS, MODEL_AXIS, DeviceMesh, MeshSpec, batch_axes, mesh_axis_size)


# --------------------------------------------------------------------------
# parameter rules: name -> (tp_dim, fsdp_dim), negative indices
# --------------------------------------------------------------------------

_PARAM_RULES: dict[str, tuple[int | None, int | None]] = {
    "embed":    (-2, -1),   # (V, D): vocab over model, D FSDP
    "head":     (-1, -2),   # (D, V)
    "wq":       (-2, -3),   # (..., D, H, Dh)
    "wk":       (-2, -3),
    "wv":       (-2, -3),
    "wo":       (-3, -1),   # (..., H, Dh, D)
    "wq_a":     (-1, -2),   # (..., D, r)
    "wq_b":     (-2, -3),   # (..., r, H, k)
    "wkv_a":    (-1, -2),
    "wkv_b":    (-2, -3),
    "up":       (-1, -2),   # dense (..., D, F) and MoE (..., E, D, F)
    "gate":     (-1, -2),
    "down":     (-2, -1),   # dense (..., F, D) and MoE (..., E, F, D)
    "router":   (None, -2),
    "in_proj":  (-1, -2),   # (..., D, Z)
    "out_proj": (-2, -1),   # (..., d_inner, D)
    "conv_w":   (-1, None),
    "conv_b":   (-1, None),
}

_SERVE_TP_SAFE = frozenset(
    {"embed", "head", "wq", "wk", "wv", "wq_b", "wkv_b", "up", "gate"})

_MOE_NAMES = ("up", "gate", "down")


def _leaf_name(path) -> str:
    """The leaf's name: the last dict key on its path (a path is a tuple
    of dict keys and list indices)."""
    for k in reversed(path):
        if isinstance(k, str):
            return k
    return ""


# --------------------------------------------------------------------------
# the train half: helpers over a mesh's axis names and sizes
# --------------------------------------------------------------------------

def _sizes(mesh) -> dict[str, int]:
    if isinstance(mesh, MeshSpec):
        return dict(zip(mesh.axes, mesh.shape))
    return dict(zip(mesh.axis_names, mesh.devices.shape))


def axis_size(mesh, name) -> int:
    """The size of axis ``name`` (a tuple: the product of its axes'); 1
    for an axis the mesh does not have."""
    if isinstance(name, tuple):
        out = 1
        for n in name:
            out *= axis_size(mesh, n)
        return out
    return _sizes(mesh).get(name, 1)


def _fsdp_candidates(mesh, layout: str = "2d"):
    cands = []
    ba = batch_axes(mesh, layout)
    if ba:
        cands.append(ba)
        if len(ba) > 2:
            cands.append(ba[:2])
            cands.append(ba[1:])
        for a in ba:
            cands.append((a,))
    return cands


def _choose_fsdp(mesh, dim_size: int, layout: str = "2d"):
    for cand in _fsdp_candidates(mesh, layout):
        if dim_size % axis_size(mesh, cand) == 0:
            return cand if len(cand) > 1 else cand[0]
    return None


def _maybe(mesh, axis, dim_size: int):
    return axis if (axis in _sizes(mesh)
                    and dim_size % axis_size(mesh, axis) == 0) else None


def _is_moe_leaf(path, ndim: int, name: str) -> bool:
    # MoE up/gate/down are 3-D (+1 stacked group dim = 4-D); dense are 2/3-D
    if name not in _MOE_NAMES:
        return False
    return ndim == (4 if _stacked(path) else 3)


def _stacked(path) -> bool:
    """True if the leaf lives under the stacked layer groups."""
    return any(isinstance(k, str) and k in ("layers", "enc_layers",
                                            "dec_layers") for k in path)


def spec_shard_factor(spec, mesh) -> int:
    """How many parts ``spec`` splits a leaf into on ``mesh``: the product
    of the sizes of the axes it names."""
    out = 1
    for s in spec:
        if s is not None:
            out *= axis_size(mesh, s)
    return out


def param_spec(path, shape, mesh, mode: str, *, moe_partition: str = "tp",
               layout: str = "2d") -> tuple:
    """The spec of the parameter leaf at ``path``: TP on the model axis
    (MoE experts over data or model under ``moe_partition="ep"``; none
    under the "fsdp" layout) and, in "train" mode, FSDP over the batch
    axes on the rule's other dim.  Each axis only where it divides."""
    name = _leaf_name(path)
    ndim = len(shape)
    if name not in _PARAM_RULES or ndim == 0:
        return ()
    tp_dim, fsdp_dim = _PARAM_RULES[name]
    spec: list = [None] * ndim

    def put(dim, axis):
        if dim is None or axis is None:
            return
        if -dim > ndim:
            return
        if spec[dim % ndim] is None:
            spec[dim % ndim] = axis

    if layout != "fsdp":
        if moe_partition == "ep" and _is_moe_leaf(path, ndim, name):
            e_dim = -3
            if mode == "serve":
                # decode weight streaming: experts over the (idle) data
                # axis AND expert hidden over model — combined E*F sharding
                if shape[e_dim % ndim] % axis_size(mesh, DATA_AXIS) == 0:
                    put(e_dim, DATA_AXIS)
                if tp_dim is not None and -tp_dim <= ndim:
                    put(tp_dim, _maybe(mesh, MODEL_AXIS, shape[tp_dim % ndim]))
            # train: experts over the model axis (token all-to-all dispatch)
            elif shape[e_dim % ndim] % axis_size(mesh, MODEL_AXIS) == 0:
                put(e_dim, MODEL_AXIS)
        else:
            if tp_dim is not None and -tp_dim <= ndim:
                put(tp_dim, _maybe(mesh, MODEL_AXIS, shape[tp_dim % ndim]))
    if mode == "train" and fsdp_dim is not None and -fsdp_dim <= ndim:
        if spec[fsdp_dim % ndim] is None:
            put(fsdp_dim, _choose_fsdp(mesh, shape[fsdp_dim % ndim], layout))
    return tuple(spec)


def as_tree(x):
    """``x`` with every params object in it (`LMParams`, `EncDecParams`,
    `ShardedParams`) replaced by its tree."""
    if hasattr(x, "tree") and callable(x.tree):
        return x.tree()
    if isinstance(x, dict):
        return {k: as_tree(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)(as_tree(v) for v in x)
    return x


def param_shardings(tree, mesh, mode: str, *, moe_partition: str = "tp",
                    layout: str = "2d"):
    """``tree`` (a params object or tree; tensors, meta ones too) with each
    leaf replaced by its `param_spec`."""
    return map_with_path(
        lambda path, leaf: param_spec(path, tuple(leaf.shape), mesh, mode,
                                      moe_partition=moe_partition,
                                      layout=layout), as_tree(tree))


def _batch_dim_axis(mesh, b: int, layout: str = "2d"):
    ba = batch_axes(mesh, layout)
    if not ba:
        return None
    if b % axis_size(mesh, ba) == 0:
        return ba if len(ba) > 1 else ba[0]
    if len(ba) > 2:
        for cand in (ba[:2], ba[1:]):
            if b % axis_size(mesh, cand) == 0:
                return cand
    for a in ba:
        if b % axis_size(mesh, a) == 0:
            return a
    return None


def batch_shardings(batch_specs, mesh, layout: str = "2d"):
    """tokens/targets (B,S) -> batch over (pod,data); frontend (B,F,D) same."""
    def one(path, leaf):
        spec = [None] * len(leaf.shape)
        spec[0] = _batch_dim_axis(mesh, leaf.shape[0], layout)
        return tuple(spec)
    return map_with_path(one, batch_specs)


def _stacked_cache(path) -> bool:
    """Cache trees: a list of per-slot dicts whose leaves carry the group
    dim first (decoder caches), or dicts under "self"/"cross" (encdec,
    leading layer dim)."""
    return any(isinstance(k, int) or k in ("self", "cross") for k in path)


def decode_state_shardings(state_specs, mesh):
    """Decode caches: batch dim over (pod,data); the long sequence dim (self-
    attn KV / MLA latent) over "model" (split-K); SSM state heads over
    "model".  Leaf kinds are identified structurally by name."""
    def one(path, leaf):
        name = _leaf_name(path)
        shape = leaf.shape
        ndim = len(shape)
        spec: list = [None] * ndim
        if name == "pos":
            return ()
        if name == "token":
            spec[0] = _batch_dim_axis(mesh, shape[0])
            return tuple(spec)
        bdim = 1 if _stacked_cache(path) else 0
        if ndim > bdim:
            spec[bdim] = _batch_dim_axis(mesh, shape[bdim])
        if name in ("k", "v", "ckv", "krope"):
            tdim = bdim + 1
            if ndim > tdim and shape[tdim] % axis_size(mesh, MODEL_AXIS) == 0:
                spec[tdim] = MODEL_AXIS
        elif name == "ssd":                      # (..., B, H, N, P)
            hdim = bdim + 1
            if ndim > hdim and shape[hdim] % axis_size(mesh, MODEL_AXIS) == 0:
                spec[hdim] = MODEL_AXIS
        elif name == "conv":                     # (..., B, W-1, conv_dim)
            cdim = bdim + 2
            if ndim > cdim and shape[cdim] % axis_size(mesh, MODEL_AXIS) == 0:
                spec[cdim] = MODEL_AXIS
        return tuple(spec)
    return map_with_path(one, state_specs)


def replicated(tree, mesh):
    return map_with_path(lambda path, leaf: (), as_tree(tree))


def train_state_shardings(param_specs_tree, mesh, *,
                          moe_partition: str = "tp", layout: str = "2d"):
    ps = param_shardings(param_specs_tree, mesh, "train",
                         moe_partition=moe_partition, layout=layout)
    return {"params": ps, "opt": {"m": ps, "v": ps, "step": ()}}


# --------------------------------------------------------------------------
# activation sharding constraints
# --------------------------------------------------------------------------
# The reference pins activations inside its layer scan with
# with_sharding_constraint so that XLA keeps the batch axis sharded in the
# backward loop.  The port has no partitioner: `constrain` resolves the
# same spec (`activation_spec`) and returns the tensor as it is.

_ACT = threading.local()


@contextmanager
def activation_sharding(mesh, layout: str = "2d"):
    prev = getattr(_ACT, "ctx", None)
    _ACT.ctx = (mesh, layout)
    try:
        yield
    finally:
        _ACT.ctx = prev


def active_mesh():
    """The mesh of the enclosing :func:`activation_sharding` context, or
    None."""
    ctx = getattr(_ACT, "ctx", None)
    return ctx[0] if ctx is not None else None


def constrain_replicated(x):
    """``x`` whole: under a "serve" layout context a `Shards` is gathered
    onto the lead device (`gather`, the rank loop's counterpart of the
    reference's constraint); anything else comes back as it is."""
    ctx = getattr(_ACT, "ctx", None)
    if ctx is None or ctx[1] != "serve":
        return x
    return gather(x)


def activation_spec(shape, dims: str, mesh, layout: str = "2d"):
    """The spec the reference's ``constrain`` would pin an activation of
    ``shape`` to, or None where it skips (two dims want one axis).

    ``dims`` has one char per dim:
      'b' -> batch axes (pod+data, +model under the "fsdp" layout)
      'm' -> model axis (tensor-parallel dim; skipped under "fsdp")
      'd' -> data axis (serve-mode expert parallelism)
      '.' -> unconstrained
    Axes are applied only when they divide the dim size."""
    if len(dims) != len(shape):
        raise ValueError(f"dims {dims!r} for a shape of {len(shape)} dims")
    spec = []
    for ch, size in zip(dims, shape):
        if ch == "b":
            spec.append(_batch_dim_axis(mesh, size, layout))
        elif ch == "m" and layout != "fsdp":
            spec.append(_maybe(mesh, MODEL_AXIS, size))
        elif ch == "d":
            spec.append(_maybe(mesh, DATA_AXIS, size))
        else:
            spec.append(None)
    flat = []
    for s in spec:
        if s is not None:
            flat.extend(s if isinstance(s, tuple) else (s,))
    if len(flat) != len(set(flat)):     # conflicting axes -> skip
        return None
    return tuple(spec)


def constrain(x, dims: str):
    """``x`` itself.  Under an :func:`activation_sharding` context the
    spec is resolved as the reference resolves it (a ``dims`` of the wrong
    length raises); without one nothing is read."""
    ctx = getattr(_ACT, "ctx", None)
    if ctx is not None:
        activation_spec(tuple(x.shape), dims, *ctx)
    return x


def serve_param_shard_factor(path, shape, model_axis_size: int) -> int:
    """How many ways :func:`serve_param_shardings` would split this leaf
    on a mesh with ``model_axis_size`` model shards — as a PURE divisor,
    no Mesh or devices required.  Mirrors the sharding rules exactly
    (column-parallel leaves only, divisibility-gated, else replicated),
    so a dry run can account per-device serve memory without building
    the mesh it is sizing for."""
    name = _leaf_name(path)
    ndim = len(shape)
    if model_axis_size <= 1 or name not in _SERVE_TP_SAFE or ndim == 0:
        return 1
    tp_dim, _ = _PARAM_RULES[name]
    if tp_dim is None or -tp_dim > ndim:
        return 1
    return (model_axis_size
            if shape[tp_dim % ndim] % model_axis_size == 0 else 1)


def serve_state_shard_factor(path, shape, model_axis_size: int) -> int:
    """Pure-divisor mirror of :func:`serve_state_shardings`: KV pools and
    dense caches split on the head/latent dim over the model axis when it
    divides, everything else (ssd/conv/token/pos/block_tables) replicates."""
    name = _leaf_name(path)
    ndim = len(shape)
    msz = model_axis_size
    if msz <= 1 or ndim < 2:
        return 1
    if name in ("kp", "vp"):
        return msz if shape[-2] % msz == 0 else 1
    if name in ("ckvp", "kropep"):
        return msz if shape[-1] % msz == 0 else 1
    if name in ("k", "v"):
        return msz if (ndim >= 3 and shape[-2] % msz == 0) else 1
    if name in ("ckv", "krope"):
        return msz if shape[-1] % msz == 0 else 1
    return 1


def _split_dim(path, shape, msz: int, rule: str) -> int | None:
    """The dim (non-negative) ``rule`` ("param" or "state") splits this
    leaf on over ``msz`` model ranks, or None."""
    if rule == "param":
        if serve_param_shard_factor(path, shape, msz) == 1:
            return None
        return _PARAM_RULES[_leaf_name(path)][0] % len(shape)
    if serve_state_shard_factor(path, shape, msz) == 1:
        return None
    last = _leaf_name(path) in ("ckvp", "kropep", "ckv", "krope")
    return len(shape) - (1 if last else 2)


def map_with_path(fn, tree, path=()):
    """``tree`` (nested dicts and lists) with every leaf replaced by
    ``fn(path, leaf)``; a path is the tuple of keys and indices to it."""
    if isinstance(tree, dict):
        return {k: map_with_path(fn, v, path + (k,)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(map_with_path(fn, v, path + (i,))
                          for i, v in enumerate(tree))
    return fn(path, tree)


def serve_param_shardings(tree, mesh: DeviceMesh):
    """Order-preserving tensor parallelism for the serve engine: ``tree``
    (`LMParams.tree()`) with each leaf replaced by the dim it splits on
    over the model axis, or None where it is replicated.

    Only COLUMN-parallel weights shard — those whose TP dim is an *output*
    dim of the forward contraction (wq/wk/wv/up/gate/... split heads or
    d_ff; the contraction dim D/r stays whole on every shard, so each
    shard's outputs are bitwise identical to the single-device slices).
    ROW-parallel weights (wo, down, out_proj: TP dim is the contraction
    dim) are deliberately replicated: sharding them turns the contraction
    into partial sums, whose reduction order differs from the
    single-device product and flips argmax on near-tie logits.
    wq_a/wkv_a are also replicated (their outputs feed rmsnorm over the
    latent dim, a reduction that must not be sharded).  The memory win
    that matters for serving — the paged KV pools — comes from
    :func:`serve_state_shardings`, not from here."""
    msz = mesh_axis_size(mesh, MODEL_AXIS)
    return map_with_path(
        lambda path, leaf: _split_dim(path, tuple(leaf.shape), msz, "param"),
        tree)


def serve_state_shardings(tree, mesh: DeviceMesh):
    """Serve-engine decode state under tensor parallelism: ``tree`` with
    each leaf replaced by its split dim over the model axis, or None.  KV
    pools split on the HEAD dim, never on the sequence/block dim, so every
    per-head softmax and weighted sum is the single-device one:

      kp/vp       (nb, bs, K, Dh)        -> K (dim -2)
      ckvp        (nb, bs, r_latent)     -> latent (dim -1)
      kropep      (nb, bs, d_rope)       -> latent (dim -1)
      k/v dense   (B, T, K, Dh)          -> K (dim -2)
      ckv/krope dense (B, T, r)          -> latent (dim -1)
      ssd/conv / token / pos / block_tables -> replicated

    Every rule degrades to replication when the axis doesn't divide the
    dim; a stacked group dim in front changes nothing (negative dims)."""
    msz = mesh_axis_size(mesh, MODEL_AXIS)
    return map_with_path(
        lambda path, leaf: _split_dim(path, tuple(leaf.shape), msz, "state"),
        tree)


def tp_heads(mesh, num_kv_heads: int, num_heads: int) -> bool:
    """True iff the attention kernels can be head-sharded on this mesh:
    the model axis must divide the KV head count (whole kv-groups per
    shard)."""
    if mesh is None:
        return False
    m = mesh_axis_size(mesh, MODEL_AXIS)
    return m > 1 and num_kv_heads % m == 0 and num_heads % m == 0


# --------------------------------------------------------------------------
# placements: the rank loop's tensors
# --------------------------------------------------------------------------

class Shards:
    """One tensor split along ``dim`` (kept negative, so a stacked group
    dim in front changes nothing) over the model ranks: ``parts[r]`` lives
    on rank r's device.  Indexing a leading dim (``x[g]``, ``x[:, slot]``)
    indexes every part."""

    __slots__ = ("parts", "dim")

    def __init__(self, parts, dim: int):
        self.parts = tuple(parts)
        self.dim = dim if dim < 0 else dim - self.parts[0].dim()

    @property
    def devices(self) -> tuple[torch.device, ...]:
        return tuple(p.device for p in self.parts)

    @property
    def device(self) -> torch.device:
        return self.parts[0].device

    @property
    def dtype(self) -> torch.dtype:
        return self.parts[0].dtype

    @property
    def shape(self) -> torch.Size:
        s = list(self.parts[0].shape)
        s[self.dim] = sum(p.shape[self.dim] for p in self.parts)
        return torch.Size(s)

    def __getitem__(self, idx):
        return Shards([p[_on(idx, p.device)] for p in self.parts], self.dim)

    @property
    def T(self):
        return Shards([p.T for p in self.parts], -3 - self.dim)


class Whole:
    """A column leaf kept whole on the lead device: `on_ranks` runs its
    product there and splits the output along ``dim`` over ``devices``."""

    __slots__ = ("tensor", "dim", "devices")

    def __init__(self, tensor, dim: int, devices):
        self.tensor = tensor
        self.dim = dim if dim < 0 else dim - tensor.dim()
        self.devices = tuple(devices)

    @property
    def device(self) -> torch.device:
        return self.tensor.device

    @property
    def dtype(self) -> torch.dtype:
        return self.tensor.dtype

    @property
    def shape(self) -> torch.Size:
        return self.tensor.shape

    def __getitem__(self, idx):
        return Whole(self.tensor[idx], self.dim, self.devices)

    @property
    def T(self):
        return Whole(self.tensor.T, -3 - self.dim, self.devices)


def _on(x, dev):
    """``x`` (a tensor, or tensors in tuples and lists) on ``dev``;
    anything else as it is.  Moving to the device a tensor is on is free."""
    if isinstance(x, torch.Tensor):
        return x.to(dev)
    if isinstance(x, (tuple, list)):
        return type(x)(_on(v, dev) for v in x)
    return x


def _sent(x):
    """Report ``x``'s tensors (in tuples and lists too) as sent from the
    lead device to another rank: a collective-permute each."""
    if isinstance(x, torch.Tensor):
        op_stats.transfer("collective-permute", x)
    elif isinstance(x, (tuple, list)):
        for v in x:
            _sent(v)


def parts(x) -> tuple:
    """The tensors behind ``x``: a `Shards`' parts, or ``x`` alone."""
    if isinstance(x, Shards):
        return x.parts
    if isinstance(x, Whole):
        return (x.tensor,)
    return (x,)


def gather(x):
    """``x`` whole on the lead device: a `Shards`' parts concatenated in
    rank order (the reference's ``constrain_replicated``), a `Whole`'s
    tensor; a tensor as it is."""
    if isinstance(x, Shards):
        lead = x.parts[0].device
        out = torch.cat([p.to(lead) for p in x.parts], dim=x.dim)
        op_stats.transfer("all-gather", out)
        return out
    if isinstance(x, Whole):
        return x.tensor
    return x


def split(x, like):
    """``x`` split as ``like`` (a `Shards` or a `Whole`) is: along its
    dim, one part per rank on the rank's device.  A `Shards` stays as it
    is; anything else is ``x`` itself (the rank loop is not running)."""
    if isinstance(x, Shards) or not isinstance(like, (Shards, Whole)):
        return x
    devs = like.devices
    chunks = torch.chunk(x, len(devs), like.dim)
    _sent(chunks[1:])
    return Shards([c.to(d) for c, d in zip(chunks, devs)], like.dim)


def on_ranks(fn, *args, dim: int):
    """The rank loop.  With no `Shards` or `Whole` among ``args``, just
    ``fn(*args)``.  With a `Whole`, ``fn`` runs once on the lead device
    (a `Shards` argument gathered first) and its output is split along
    ``dim`` over the ranks.  Otherwise ``fn`` runs once per rank on each
    `Shards`' part and every other tensor moved to the rank's device; the
    outputs make a `Shards` along ``dim`` (a tuple of outputs, one
    `Shards` each, all along ``dim``)."""
    split_by = next((a for a in args if isinstance(a, (Shards, Whole))), None)
    if split_by is None:
        return fn(*args)
    if any(isinstance(a, Whole) for a in args):
        devs = next(a for a in args if isinstance(a, Whole)).devices
        out = fn(*(gather(a) for a in args))
        if isinstance(out, tuple):
            return tuple(split(o, Whole(o, dim, devs)) for o in out)
        return split(out, Whole(out, dim, devs))
    outs = []
    for r, d in enumerate(split_by.devices):
        if r:
            _sent([a for a in args if not isinstance(a, Shards)])
        outs.append(fn(*(a.parts[r] if isinstance(a, Shards) else _on(a, d)
                         for a in args)))
    if isinstance(outs[0], tuple):
        return tuple(Shards(o, dim) for o in zip(*outs))
    return Shards(outs, dim)


def stack(xs):
    """``torch.stack(xs)`` of tensors, or of `Shards` part by part."""
    if isinstance(xs[0], Shards):
        return Shards([torch.stack(ps) for ps in zip(*(x.parts for x in xs))],
                      xs[0].dim)
    return torch.stack(xs)


def pairs(dst, src):
    """(destination part, source part on its device) per rank, for writing
    ``src`` into ``dst`` in place: a split destination takes ``src`` split
    as it is, a whole one takes it whole."""
    if isinstance(dst, Shards):
        return list(zip(dst.parts, split(src, dst).parts))
    return [(dst, gather(src))]


# --------------------------------------------------------------------------
# placing parameters and state
# --------------------------------------------------------------------------

class Experts(dict):
    """An MoE slot's parameters on data row 0 (read as any slot's dict)
    that also carries ``rows``: the same slot's parameters on every data
    row, row 0 first.  `repro_torch.models.moe.apply_moe_dense` computes
    each row's slice of the experts from that row's own copy: the
    reference's serve-mode expert parallelism over the data axis."""

    def __init__(self, p: dict, rows: tuple):
        super().__init__(p)
        self.rows = rows


class ShardedParams:
    """An `LMParams` placed on a mesh by `serve_param_shardings`: split
    column leaves are `Shards` (or `Whole`), every other leaf one tensor on
    the lead device.  The serve paths read it as they read `LMParams`
    (``embed``, ``head``, ``final_norm``, ``group(g)``, ``n_groups``).
    ``replicas`` are the copies of that placement on data rows 1, 2, ...
    of the mesh; with ``expert_rows`` above 1 each MoE slot's view is an
    `Experts` holding every row's copy."""

    def __init__(self, tree: dict, mesh: DeviceMesh, replicas=(),
                 expert_rows: int = 1):
        self.mesh = mesh
        self.whole_leaves: tuple[str, ...] = ()
        self.replicas = tuple(replicas)
        self.expert_rows = expert_rows
        self._tree = tree
        self.embed = tree["embed"]
        self.head = tree.get("head")
        self.final_norm = tree["final_norm"]
        layers = tree["layers"]
        self.n_groups = next(iter(layers[0]["mixer"].values())).shape[0]
        rows = ((tree,) + self.replicas)[:expert_rows]

        def take(t, i):
            if isinstance(t, dict):
                return {k: take(v, i) for k, v in t.items()}
            return t[i]

        def view(s, g):
            v = take(layers[s], g)
            if len(rows) > 1 and "router" in v.get("ffn", {}):
                v["ffn"] = Experts(v["ffn"], tuple(
                    take(r["layers"][s]["ffn"], g) for r in rows))
            return v
        self._views = [[view(s, g) for s in range(len(layers))]
                       for g in range(self.n_groups)]

    def group(self, g: int) -> list[dict]:
        return self._views[g]

    def tree(self) -> dict:
        return self._tree


def data_rows(mesh: DeviceMesh) -> tuple[tuple[torch.device, ...], ...]:
    """The model ranks' devices of each data row of ``mesh``, row 0 (its
    `DeviceMesh.model_devices`) first."""
    flat = mesh.devices.reshape(-1, mesh.spec.axis_size(MODEL_AXIS))
    return tuple(tuple(r) for r in flat)


def _place(t, dim, devs):
    if dim is None:
        return t.to(devs[0])
    return Shards([c.contiguous().to(d)
                   for c, d in zip(torch.chunk(t, len(devs), dim), devs)], dim)


def replicate(tree, devs):
    """A copy of ``tree``'s placement on the model ranks ``devs`` of
    another data row: a `Shards`' part r on ``devs[r]``, a `Whole` or a
    tensor on ``devs[0]``.  Always a copy, also onto the device a tensor
    is on, so every data row holds its own bytes."""
    def one(path, x):
        if isinstance(x, Shards):
            return Shards([p.to(d, copy=True) for p, d in zip(x.parts, devs)],
                          x.dim)
        if isinstance(x, Whole):
            return Whole(x.tensor.to(devs[0], copy=True), x.dim, devs)
        return x.to(devs[0], copy=True)
    return map_with_path(one, tree)


def rank_bytes(tree, msz: int, only=None) -> list[int]:
    """The bytes of ``tree``'s tensors on each of ``msz`` model ranks,
    lead first, as the serve path places them: a `Shards`' part r on rank
    r, a `Whole` or a tensor on the lead; ``only``: the leaves of those
    names alone."""
    per_rank = [0] * msz

    def one(path, leaf):
        if only is not None and _leaf_name(path) not in only:
            return
        ps = parts(leaf)
        for r, p in enumerate(ps if isinstance(leaf, Shards) else ps[:1]):
            per_rank[r] += p.numel() * p.element_size()
    map_with_path(one, tree)
    return per_rank


def _decode_product(x, w):
    """`moe.apply_moe_dense`'s product: x (1, M, D) @ w (E, D, F)."""
    return torch.matmul(x, w)


def _bucket_product(x, w):
    """`moe._bucket_gmm`'s product of one row's capacity buckets, E
    buckets of M rows: the grouped-matmul kernel on a CUDA tensor, its
    plain version on the CPU."""
    from repro_torch.kernels.grouped_matmul.ops import bucket_matmul
    E, _, _ = w.shape
    return bucket_matmul(x.expand(E, -1, -1).contiguous(), w)


def _einsum_product(x, w):
    """`moe.apply_moe`'s einsum path on the same buckets."""
    return torch.einsum("ecd,edf->ecf", x.expand(w.shape[0], -1, -1), w)


def _column_products(name: str, t):
    """The products the engine runs with column leaf ``t``, each as
    (the weight it multiplies by, fn(x, weight), the shape of x at M
    rows).  A stacked MoE ``up``/``gate`` (G, E, D, F) is group 0's (E, D,
    F) in the decode product and the bucket products; any other leaf is
    the (K, N) matrix of ``x @ w`` (a layer leaf's group 0, a projection's
    heads flattened; the embedding as the tied head)."""
    if name in ("up", "gate") and t.dim() == 4:
        w = t[0]
        return [(w, fn, lambda m, w=w: (1, m, w.shape[1]))
                for fn in (_decode_product, _bucket_product,
                           _einsum_product)]
    if name == "embed":
        w = t.T
    else:
        w = t[0] if t.dim() == 4 or (t.dim() == 3 and name in (
            "up", "gate")) else t
        w = w.reshape(w.shape[0], -1)
    return [(w, torch.matmul, lambda m, w=w: (m, w.shape[0]))]


def _exact(want, got, lo, n, dim):
    return torch.equal(got, want.narrow(dim, lo, n).to(got.device))


def slices_exact(name: str, t, parts, rows) -> bool:
    """True iff, at every row count M in ``rows``, each part's products
    (on its device) are bitwise the columns of ``t``'s products (on
    ``t``'s) they stand for, for a random bf16 ``x`` of M rows: ``x @
    part`` for a dense leaf; for a stacked MoE ``up``/``gate``, the decode
    product and the capacity-bucket products (`_column_products`).  The
    library's choice of algorithm depends on the shapes, not the
    values."""
    gen = torch.Generator(device=t.device)
    gen.manual_seed(0)
    for (w, fn, shape), *ps in zip(_column_products(name, t),
                                   *(_column_products(name, p)
                                     for p in parts)):
        for m in rows:
            x = torch.randn(shape(m), generator=gen,
                            device=w.device).to(w.dtype)
            full = fn(x, w)
            lo = 0
            for pw, _, _ in ps:
                n = pw.shape[-1]
                if not _exact(full, fn(x.to(pw.device), pw), lo, n, -1):
                    return False
                lo += n
    return True


def experts_exact(t, parts, rows, n: int) -> bool:
    """True iff the experts of a stacked MoE ``up``/``gate`` split into
    ``n`` equal slices (one a data row) keep the decode product bitwise:
    at every M in ``rows``, each slice's product by each of ``parts``
    (the model ranks' parts, or the whole leaf) is that part's whole
    product's slice.  False where ``n`` does not divide the experts."""
    E = t.shape[1]
    if E % n:
        return False
    gen = torch.Generator(device=t.device)
    gen.manual_seed(0)
    for m in rows:
        x = torch.randn((1, m, t.shape[2]), generator=gen,
                        device=t.device).to(t.dtype)
        for p in parts:
            w = p[0]
            xp = x.to(w.device)
            full = _decode_product(xp, w)
            for lo in range(0, E, E // n):
                if not _exact(full, _decode_product(xp, w[lo:lo + E // n]),
                              lo, E // n, 0):
                    return False
    return True


def shard_params(params, mesh: DeviceMesh, *, rows=(), whole=(),
                 decode_rows=None):
    """``params`` (`LMParams`) placed on ``mesh``: each rank's slice of a
    split leaf on its device, replicated leaves once on the lead device.
    A split leaf named in ``whole``, or whose slices are not exact
    (`slices_exact`) at some row count in ``rows``, stays whole on the
    lead (`Whole`); the result's ``whole_leaves`` names those leaves.
    Each further data row of the mesh holds a copy of that placement
    (`replicate`).  There, when the mesh has MoE slots and their experts'
    slices are exact (`experts_exact`) at the decode product's row counts
    (``decode_rows``; None: ``rows``), every data row computes its slice
    of the experts in decode (``expert_rows``); otherwise row 0 computes
    them all."""
    tree = params.tree()
    dims = serve_param_shardings(tree, mesh)
    n_data = len(data_rows(mesh))
    # an embedding with a head of its own is only looked up (exact split
    # or whole); a tied one is also the head's product
    looked_up = {"embed"} if "head" in tree else set()
    kept, experts = {}, {}

    def place(path, t):
        name = _leaf_name(path)
        out = _place(t, _get(dims, path), mesh.model_devices)
        key = (name, tuple(t.shape))
        if isinstance(out, Shards):
            if key not in kept:
                kept[key] = name in whole or (
                    name not in looked_up
                    and not slices_exact(name, t, out.parts, rows))
            if kept[key]:
                out = Whole(t.to(mesh.lead), out.dim, out.devices)
        if (n_data > 1 and name in ("up", "gate") and t.dim() == 4
                and key not in experts):
            ps = out.parts if isinstance(out, Shards) else (t,)
            experts[key] = experts_exact(
                t, ps, rows if decode_rows is None else decode_rows, n_data)
        return out
    main = map_with_path(place, tree)
    ep = n_data if experts and all(experts.values()) else 1
    sp = ShardedParams(main, mesh, [replicate(main, devs)
                                    for devs in data_rows(mesh)[1:]], ep)
    sp.whole_leaves = tuple(sorted({n for (n, _), w in kept.items() if w}))
    return sp


def shard_state(tree, mesh: DeviceMesh):
    """A ZERO decode state ``tree`` (its leaves may live on the meta
    device: only their shapes and dtypes are read) made on ``mesh``'s
    data row 0: each split leaf's zero parts on the ranks' devices, every
    other leaf zeros on the lead device (`state_replicas` makes the other
    data rows' copies)."""
    dims = serve_state_shardings(tree, mesh)
    devs = mesh.model_devices

    def make(path, t):
        dim = _get(dims, path)
        if dim is None:
            return torch.zeros(t.shape, dtype=t.dtype, device=mesh.lead)
        shape = list(t.shape)
        shape[dim] //= len(devs)
        return Shards([torch.zeros(shape, dtype=t.dtype, device=d)
                       for d in devs], dim)
    return map_with_path(make, tree)


def state_replicas(state, mesh: DeviceMesh) -> list:
    """The copies of a placed decode ``state`` on data rows 1, 2, ... of
    ``mesh`` (`replicate`): the bytes every device of a data row holds
    where the reference replicates the state over the data axis.  The
    rank loop reads and writes row 0's state alone, so these copies stay
    as they were made."""
    return [replicate(state, devs) for devs in data_rows(mesh)[1:]]


def _get(tree, path):
    for k in path:
        tree = tree[k]
    return tree
