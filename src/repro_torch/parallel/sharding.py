"""Logical-axis sharding rules -> placements on a ``DeviceMesh``, and the
sharded train step.

The counterpart of ``repro/parallel/sharding.py``.  Every ParamSpec or
cache-spec leaf carries logical axis names; a *policy* maps each logical
name to an ordered list of candidate mesh-axis tuples.  Resolution is the
reference's greedy pass, left to right over the leaf's dims, with two
constraints:

  * divisibility — a dim is sharded over a candidate only if the candidate's
    total mesh extent is above 1 and divides the dim;
  * exclusivity — a mesh axis is used at most once per leaf.

Candidates naming mesh axes absent from the mesh ("pod" on the single-pod
mesh) are skipped, so one policy serves both meshes.  :func:`resolve_pspec`
returns the reference's ``PartitionSpec`` entries as a plain tuple;
:func:`to_placements` turns them into one ``Shard(dim)`` or ``Replicate()``
per mesh dim.  A tensor dim sharded over ``("pod", "data")`` is ``Shard(d)``
on both mesh dims, which DTensor splits in mesh-dim order, pod-major, as
JAX does.

Policies (the reference's tables, copied as data):

* ``train`` — batch over (pod, data); FSDP: the largest non-TP weight dim
  ("embed") over (pod, data); TP over "model" (heads / mlp / vocab).
  Optimizer moments inherit the param leaf's spec.
* ``serve`` — weights as train; caches over batch + heads.
* ``serve_2dtp`` — weight-stationary 2D tensor parallelism (contraction dims
  over "data", output dims over "model").

The reference shards its train step by handing ``jax.jit`` these shardings;
torch has no such compiler, so :func:`shard_train_step` does it by hand,
FSDP-style: parameters and AdamW moments rest as DTensors at their
placements, each step gathers the weights, runs the unsharded loss and
gradients on the rank's batch shard, averages the gradients over the batch's
mesh axes and updates the rank's own slice.  :class:`ShardedPrefill` and
:class:`ShardedDecode` serve in the same gather-on-use form, with the
caches at rest at their serve shardings.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import DTensor, Placement, Replicate, Shard, distribute_tensor

from ..models.common import ParamSpec
from ..models.weights import reference_views
from ..optim import adamw
from ..parallel import compression
from ..train.step import mean_loss_and_grads
from ..tree import tree_map

Candidate = Tuple[str, ...]
Rules = Dict[str, List[Candidate]]

_TRAIN_RULES: Rules = {
    "vocab": [("model",)],
    "embed": [("pod", "data"), ("data",)],
    "embed2": [("model",)],
    "heads": [("model",)],
    "kv_heads": [("model",)],
    "head_dim": [("model",)],
    "mlp": [("model",)],
    "expert": [("model",), ("data",)],   # 8 experts vs 16-wide axes: falls through
    "layers": [],
    "batch": [("pod", "data"), ("data",)],
    "kv_seq": [("data",)],
}

_SERVE_RULES: Rules = dict(_TRAIN_RULES)

_SERVE_2DTP_RULES: Rules = {
    **_TRAIN_RULES,
    # weight-stationary: contraction dim over data, output dim over model
    "embed": [("data",)],
    "vocab": [("model",)],
    "batch": [("pod",), ()],   # tiny decode batches stay near-replicated
    "kv_seq": [("data",)],
}

POLICIES: Dict[str, Rules] = {
    "train": _TRAIN_RULES,
    "serve": _SERVE_RULES,
    "serve_2dtp": _SERVE_2DTP_RULES,
}

PSpec = Tuple[Any, ...]     # entries: None, an axis name, or a tuple of axis names


def mesh_axes(mesh) -> Dict[str, int]:
    """Axis name -> extent, in the mesh's dim order.  A ``DeviceMesh`` is
    read through ``mesh_dim_names`` and ``size(i)`` (its ``.shape`` is a
    tuple of sizes); any other object must have a name -> extent ``.shape``
    (as a JAX mesh has), which lets a production mesh be resolved without
    its ranks."""
    if isinstance(mesh, DeviceMesh):
        if mesh.mesh_dim_names is None:
            raise ValueError("a DeviceMesh needs mesh_dim_names to resolve logical axes")
        return {name: mesh.size(i) for i, name in enumerate(mesh.mesh_dim_names)}
    return dict(mesh.shape)


def resolve_pspec(shape: Sequence[int], logical: Sequence[Optional[str]], mesh,
                  rules: Rules) -> PSpec:
    extents = mesh_axes(mesh)
    used: set = set()
    parts: List[Any] = []
    for dim, name in zip(shape, logical):
        assigned = None
        if name is not None:
            for cand in rules.get(name, []):
                axes = tuple(cand)
                if not axes:
                    continue
                if any(a in used or a not in extents for a in axes):
                    continue
                extent = math.prod(extents[a] for a in axes)
                if extent > 1 and dim % extent == 0:
                    assigned = axes if len(axes) > 1 else axes[0]
                    used.update(axes)
                    break
        parts.append(assigned)
    # trim trailing Nones for tidier specs
    while parts and parts[-1] is None:
        parts.pop()
    return tuple(parts)


def _axes_of(entry) -> Tuple[str, ...]:
    """The mesh axes of one spec entry: none, one or a tuple."""
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def to_placements(pspec: PSpec, mesh) -> Tuple[Placement, ...]:
    """One ``Shard(dim)`` or ``Replicate()`` per mesh dim.  The axes of a
    tuple entry must come in mesh-dim order: DTensor splits a tensor dim
    over its mesh dims in that order, so only then is the layout the
    reference's (the first axis major)."""
    names = list(mesh_axes(mesh))
    placements: List[Placement] = [Replicate()] * len(names)
    for d, entry in enumerate(pspec):
        idx = [names.index(a) for a in _axes_of(entry)]
        if idx != sorted(idx):
            raise ValueError(f"axes {entry} of dim {d} are not in the mesh's order {names}")
        for i in idx:
            placements[i] = Shard(d)
    return tuple(placements)


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """The counterpart of ``jax.sharding.NamedSharding``: a mesh, the
    resolved spec (the reference's ``PartitionSpec`` entries) and the
    DTensor placements it gives on that mesh."""
    mesh: Any
    spec: PSpec
    placements: Tuple[Placement, ...]


def _sharding(mesh, pspec: PSpec) -> NamedSharding:
    return NamedSharding(mesh, pspec, to_placements(pspec, mesh))


def spec_sharding(spec: ParamSpec, mesh, rules: Rules) -> NamedSharding:
    return _sharding(mesh, resolve_pspec(spec.shape, spec.logical, mesh, rules))


def tree_shardings(spec_tree, mesh, policy: str = "train"):
    """Map a ParamSpec tree to a NamedSharding tree."""
    rules = POLICIES[policy]
    return tree_map(lambda s: spec_sharding(s, mesh, rules), spec_tree)


def batch_shardings(input_spec_tree, mesh, policy: str = "train"):
    """Shardings for model inputs (any leaves with a ``.shape``: tensors or
    ``registry.TensorSpec``): leading batch dim over (pod, data); scalars
    and trailing dims replicated."""
    rules = POLICIES[policy]

    def _one(leaf) -> NamedSharding:
        shape = tuple(leaf.shape)
        if not shape:
            return replicated(mesh)
        logical = ["batch"] + [None] * (len(shape) - 1)
        return _sharding(mesh, resolve_pspec(shape, logical, mesh, rules))

    return tree_map(_one, input_spec_tree)


def replicated(mesh) -> NamedSharding:
    return _sharding(mesh, ())


def local_shard(t: torch.Tensor, sharding: NamedSharding) -> torch.Tensor:
    """This rank's slice of ``t`` (the whole tensor, the same on every rank)
    at ``sharding``'s placements, split locally with no communication.  A
    strict slice is copied into storage of its own, so the whole tensor is
    not kept alive by it."""
    return _own_storage(distribute_tensor(t, sharding.mesh, list(sharding.placements),
                                          src_data_rank=None).to_local())


def _own_storage(local: torch.Tensor) -> torch.Tensor:
    """``local``, copied into storage of its own if it is a strict slice of
    a larger tensor's."""
    return local.clone() if local.untyped_storage().nbytes() > local.nbytes else local


def distribute_tree(tree, shardings):
    """A tree of DTensors at ``shardings`` from a tree of whole tensors that
    every rank holds alike (made from one seed, or loaded by every rank)."""
    return tree_map(lambda t, s: DTensor.from_local(local_shard(t, s), s.mesh, s.placements,
                                                    run_check=False), tree, shardings)


def _local_input(x: torch.Tensor, sharding: NamedSharding) -> torch.Tensor:
    """The rank's shard of a model input: a DTensor's local tensor, or the
    rank's slice of a whole tensor that every rank holds alike."""
    return x.to_local() if isinstance(x, DTensor) else local_shard(x, sharding)


def _gather(params):
    """Every weight whole on this rank (``full_tensor()``)."""
    return tree_map(lambda p: p.full_tensor(), params)


def _batch_entry(sharding: NamedSharding):
    """The mesh axes a batch input's leading dim is split over (its spec's
    first entry), or None."""
    return sharding.spec[0] if sharding.spec else None


def _batch_only(spec: ParamSpec, batch_entry, mesh) -> Tuple[Placement, ...]:
    """Placements of a leaf of ``spec`` that this rank holds for its batch
    rows only: split over the batch's mesh axes at its "batch" dim, whole
    along every other."""
    d = list(spec.logical).index("batch")
    return to_placements((None,) * d + (batch_entry,), mesh)


class _Serve:
    """What the gather-on-use serve steps share: the parameter shardings,
    the cache specs and shardings at ``cache_len`` per global batch, and
    the model run on a reference tree."""

    def __init__(self, model, mesh: DeviceMesh, cache_len: int, policy: str = "serve"):
        self.model, self.mesh, self.cache_len, self.policy = model, mesh, cache_len, policy
        self.param_shardings = tree_shardings(model.param_specs(), mesh, policy)

    def cache_specs(self, batch: int):
        return self.model.cache_specs(batch, self.cache_len)

    def cache_shardings(self, batch: int):
        return tree_shardings(self.cache_specs(batch), self.mesh, self.policy)

    def _run(self, method: str, full, *args):
        """``model.lm.<method>(*args)`` on the whole weights ``full`` (a
        reference tree; views, no copy) in place of the model's own."""
        views = {f"lm.{k}": v for k, v in reference_views(self.model, full).items()}
        return torch.func.functional_call(_Method(self.model.lm, method), views, args)

    def _keep_local(self, caches, batch: int, batch_entry):
        """The rank's shards of ``caches`` (each whole but for its batch
        rows) at their cache shardings, in storage of their own."""
        def one(t, spec, sh):
            d = DTensor.from_local(t, self.mesh, _batch_only(spec, batch_entry, self.mesh),
                                   run_check=False)
            return _own_storage(d.redistribute(self.mesh, sh.placements).to_local())
        return tree_map(one, caches, self.cache_specs(batch), self.cache_shardings(batch))


class _Method(torch.nn.Module):
    """Calls ``lm.<name>``, so that ``functional_call`` can run it."""

    def __init__(self, lm, name: str):
        super().__init__()
        self.lm, self.name = lm, name

    def forward(self, *args):
        return getattr(self.lm, self.name)(*args)


class ShardedPrefill(_Serve):
    """``prefill(params, batch) -> (last_logits, caches)`` over DTensor
    trees, the counterpart of the reference's ``jax.jit(model.prefill,
    in_shardings=(param_sh, batch_sh), out_shardings=(rep, cache_sh))``, in
    the gather-on-use form of :class:`ShardedTrainStep`.

    ``params`` is a DTensor tree at :attr:`param_shardings` (the serve
    policy's); ``batch`` holds the model's inputs, DTensors at
    :func:`batch_shardings` or whole tensors every rank holds alike.  Each
    call gathers every weight, runs the model's prefill on the rank's batch
    shard (every rank of a batch group computes the same thing), and keeps
    the new caches at :meth:`cache_shardings`' local shards.  The logits
    are the rank's batch rows.  The model's own parameters are not read: a
    model built on meta, or one whose weights were handed over
    (``to_reference(release=True)``), serves."""

    def __call__(self, params, batch: Dict[str, torch.Tensor]):
        shardings = batch_shardings(batch, self.mesh, self.policy)
        local = {k: _local_input(v, shardings[k]) for k, v in batch.items()}
        full = _gather(params)
        logits, caches = self._run("prefill", full, local, self.cache_len)
        del full
        return logits, self._keep_local(caches, batch["tokens"].shape[0],
                                        _batch_entry(shardings["tokens"]))


class ShardedDecode(_Serve):
    """``decode(params, caches, tokens, pos) -> (logits, caches)`` over
    DTensor trees, the counterpart of the reference's serve step
    ``jax.jit(model.decode_step, in_shardings=(param_sh, cache_sh,
    batch_sh), out_shardings=(rep, cache_sh), donate_argnums=(1,))``.

    ``params`` and ``caches`` are DTensor trees at :attr:`param_shardings`
    and :meth:`cache_shardings`; ``tokens`` (B, 1) a DTensor at its batch
    sharding or a whole tensor; ``pos`` the absolute position, a Python int
    (as ``Model.decode_step`` takes it).  Each call gathers every weight and
    each cache leaf's other axes for the rank's batch rows, runs the
    model's decode step on them, and returns the updated caches at their
    shardings' local shards.  A cache leaf split over the batch's axes alone
    is not copied, and is updated in place: the caller's old caches are
    spent, as the reference's donated ones are."""

    def __call__(self, params, caches, tokens: torch.Tensor, pos: int):
        shard = batch_shardings({"tokens": tokens}, self.mesh, self.policy)["tokens"]
        entry = _batch_entry(shard)
        b = tokens.shape[0]
        whole = tree_map(lambda c, spec: c.redistribute(
            self.mesh, _batch_only(spec, entry, self.mesh)).to_local(), caches, self.cache_specs(b))
        full = _gather(params)
        logits, whole = self._run("decode_step", full, whole, _local_input(tokens, shard), pos)
        del full
        return logits, self._keep_local(whole, b, entry)


class ShardedTrainStep:
    """``step(params, opt_state, batch) -> (params, opt_state, metrics)``
    over DTensor trees, the counterpart of the reference's
    ``jax.jit(make_train_step(...), in_shardings=..., out_shardings=...)``.

    ``params`` and ``opt_state`` are DTensor trees at
    :attr:`param_shardings` and :attr:`opt_shardings` (make them with
    :func:`distribute_tree`); each rank holds only its slices between steps.
    ``batch`` is a dict of whole tensors, the same on every rank (what every
    rank's data pipeline yields), or of DTensors at :func:`batch_shardings`;
    the step computes on the rank's shard of it.  Each step:

    1. gathers every weight (``full_tensor()``) and runs the unsharded
       :func:`~repro_torch.train.step.loss_and_grads` on the batch shard, so
       the kernels see plain tensors only; with ``accum_steps`` > 1, on that
       many microbatches of the shard, their gradients summed in float32
       (:func:`~repro_torch.train.step.mean_loss_and_grads`);
    2. averages the loss and the gradients over the mesh axes the batch is
       split over, each shard weighted by its share of the batch's labelled
       tokens (the loss is a mean over them; llava's patches are masked out
       of every row alike, so a shard's count is its labels' size), in
       float32 on one process group (one all-reduce per leaf, so every rank
       holds the same bits); with ``accum_steps`` > 1 the average is then
       cast to bfloat16, as the reference casts the microbatches' mean;
    3. with ``compress_grads``, applies ``fake_quantize`` to the averaged
       gradient, as the reference's step does;
    4. runs ``adamw.update`` on each rank's plain local slices, given the
       whole gradient's norm.

    The replicated metrics (loss, grad norm, lr) are plain tensors, equal
    bit for bit on every rank.  Activations are not split over "model":
    every rank of a batch group computes the same thing.
    """

    def __init__(self, model, opt_cfg: adamw.AdamWConfig, mesh: DeviceMesh,
                 policy: str = "train", compress_grads: bool = False, accum_steps: int = 1):
        self.model, self.opt_cfg, self.mesh, self.policy = model, opt_cfg, mesh, policy
        self.compress_grads, self.accum_steps = compress_grads, accum_steps
        specs = model.param_specs()
        self.param_shardings = tree_shardings(specs, mesh, policy)
        self.opt_shardings = tree_shardings(adamw.opt_state_specs(specs, opt_cfg), mesh, policy)
        self._groups: Dict[Tuple[str, ...], Any] = {}

    def _group(self, axes: Tuple[str, ...]):
        """One process group per set of ranks that differ only along
        ``axes`` (created on first use, by every rank alike, since all
        ranks see the same batch shapes)."""
        if axes not in self._groups:
            names = list(self.mesh.mesh_dim_names)
            dims = [names.index(a) for a in axes]
            rest = [i for i in range(len(names)) if i not in dims]
            ranks = self.mesh.mesh.permute(*rest, *dims).reshape(-1, math.prod(
                self.mesh.size(i) for i in dims))
            self._groups[axes], _ = dist.new_subgroups_by_enumeration(ranks.tolist())
        return self._groups[axes]

    def __call__(self, params, opt_state, batch: Dict[str, torch.Tensor]):
        shardings = batch_shardings(batch, self.mesh, self.policy)
        local_batch = {k: _local_input(v, shardings[k]) for k, v in batch.items()}
        axes = _axes_of(_batch_entry(shardings["labels"]))

        full = _gather(params)
        loss, grads = mean_loss_and_grads(self.model, full, local_batch, self.accum_steps)
        del full
        if axes:
            group = self._group(axes)
            weight = local_batch["labels"].numel() / batch["labels"].numel()

            def _mean(g):
                g32 = g.float() * weight
                dist.all_reduce(g32, group=group)
                return g32.to(g.dtype)

            grads = tree_map(_mean, grads)
            loss = _mean(loss)
        if self.accum_steps > 1:
            grads = tree_map(lambda g: g.to(torch.bfloat16), grads)
        if self.compress_grads:
            grads = compression.fake_quantize_tree(grads)
        grad_norm = adamw.global_norm(grads)

        to_local = lambda t: t.to_local()
        local_grads = tree_map(local_shard, grads, self.param_shardings)
        del grads
        new_p, new_o, metrics = adamw.update(
            local_grads, tree_map(to_local, opt_state), tree_map(to_local, params),
            self.opt_cfg, grad_norm=grad_norm)
        wrap = lambda t, s: DTensor.from_local(t, s.mesh, s.placements, run_check=False)
        return (tree_map(wrap, new_p, self.param_shardings),
                tree_map(wrap, new_o, self.opt_shardings), {**metrics, "loss": loss})


def shard_train_step(model, opt_cfg: adamw.AdamWConfig, mesh: DeviceMesh, policy: str = "train",
                     compress_grads: bool = False, accum_steps: int = 1) -> ShardedTrainStep:
    """The train step of ``make_train_step(model, opt_cfg, accum_steps,
    compress_grads)`` sharded over ``mesh`` by ``policy``'s rules (see
    :class:`ShardedTrainStep`)."""
    return ShardedTrainStep(model, opt_cfg, mesh, policy, compress_grads, accum_steps)
