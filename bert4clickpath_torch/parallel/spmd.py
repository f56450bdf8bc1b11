"""The data-parallel tier and the vocab-sharded SPMD tier over a (data,
model) mesh (counterpart of ``bert4clickpath_tpu/parallel/spmd.py``).

One process per mesh position (``parallel/mesh.py``), each with its own
``ClickstreamModel`` on its device. Every collective is explicit, an
``all_reduce`` outside autograd:

* **DP** (:func:`make_dp_train_step`, any head kind): parameters
  replicated, each rank takes its rows of the global batch, computes LOCAL
  loss sums and their gradients, and sums the loss, the mask count and the
  gradients over the data group; the gradient is then divided by the
  global count: exactly the single-device global-mean gradient (never a
  mean of per-shard means, which is wrong when shard mask counts differ).
* **SPMD** (:func:`make_spmd_train_step`, the tied head): the item table
  and its Adam moments (and EMA) are row-sharded over the model group (each
  rank holds ``V / model`` rows of the padded table, :func:`shard_state`);
  everything else is replicated. Lookups go through
  ``parallel/embedding.py:sharded_embedding_lookup``, the loss through
  ``parallel/embedding.py:sharded_fused_softmax_ce`` (the CE kernels with their
  ``row_start``), which is already the global mean, so the gradients are
  summed (not averaged) over the data group.
* **Sampled SPMD** (:func:`make_sampled_spmd_train_step`, the
  softmax-family heads): the SPMD layout, trained on sampled softmax
  whose label and negative rows come through the sharded lookup.

The tensor-parallel tiers (``parallel/tp.py``, ``parallel/tp_spmd.py``)
build on this module: their steps are :func:`summed_train_step` and
:func:`make_spmd_train_step` on a model carrying the TP encoder.

Dropout: the caller seeds each rank's generator from (seed, data index)
only (:func:`tier_generator`), never from the model index, so the model
ranks of one data group draw the same masks and compute a bitwise-identical
replicated encoder; data ranks decorrelate. The generator advances with
every step, as the single-device step's does.

A step is ``(state, batch, generator=None) -> (state, loss)`` with the
single-device contract (``training/train_state.py``): ``state.params`` are
this rank's model's parameters, updated in place; the batch is this rank's
rows (:func:`shard_batch`); the loss is the global loss on every rank.

A state is built from a full single-device state (:func:`shard_state`), or,
where the table is too large for one, in place (:func:`init_sharded_state`:
each rank draws its own rows and no rank ever holds the whole table). A
sharded state is checkpointed as the JAX package does it: gathered to a
full state on the host, saved by one rank (:func:`save_sharded_checkpoint`),
restored into a full state on every rank and cut again by the tier's shard
function (:func:`restore_sharded_state`).
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Callable, Optional

import numpy as np
import torch
import torch.distributed as dist
from torch import nn

from bert4clickpath_torch.config import FeatureConfig
from bert4clickpath_torch.constants import LABEL_PAD, NUM_RESERVED_TOKENS
from bert4clickpath_torch.models.model import ClickstreamModel, head_catalog, init_state_dict, tied_bias_model_space
from bert4clickpath_torch.ops import losses as losses_lib
from bert4clickpath_torch.ops import metrics as metrics_lib
from bert4clickpath_torch.parallel import embedding as emb_ops
from bert4clickpath_torch.parallel.mesh import DATA_AXIS, MODEL_AXIS, Mesh, all_gather_stacked, sum_flat
from bert4clickpath_torch.parallel.support import validate_tier
from bert4clickpath_torch.parallel.tp_encoder import TPEncoder
from bert4clickpath_torch.training.checkpoint import latest_checkpoint, restore_state, save_checkpoint
from bert4clickpath_torch.training.train_state import (
    AdamState,
    TrainState,
    _standing_in,
    apply_gradients,
    dropout_generator,
    fused_head_ce_sums,
    looped,
    make_eval_step,
)
from bert4clickpath_torch.utils import profiling


def round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def padded_vocab_rows(vocab_rows: int, model_shards: int, kernel_tile: int = 1024) -> int:
    """Table rows padded so that the row shards are equal and each is a
    multiple of ``kernel_tile`` rows; the extra rows are blinded."""
    per_shard = round_up(-(-vocab_rows // model_shards), kernel_tile)
    return per_shard * model_shards


def table_name(config) -> str:
    """The parameter the SPMD tier row-shards: the item feature's table."""
    return f"embed_{config.item_feature}.weight"


def param_specs(params: dict, config) -> dict:
    """Per parameter, the dimension that shards over the model group (None:
    replicated): the item table's rows, everything else replicated. The
    Adam moments and the EMA shadow shard with their parameter; step, count
    and lr_scale are replicated."""
    return {k: (0 if k == table_name(config) else None) for k in params}


def tier_generator(mesh: Mesh, seed: int, step: int = 0) -> torch.Generator:
    """The dropout generator of this rank: seeded from (seed, data index,
    step), never from the model index."""
    return dropout_generator(mesh.device, int(seed) * 1_000_003 + mesh.data_index, step)


def _features_flags(model) -> dict:
    """The support matrix's impl flags of a port model: attention always
    runs the hand-written kernels (the JAX package's ``pallas``)."""
    cfg = model.config
    single_gather = len(cfg.features) == 1 and model.input_proj is None
    return dict(
        attn_impl="pallas",
        dropout_impl="pallas" if model.encoder.dropout_impl == "fused" else "xla",
        embed_impl="pallas" if single_gather else "xla",
        qkv_fused=cfg.qkv_fused,
        block="bert4rec" if cfg.block is None else "deepseek_v2",
    )


TP_TIERS = ("tp", "tp_spmd")


def check_tier(model, tier: str, **flags) -> None:
    """Validate ``tier`` for the model against the support matrix (``flags``
    replacing the model's own), and check that the model carries the
    encoder the tier runs: the tensor-parallel tiers the TP encoder that
    their shard function installs (so the state is sharded before the step
    is built), every other tier the single-device encoder."""
    validate_tier(tier, model.config.head.kind, **{**_features_flags(model), **flags})
    if isinstance(model.encoder, TPEncoder) != (tier in TP_TIERS):
        raise ValueError(
            f"tier {tier!r}: the model's encoder is tensor-parallel" if tier not in TP_TIERS
            else f"tier {tier!r}: shard the state with the tier's shard function before building its steps"
        )


# -- batches ---------------------------------------------------------------


def _rows(t, lo: int, hi: int, axis: int):
    if t is None:
        return None
    return t[lo:hi] if axis == 0 else t[:, lo:hi]


def _shard(batch: dict, mesh: Mesh, axis: int) -> dict:
    b = batch["labels"].shape[axis]
    if b % mesh.data_size:
        raise ValueError(f"batch of {b} rows does not divide over {mesh.data_size} data ranks")
    per = b // mesh.data_size
    lo, hi = mesh.data_index * per, (mesh.data_index + 1) * per
    return {
        "features": {k: _rows(v, lo, hi, axis) for k, v in batch["features"].items()},
        "head_positions": _rows(batch.get("head_positions"), lo, hi, axis),
        "labels": _rows(batch["labels"], lo, hi, axis),
    }


def shard_batch(batch: dict, mesh: Mesh) -> dict:
    """This rank's rows of a global batch dict (its data index's slice);
    the same on every model rank."""
    return _shard(batch, mesh, 0)


def shard_stacked_batch(batch: dict, mesh: Mesh) -> dict:
    """This rank's rows of a stacked (K, B, ...) batch."""
    return _shard(batch, mesh, 1)


def _sum_gradients(loss_sums: list, grads: list, mesh: Mesh) -> tuple[list, list]:
    """The loss sums and every gradient summed over the data group, in one
    ``all_reduce`` of a packed f32 buffer."""
    out = sum_flat(loss_sums + grads, mesh, DATA_AXIS)
    return out[: len(loss_sums)], out[len(loss_sums) :]


def summed_train_step(
    local_sums: Callable, mesh: Mesh, tx, schedule: Callable[[int], float], ema_decay: float = 0.0,
    steps_per_call: int = 1,
) -> Callable:
    """The train step of every tier whose loss is one global mean over the
    data group (DP, TP, sampled SPMD): ``local_sums(batch, generator,
    *extra) -> (loss_sum, count, scale)`` on this rank's rows, with no
    collective; the sums and every gradient are summed over the data group
    (never the model group: a replicated parameter's gradient is already
    whole on every model rank) and the gradient is divided by the global
    count times ``scale``: exactly the single-device global-mean gradient,
    never a mean of per-shard means. ``(state, batch, generator=None,
    *extra) -> (state, loss)``; steps_per_call > 1: a loop over a stacked
    (K, B_local, ...) batch returning (K,) losses."""

    def step(state: TrainState, batch: dict, generator: Optional[torch.Generator] = None, *extra):
        names = list(state.params)
        total, count, scale = local_sums(batch, generator, *extra)
        grads = torch.autograd.grad(total, [state.params[n] for n in names])
        (total, count), grads = _sum_gradients([total.detach(), count.detach()], list(grads), mesh)
        denom = count.clamp(min=1.0) * scale
        grads = {n: g / denom for n, g in zip(names, grads)}
        return apply_gradients(state, grads, tx, schedule, ema_decay), total / denom

    return step if steps_per_call <= 1 else looped(step)


def summed_eval_step(model, mesh: Mesh, ks=(5, 10), loss_fn: Optional[Callable] = None,
                     chunked_num_valid: Optional[int] = None) -> Callable:
    """``(params, batch) -> stats``: the single-device ``make_eval_step``'s
    sums on this rank's rows summed over the data group
    (``psum_stats``)."""
    local = make_eval_step(model, loss_fn, ks=ks, chunked_num_valid=chunked_num_valid)

    def step(params: dict, batch: dict) -> dict:
        return metrics_lib.psum_stats(local(params, batch), mesh, DATA_AXIS)

    return step


# -- the pure data-parallel tier (any head kind) --------------------------


@torch.no_grad()
def replicate_state(state: TrainState, mesh: Mesh) -> TrainState:
    """Make every data rank's state equal to the first data rank's, by a
    broadcast of each parameter, moment and EMA tensor (the DP placement)."""
    if mesh.data_size == 1:
        return state
    src = mesh.model_index  # global rank of (data 0, this model index)
    tensors = list(state.params.values()) + list(state.opt_state.mu.values()) + list(state.opt_state.nu.values())
    if state.ema_params is not None:
        tensors += list(state.ema_params.values())
    tensors.append(state.lr_scale)
    for t in tensors:
        dist.broadcast(t.data, src=src, group=mesh.data_group)
    return state


def _dp_sums_from_logits(head_kind: str, logits, labels, pos_weight):
    """(loss_sum, count, scale) on this rank; no collective."""
    if head_kind in ("softmax", "tied_softmax"):
        items = losses_lib.softmax_ce_items(logits, labels)
        weights, scale = None, 1.0
    else:
        items, weights, scale = losses_lib.binary_ce_items(logits, labels, pos_weight=pos_weight)
    mask = (labels != LABEL_PAD).to(items.dtype)
    if weights is not None:
        items = items * weights
    return (items * mask).sum(), mask.sum(), scale


def logits_sums(model, batch: dict, generator, pos_weight: Optional[float] = None,
                loss_fn: Optional[Callable] = None):
    """(loss_sum, count, scale) of the model's dense logits on this rank's
    rows: the head's own loss, or ``loss_fn(logits, labels)``, a masked
    mean over the labels that are not LABEL_PAD (every loss of
    ``ops/losses.py`` is one), times that count."""
    logits = model(batch["features"], batch.get("head_positions"), generator)
    labels = batch["labels"]
    if loss_fn is None:
        return _dp_sums_from_logits(model.config.head.kind, logits, labels, pos_weight)
    count = (labels != LABEL_PAD).float().sum()
    return loss_fn(logits, labels) * count, count, 1.0


def make_dp_train_step(
    model,
    mesh: Mesh,
    tx,
    schedule: Callable[[int], float],
    pos_weight: Optional[float] = None,
    ema_decay: float = 0.0,
    fused_ce_num_valid: Optional[int] = None,
    steps_per_call: int = 1,
) -> Callable:
    """Data-parallel train step for any head kind: ``(state, batch,
    generator=None) -> (state, loss)`` over this rank's rows of the global
    batch (:func:`summed_train_step`).

    fused_ce_num_valid: softmax-family heads take each rank's local CE sums
    through the fused-CE kernels (no (B_local, P, V) logits); the reduction
    is unchanged. steps_per_call > 1: a loop over a stacked (K, B_local,
    ...) batch returning (K,) losses."""
    cfg = model.config
    check_tier(model, "dp")
    if fused_ce_num_valid is not None and cfg.head.kind not in ("tied_softmax", "softmax"):
        raise ValueError("fused_ce_num_valid requires a softmax-family head")

    def local_sums(batch: dict, generator):
        if fused_ce_num_valid is None:
            return logits_sums(model, batch, generator, pos_weight)
        total, count = fused_head_ce_sums(model, batch, generator, fused_ce_num_valid)
        return total, count, 1.0

    return summed_train_step(local_sums, mesh, tx, schedule, ema_decay, steps_per_call)


def make_dp_eval_step(
    model,
    mesh: Mesh,
    ks=(5, 10),
    pos_weight: Optional[float] = None,
    chunked_num_valid: Optional[int] = None,
) -> Callable:
    """Data-parallel eval step: ``(params, batch) -> stats``
    (:func:`summed_eval_step`). ``chunked_num_valid``: softmax-family heads
    rank their rows by the chunked catalog scan instead of dense
    (B_local, P, V) logits."""
    check_tier(model, "dp")
    loss_fn = None
    if pos_weight is not None and model.config.head.kind in ("binary", "multilabel"):
        loss_fn = functools.partial(losses_lib.masked_binary_cross_entropy, pos_weight=pos_weight)
    return summed_eval_step(model, mesh, ks, loss_fn, chunked_num_valid)


# -- the vocab-sharded SPMD tier (tied head) ------------------------------


def _table_module(model) -> nn.Embedding:
    return getattr(model, f"embed_{model.config.item_feature}")


def _cut(name: str, t: torch.Tensor, dim: Optional[int], mesh: Mesh) -> torch.Tensor:
    """This rank's slice of ``t`` along ``dim`` (None: a copy of all of it)
    on the mesh's device."""
    if dim is not None:
        if t.shape[dim] % mesh.model_size:
            raise ValueError(f"{name}: {t.shape[dim]} along dimension {dim} does not divide over "
                             f"{mesh.model_size} model ranks (padded_vocab_rows for a table)")
        n = t.shape[dim] // mesh.model_size
        t = t.narrow(dim, mesh.model_index * n, n)
    return t.detach().to(mesh.device).contiguous().clone()


def shard_by_specs(state: TrainState, model, mesh: Mesh, specs: dict) -> TrainState:
    """This rank's state from a full single-device state (the same on every
    rank): each parameter whose spec names a dimension becomes this rank's
    slice along it (a new parameter of the model), every other one takes
    the state's values; the Adam moments and the EMA are cut the same way.
    The returned state's params are the model's parameters."""
    with torch.no_grad():
        for k, p in dict(model.named_parameters()).items():
            if specs[k] is None:
                if state.params[k] is not p:
                    p.copy_(state.params[k])
                continue
            owner, _, leaf = k.rpartition(".")
            setattr(model.get_submodule(owner), leaf, nn.Parameter(_cut(k, state.params[k], specs[k], mesh)))
    cut = lambda d: {k: _cut(k, v, specs[k], mesh) for k, v in d.items()}  # noqa: E731
    opt = state.opt_state
    return TrainState(
        step=state.step,
        params=dict(model.named_parameters()),
        opt_state=AdamState(opt.count, cut(opt.mu), cut(opt.nu)),
        lr_scale=state.lr_scale.detach().to(mesh.device).clone(),
        ema_params=None if state.ema_params is None else cut(state.ema_params),
    )


def shard_state(state: TrainState, model, mesh: Mesh) -> TrainState:
    """This rank's SPMD state from a full single-device state: the item
    table becomes this rank's row shard (rows ``model_index * V_local`` on;
    the table's rows must divide over the model group, see
    :func:`padded_vocab_rows`), everything else is replicated."""
    return shard_by_specs(state, model, mesh, param_specs(state.params, model.config))


@torch.no_grad()
def gather_state(state: TrainState, mesh: Mesh, config, specs: Optional[dict] = None) -> TrainState:
    """The full single-device state from the shards (on the CPU, the same
    on every rank): each sharded parameter, its moments and its EMA
    assembled from the model group's slices along the dimension of its spec
    (``specs``: a tier's ``param_specs``; default this tier's). What
    :func:`save_sharded_checkpoint` saves, and what runs are compared on."""
    if specs is None:
        specs = param_specs(state.params, config)

    def whole(d: Optional[dict]) -> Optional[dict]:
        if d is None:
            return None
        out = {}
        for k, t in d.items():
            if specs[k] is not None:
                parts = all_gather_stacked(t.detach().float(), mesh, MODEL_AXIS)
                t = torch.cat(list(parts.unbind(0)), dim=specs[k]).to(t.dtype)
            out[k] = t.detach().cpu().clone()
        return out

    opt = state.opt_state
    return TrainState(
        step=state.step,
        params=whole(state.params),
        opt_state=AdamState(opt.count, whole(opt.mu), whole(opt.nu)),
        lr_scale=state.lr_scale.detach().cpu().clone(),
        ema_params=whole(state.ema_params),
    )


def save_sharded_checkpoint(directory: str, state: TrainState, mesh: Mesh, config, specs: Optional[dict] = None,
                            keep: Optional[int] = None) -> str:
    """Checkpoint a sharded state (every rank calls it): the full state
    gathered to the host (:func:`gather_state` with the tier's ``specs``:
    parameters, both Adam moments in their dtypes, Adam's count, ``step``,
    ``lr_scale``, the EMA), written by rank 0 with
    ``training/checkpoint.py:save_checkpoint`` while the other ranks wait on
    a barrier. Returns the checkpoint's path on every rank."""
    whole = gather_state(state, mesh, config, specs)
    if mesh.rank == 0:
        save_checkpoint(directory, whole, whole.step, keep=keep)
    dist.barrier()
    return latest_checkpoint(directory)


def restore_sharded_state(path: str, model, mesh: Mesh, tx, shard_fn: Callable = None,
                          ema: bool = False) -> TrainState:
    """This rank's state from a checkpoint of :func:`save_sharded_checkpoint`:
    ``restore_state`` fills a full state of the model's configuration on the
    host (it restores in place, so into the full shapes, never a shard), and
    the tier's shard function (``shard_fn(state, model, mesh)``, default
    :func:`shard_state`) cuts it onto ``model``, a freshly built one. Build
    the tier's steps on ``model`` afterwards."""
    template = ClickstreamModel(model.config, device="cpu")
    full = restore_state(path, TrainState.create(dict(template.named_parameters()), tx, ema=ema))
    return (shard_fn or shard_state)(full, model, mesh)


def init_sharded_state(config, mesh: Mesh, tx, seed: int = 0, weights: Optional[dict] = None,
                       dropout_impl: str = "mask", ema: bool = False) -> tuple:
    """(model, state) of this rank for the SPMD tier of a tied-softmax
    config, built without the whole table ever existing (the counterpart of
    ``examples/large_catalog/stress.py:111-131``, which draws the table
    shard by shard under ``out_shardings=P("model", None)``).

    The model is built on a throwaway config whose item table has one row
    past the reserved ones, and its table parameter is then replaced by this
    rank's rows ``[model_index * V_local, (model_index + 1) * V_local)``:
    drawn as N(0, 0.02^2) f32 from a generator keyed by (``seed``, model
    index) on the mesh's device, so the data ranks of one model index hold
    the same rows. Every other parameter takes the flax-style initial
    weights of ``models/model.py:init_state_dict`` on the throwaway config
    (the same on every rank). Adam's moments (and the EMA) are made at the
    shard's shape. ``weights``: a full state ({name: numpy array}, keyed
    like ``named_parameters()``, the table padded) to start from instead;
    only this rank's rows of its table are copied to the device."""
    if config.head.kind != "tied_softmax":
        raise ValueError("init_sharded_state builds the tied head's row-sharded table")
    name = table_name(config)
    fc = config.features[config.item_feature]
    if fc.vocab_rows % mesh.model_size:
        raise ValueError(f"{fc.vocab_rows} table rows do not divide over {mesh.model_size} model ranks "
                         "(padded_vocab_rows)")
    v_local = fc.vocab_rows // mesh.model_size
    lo = mesh.model_index * v_local
    # the throwaway config keeps the head's label count (tied_out_bias)
    small = dataclasses.replace(
        config,
        features={**config.features, config.item_feature: FeatureConfig(NUM_RESERVED_TOKENS + 1, fc.embedding_dim)},
        head=dataclasses.replace(config.head,
                                 output_size=config.head.output_size or fc.vocab_rows - NUM_RESERVED_TOKENS - 1),
    )
    model = ClickstreamModel(small, device=mesh.device, dropout_impl=dropout_impl)
    if weights is None:
        init = init_state_dict(small, seed)
        generator = torch.Generator(mesh.device).manual_seed(int(seed) * 1_000_003 + mesh.model_index)
        shard = torch.randn((v_local, fc.embedding_dim), generator=generator, device=mesh.device).mul_(0.02)
    else:
        init = {k: torch.from_numpy(np.asarray(v)) for k, v in weights.items() if k != name}
        shard = torch.from_numpy(np.ascontiguousarray(weights[name][lo : lo + v_local])).to(mesh.device)
    with torch.no_grad():
        for k, p in model.named_parameters():
            if k != name:
                p.copy_(init[k])
    owner, _, leaf = name.rpartition(".")
    setattr(model.get_submodule(owner), leaf, nn.Parameter(shard))
    model.config = config
    return model, TrainState.create(dict(model.named_parameters()), tx, ema=ema)


def sharded_item_lookup(model, mesh: Mesh, compute_dtype=None) -> Callable:
    """ids -> rows of the item table through the row-sharded lookup."""
    table_shard = _table_module(model).weight
    return lambda ids: emb_ops.sharded_embedding_lookup(table_shard, ids, mesh, compute_dtype)


def _forward_gathered(model, mesh: Mesh, features: dict, head_positions, generator):
    """The model's forward to the (transformed) head inputs with the item
    table row-sharded: (gathered (B, P, d_item) f32, the table shard). The
    item lookup goes through the sharded lookup; everything else, the
    encoder included (the single-device one, or the TP encoder of the
    composed tier), is the model's."""
    gathered = model.gather_head_inputs(
        features, head_positions, generator, item_lookup=sharded_item_lookup(model, mesh, model.dtype)
    )
    return gathered, _table_module(model).weight


def _full_bias(model, v_local: int, mesh: Mesh) -> torch.Tensor:
    """The replicated (V_label,) ``tied_out_bias`` on the padded table's
    model-space rows (every shard's rows)."""
    return tied_bias_model_space(model.tied_out_bias, v_local * mesh.model_size)


def make_spmd_train_step(
    model,
    mesh: Mesh,
    tx,
    schedule: Callable[[int], float],
    label_vocab_size: int,
    ema_decay: float = 0.0,
    steps_per_call: int = 1,
    _tier: str = "spmd",
) -> Callable:
    """The vocab-sharded train step of the tied head: ``(state, batch,
    generator=None) -> (state, loss)`` on a state from :func:`shard_state`
    and this rank's rows of the global batch. The loss is the sharded fused
    CE (with ``tied_bias``, the bias-carrying one), already the global mean,
    so every gradient is summed over the data group. The table shard's
    gradient and its Adam update stay on the rank that owns the rows.
    steps_per_call > 1: a loop over a stacked batch returning (K,)
    losses.

    ``_tier``: the tier the caller validates for. The composed tier
    (``parallel/tp_spmd.py``) runs this step on a model whose shard
    function installed the TP encoder; the encoder is the model's, so
    nothing else changes (the port's counterpart of the JAX step's
    ``_encoder``/``_specs_fn`` hooks)."""
    check_tier(model, _tier, embed_impl="xla")
    cfg = model.config

    @profiling.span("b4cp.step")
    def step(state: TrainState, batch: dict, generator: Optional[torch.Generator] = None):
        names = list(state.params)
        gathered, table_shard = _forward_gathered(
            model, mesh, batch["features"], batch.get("head_positions"), generator
        )
        if gathered.shape[-1] != table_shard.shape[-1]:
            raise ValueError("the tied SPMD head requires the head width to equal the item embedding width")
        if cfg.head.tied_bias:
            loss = emb_ops.sharded_fused_softmax_ce_bias(
                gathered, table_shard, _full_bias(model, table_shard.shape[0], mesh), batch["labels"],
                NUM_RESERVED_TOKENS, label_vocab_size, mesh,
            )
        else:
            loss = emb_ops.sharded_fused_softmax_ce(
                gathered, table_shard, batch["labels"], NUM_RESERVED_TOKENS, label_vocab_size, mesh
            )
        grads = torch.autograd.grad(loss, [state.params[n] for n in names])
        _, grads = _sum_gradients([], list(grads), mesh)
        return apply_gradients(state, dict(zip(names, grads)), tx, schedule, ema_decay), loss.detach()

    return step if steps_per_call <= 1 else looped(step)


def make_spmd_eval_step(model, mesh: Mesh, label_vocab_size: int, ks=(5, 10), _tier: str = "spmd") -> Callable:
    """The vocab-sharded eval step: ``(params, batch) -> stats`` of sums over
    the whole mesh; each shard scans its rows in chunks
    (``sharded_chunked_eval_stats``), so no (B, P, V_local) tile exists.
    ``params``: this rank's sharded parameters (or its EMA shard).
    ``_tier``: as :func:`make_spmd_train_step`."""
    check_tier(model, _tier, embed_impl="xla")
    cfg = model.config

    @torch.no_grad()
    def step(params: dict, batch: dict) -> dict:
        with _standing_in(model, params):
            gathered, table_shard = _forward_gathered(
                model, mesh, batch["features"], batch.get("head_positions"), None
            )
            v_local = table_shard.shape[0]
            bias_shard = None
            if cfg.head.tied_bias:
                lo = emb_ops.shard_row_start(mesh, v_local)
                bias_shard = _full_bias(model, v_local, mesh)[lo : lo + v_local]
            return emb_ops.sharded_chunked_eval_stats(
                gathered, table_shard, batch["labels"], mesh, ks=ks, row_offset=NUM_RESERVED_TOKENS,
                num_valid=label_vocab_size, bias_shard=bias_shard,
            )

    return step


# -- sampled softmax over the row-sharded table ---------------------------


def negatives_generator(device, seed: int = 0) -> torch.Generator:
    """The generator of the sampled tier's negatives: seeded from ``seed``
    alone, never from a mesh index, so that every rank of the world draws
    the same batch-shared negatives each step (JAX's single program draws
    one set)."""
    return torch.Generator(device).manual_seed(int(seed))


def make_sampled_spmd_train_step(
    model,
    mesh: Mesh,
    tx,
    schedule: Callable[[int], float],
    num_valid: int,
    num_samples: int,
    ema_decay: float = 0.0,
    negatives_from: Optional[torch.Generator] = None,
) -> Callable:
    """Sampled-softmax training over the row-sharded table (counterpart of
    JAX ``make_sampled_spmd_train_step``): ``(state, batch, generator=None,
    negatives=None) -> (state, loss)`` on a state from :func:`shard_state`
    and this rank's rows of the global batch, for the softmax-family heads.

    The item table and its moments are row-sharded; the input lookups go
    through the sharded lookup. The tied head takes the labels' and the
    negatives' rows through the same lookup (a masked take and a sum over
    the model group; the gradient lands on the owning shard only), with
    ``tied_out_bias`` replicated; the MLP softmax head's output layer stays
    replicated and is taken from directly. The loss is
    ``ops/losses.py:sampled_softmax_ce``, plain PyTorch as it is plain XLA
    in the JAX package (no CE kernel), reduced as :func:`summed_train_step`
    reduces. Each step without ``negatives`` draws ``num_samples`` from
    ``negatives_from`` (default :func:`negatives_generator` with seed 0, as
    the single-device step's default), the same on every rank."""
    check_tier(model, "sampled_spmd", embed_impl="xla", sampled=num_samples)
    cfg = model.config
    if negatives_from is None:
        negatives_from = negatives_generator(mesh.device)

    def local_sums(batch: dict, generator, negatives: Optional[torch.Tensor] = None):
        if negatives is None:
            negatives = losses_lib.sample_negatives(num_valid, num_samples, negatives_from)
        features, positions = batch["features"], batch.get("head_positions")
        lookup = sharded_item_lookup(model, mesh, model.dtype)
        if cfg.head.kind == "tied_softmax":
            x = model.gather_head_inputs(features, positions, generator, item_lookup=lookup)
            table = _table_module(model).weight
            bias = _full_bias(model, table.shape[0], mesh) if cfg.head.tied_bias else None
            row_offset, take = NUM_RESERVED_TOKENS, sharded_item_lookup(model, mesh)
        else:
            x = model.head_trunk_outputs(features, positions, generator, item_lookup=lookup)
            table, bias, row_offset, _ = head_catalog(cfg, dict(model.named_parameters()))
            take = None
        labels = batch["labels"].reshape(-1)
        nll = losses_lib.sampled_softmax_ce(
            x.reshape(-1, x.shape[-1]), table, labels, row_offset, num_valid, negatives, bias=bias, take=take,
        )
        return nll.sum(), (labels != LABEL_PAD).float().sum(), 1.0

    return summed_train_step(local_sums, mesh, tx, schedule, ema_decay)
