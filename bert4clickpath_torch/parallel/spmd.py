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

Dropout: the caller seeds each rank's generator from (seed, data index)
only (:func:`tier_generator`), never from the model index, so the model
ranks of one data group draw the same masks and compute a bitwise-identical
replicated encoder; data ranks decorrelate. The generator advances with
every step, as the single-device step's does.

A step is ``(state, batch, generator=None) -> (state, loss)`` with the
single-device contract (``training/train_state.py``): ``state.params`` are
this rank's model's parameters, updated in place; the batch is this rank's
rows (:func:`shard_batch`); the loss is the global loss on every rank.
"""

from __future__ import annotations

import functools
from typing import Callable, Optional

import torch
import torch.distributed as dist
from torch import nn

from bert4clickpath_torch.constants import LABEL_PAD, NUM_RESERVED_TOKENS
from bert4clickpath_torch.models.model import tied_bias_model_space
from bert4clickpath_torch.ops import losses as losses_lib
from bert4clickpath_torch.ops import metrics as metrics_lib
from bert4clickpath_torch.parallel import embedding as emb_ops
from bert4clickpath_torch.parallel.mesh import DATA_AXIS, MODEL_AXIS, Mesh, all_gather_stacked, sum_flat
from bert4clickpath_torch.parallel.support import validate_tier
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
    """Per parameter, the mesh axis its rows shard over (None: replicated):
    the item table over ``model``, everything else replicated. The Adam
    moments and the EMA shadow shard with their parameter; step, count and
    lr_scale are replicated."""
    return {k: (MODEL_AXIS if k == table_name(config) else None) for k in params}


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
    batch. Gradient = (sum over the data group of the local-sum gradients)
    / (global mask count): the single-device global-mean gradient.

    fused_ce_num_valid: softmax-family heads take each rank's local CE sums
    through the fused-CE kernels (no (B_local, P, V) logits); the reduction
    is unchanged. steps_per_call > 1: a loop over a stacked (K, B_local,
    ...) batch returning (K,) losses."""
    cfg = model.config
    validate_tier("dp", cfg.head.kind, **_features_flags(model))
    if fused_ce_num_valid is not None and cfg.head.kind not in ("tied_softmax", "softmax"):
        raise ValueError("fused_ce_num_valid requires a softmax-family head")

    def step(state: TrainState, batch: dict, generator: Optional[torch.Generator] = None):
        names = list(state.params)
        if fused_ce_num_valid is not None:
            total, count = fused_head_ce_sums(model, batch, generator, fused_ce_num_valid)
            scale = 1.0
        else:
            logits = model(batch["features"], batch.get("head_positions"), generator)
            total, count, scale = _dp_sums_from_logits(cfg.head.kind, logits, batch["labels"], pos_weight)
        grads = torch.autograd.grad(total, [state.params[n] for n in names])
        (total, count), grads = _sum_gradients([total.detach(), count.detach()], list(grads), mesh)
        denom = count.clamp(min=1.0) * scale
        grads = {n: g / denom for n, g in zip(names, grads)}
        return apply_gradients(state, grads, tx, schedule, ema_decay), total / denom

    return step if steps_per_call <= 1 else looped(step)


def make_dp_eval_step(
    model,
    mesh: Mesh,
    ks=(5, 10),
    pos_weight: Optional[float] = None,
    chunked_num_valid: Optional[int] = None,
) -> Callable:
    """Data-parallel eval step: ``(params, batch) -> stats``, the
    single-device ``make_eval_step``'s sums on this rank's rows summed over
    the data group (``psum_stats``). ``chunked_num_valid``: softmax-family
    heads rank their rows by the chunked catalog scan instead of dense
    (B_local, P, V) logits."""
    validate_tier("dp", model.config.head.kind, **_features_flags(model))
    loss_fn = None
    if pos_weight is not None and model.config.head.kind in ("binary", "multilabel"):
        loss_fn = functools.partial(losses_lib.masked_binary_cross_entropy, pos_weight=pos_weight)
    local = make_eval_step(model, loss_fn, ks=ks, chunked_num_valid=chunked_num_valid)

    def step(params: dict, batch: dict) -> dict:
        return metrics_lib.psum_stats(local(params, batch), mesh, DATA_AXIS)

    return step


# -- the vocab-sharded SPMD tier (tied head) ------------------------------


def _table_module(model) -> nn.Embedding:
    return getattr(model, f"embed_{model.config.item_feature}")


def shard_state(state: TrainState, model, mesh: Mesh) -> TrainState:
    """This rank's SPMD state from a full single-device state (the same on
    every rank): the model's replicated parameters take the state's values,
    its item table becomes this rank's row shard (rows ``model_index *
    V_local`` on; the table's rows must divide over the model group, see
    :func:`padded_vocab_rows`), and the Adam moments and EMA are cut the
    same way. The returned state's params are the model's parameters."""
    specs = param_specs(state.params, model.config)
    dev = mesh.device

    def cut(k, t):
        if specs[k] != MODEL_AXIS:
            return t.detach().to(dev).clone()
        if t.shape[0] % mesh.model_size:
            raise ValueError(f"{k}: {t.shape[0]} rows do not divide over {mesh.model_size} model ranks "
                             "(padded_vocab_rows)")
        v_local = t.shape[0] // mesh.model_size
        return t[mesh.model_index * v_local : (mesh.model_index + 1) * v_local].detach().to(dev).clone()

    with torch.no_grad():
        for k, p in model.named_parameters():
            if specs[k] != MODEL_AXIS and state.params[k] is not p:
                p.copy_(state.params[k])
        name = table_name(model.config)
        _table_module(model).weight = nn.Parameter(cut(name, state.params[name]))
    params = dict(model.named_parameters())
    opt = state.opt_state
    return TrainState(
        step=state.step,
        params=params,
        opt_state=AdamState(
            opt.count, {k: cut(k, v) for k, v in opt.mu.items()}, {k: cut(k, v) for k, v in opt.nu.items()}
        ),
        lr_scale=state.lr_scale.detach().to(dev).clone(),
        ema_params=None if state.ema_params is None else {k: cut(k, v) for k, v in state.ema_params.items()},
    )


@torch.no_grad()
def gather_state(state: TrainState, mesh: Mesh, config) -> TrainState:
    """The full single-device state from the shards (on the CPU, the same
    on every rank): the table, its moments and its EMA assembled from the
    model group's shards. For comparisons; not a checkpoint format."""
    specs = param_specs(state.params, config)

    def whole(d: Optional[dict]) -> Optional[dict]:
        if d is None:
            return None
        out = {}
        for k, t in d.items():
            if specs[k] == MODEL_AXIS:
                parts = all_gather_stacked(t.detach().float(), mesh, MODEL_AXIS)
                t = parts.reshape(-1, *t.shape[1:]).to(t.dtype)
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


def _forward_gathered(model, mesh: Mesh, features: dict, head_positions, generator):
    """The model's forward to the (transformed) head inputs with the item
    table row-sharded: (gathered (B, P, d_item) f32, the table shard). The
    item lookup goes through the sharded lookup; everything else is the
    single-device model's."""
    table_shard = _table_module(model).weight

    def lookup(ids):
        return emb_ops.sharded_embedding_lookup(table_shard, ids, mesh, model.dtype)

    return model.gather_head_inputs(features, head_positions, generator, item_lookup=lookup), table_shard


def _check_spmd(model) -> None:
    validate_tier("spmd", model.config.head.kind, **{**_features_flags(model), "embed_impl": "xla"})


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
) -> Callable:
    """The vocab-sharded train step of the tied head: ``(state, batch,
    generator=None) -> (state, loss)`` on a state from :func:`shard_state`
    and this rank's rows of the global batch. The loss is the sharded fused
    CE (with ``tied_bias``, the bias-carrying one), already the global mean,
    so every gradient is summed over the data group. The table shard's
    gradient and its Adam update stay on the rank that owns the rows.
    steps_per_call > 1: a loop over a stacked batch returning (K,)
    losses."""
    _check_spmd(model)
    cfg = model.config

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


def make_spmd_eval_step(model, mesh: Mesh, label_vocab_size: int, ks=(5, 10)) -> Callable:
    """The vocab-sharded eval step: ``(params, batch) -> stats`` of sums over
    the whole mesh; each shard scans its rows in chunks
    (``sharded_chunked_eval_stats``), so no (B, P, V_local) tile exists.
    ``params``: this rank's sharded parameters (or its EMA shard)."""
    _check_spmd(model)
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
