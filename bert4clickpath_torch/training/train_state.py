"""Train state and the train step (counterpart of
``bert4clickpath_tpu/training/train_state.py:33-331``).

Adam(b1=0.9, b2=0.999, eps=1e-9) written by hand (:class:`Adam`), because
the JAX package's optax chain keeps the first moment in bf16 beside an f32
second moment, which ``torch.optim.Adam`` cannot. The LR is applied inside
the step as ``schedule(step) * lr_scale``; ``lr_scale`` is a state field a
trainer shrinks on a validation plateau.

What differs from the JAX package, by design:

* ``state.params`` are the model's own parameters
  (``dict(model.named_parameters())``), and the step updates them, the
  optimizer moments and the EMA in place (``torch.no_grad``), which saves a
  copy of every tensor per step. The step returns a new ``TrainState`` that
  shares them; the old one is stale after the call.
* ``state.step`` is a host integer, so the schedule and Adam's bias
  correction are host floats and the step never waits on the device.
* The dropout RNG is a ``torch.Generator`` the caller passes (None:
  deterministic). It advances with every mask drawn; JAX folds the step
  into one key instead. The bits cannot match JAX's in any case.
* ``make_scan_train_step`` is a Python loop over K batches already on the
  device; it returns the (K,) losses as one tensor without a host sync.
  (PyTorch runs eagerly: there is no program to compile. A CUDA graph of
  the K steps is later work.)
* ``make_eval_step`` runs under ``torch.no_grad()`` with dropout off and
  returns its sums as tensors on the device; with ``steps_per_call`` > 1 it
  is a Python loop over the stacked batch, like the scan train step.
* Sampled softmax (``sampled_softmax_samples``) draws its negatives from a
  ``torch.Generator`` given to ``make_train_step`` (JAX folds 1 into the
  step's key); a caller may also hand one step its negatives.
* No ``axis_name``, ``raw`` or ``donate``: the data-parallel and
  vocab-sharded tiers are ``parallel/spmd.py``.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
from dataclasses import dataclass
from typing import Callable, Optional

import numpy as np
import torch

from bert4clickpath_torch.constants import LABEL_PAD
from bert4clickpath_torch.models.deepseek_v2 import MoE
from bert4clickpath_torch.models.model import head_catalog
from bert4clickpath_torch.ops import metrics as metrics_lib
from bert4clickpath_torch.ops.chunked_eval import chunked_eval_stats, pick_chunk
from bert4clickpath_torch.ops.fused_ce import fused_masked_ce_sums
from bert4clickpath_torch.ops.kernels import adam as adam_kernels
from bert4clickpath_torch.ops.losses import (
    masked_binary_cross_entropy,
    masked_multilabel_cross_entropy,
    masked_softmax_cross_entropy,
    sample_negatives,
    sampled_softmax_ce,
)
from bert4clickpath_torch.utils import profiling

Params = dict[str, torch.Tensor]


@functools.lru_cache(maxsize=None)
def _weak(value: float, dtype: torch.dtype) -> float:
    """``value`` as JAX applies a Python float to an array of ``dtype``: a
    weak type, cast to that dtype first."""
    return torch.tensor(value, dtype=dtype).item()


@dataclass
class AdamState:
    count: int  # optax's ScaleByAdamState.count
    mu: Params  # first moment, in mu_dtype (or the param's dtype)
    nu: Params  # second moment, f32


class Adam:
    """``optax.chain(scale_by_adam(b1, b2, eps, mu_dtype=mu_dtype),
    [add_decayed_weights(weight_decay, mask)], scale(-1.0))`` over a dict of
    named tensors, in optax 0.2.6's order of operations:

        mu = (1 - b1) * g + b1 * mu      (b1 * mu in mu's dtype, sum in f32)
        nu = (1 - b2) * g * g + b2 * nu
        u  = (mu / (1 - b1^t)) / (sqrt(nu / (1 - b2^t)) + eps)
        u += weight_decay * param        (decayed params only)
        u  = -u;  mu stored in mu_dtype

    In ``b1 * mu`` JAX casts the Python float b1 to mu's dtype (a weak
    type), so a bf16 first moment is scaled by bf16(0.9) = 0.8984375 and the
    product rounds to bf16 before the f32 sum; this class does the same.

    The decay mask follows the JAX package: matrices (ndim >= 2) only, and
    not the embedding tables (``embed_*``) or ``positions`` unless
    ``decay_tables``.
    """

    def __init__(
        self, b1: float, b2: float, eps: float, mu_dtype: Optional[torch.dtype] = None,
        weight_decay: float = 0.0, decay_tables: bool = False,
    ):
        self.b1, self.b2, self.eps = b1, b2, eps
        self.mu_dtype = mu_dtype
        self.weight_decay = weight_decay
        self.decay_tables = decay_tables

    def decays(self, name: str, param: torch.Tensor) -> bool:
        if not self.weight_decay:
            return False
        parts = name.split(".")
        is_table = any(p.startswith("embed_") for p in parts) or "positions" in parts
        return param.dim() >= 2 and (self.decay_tables or not is_table)

    def init(self, params: Params) -> AdamState:
        return AdamState(
            count=0,
            mu={k: torch.zeros_like(p, dtype=self.mu_dtype or p.dtype) for k, p in params.items()},
            nu={k: torch.zeros_like(p) for k, p in params.items()},
        )

    def corrections(self, count: int) -> tuple[float, float]:
        """optax's bias corrections 1 - b1**count and 1 - b2**count, in f32."""
        f32 = np.float32
        return float(f32(1) - f32(self.b1) ** f32(count)), float(f32(1) - f32(self.b2) ** f32(count))

    @torch.no_grad()
    def update(self, grads: Params, state: AdamState, params: Params) -> tuple[Params, AdamState]:
        """(updates, new state); the moments are updated in place."""
        count = state.count + 1
        # the division by each correction in the moment's dtype
        bc1, bc2 = self.corrections(count)
        updates = {}
        for name, g in grads.items():
            prev = state.mu[name]
            mu = (1 - self.b1) * g + _weak(self.b1, prev.dtype) * prev
            nu = (1 - self.b2) * (g * g) + self.b2 * state.nu[name]
            u = (mu / bc1) / (torch.sqrt(nu / bc2) + self.eps)
            if self.decays(name, params[name]):
                u = u + self.weight_decay * params[name]
            updates[name] = -1.0 * u
            state.mu[name].copy_(mu)  # rounds to mu_dtype after the update
            state.nu[name].copy_(nu)
        return updates, AdamState(count, state.mu, state.nu)

    @torch.no_grad()
    def apply(
        self, grads: Params, state: AdamState, params: Params, lr: float, lr_scale: torch.Tensor,
    ) -> AdamState:
        """The update added to ``params`` in place at the learning rate ``lr
        * lr_scale`` (a host float, a () f32 tensor); returns the new state,
        whose moments are updated in place.

        Tensors on the CPU take :meth:`update`, then ``p.add_(u * (lr *
        lr_scale))``; tensors on a CUDA device take one pass of the kernel
        (``ops/kernels/adam.py``), which gives the same bits and raises on a
        tensor it does not take."""
        if all(p.device.type == "cpu" for p in params.values()):
            updates, new_state = self.update(grads, state, params)
            lr = lr * lr_scale
            for name, p in params.items():
                p.add_(updates[name] * lr)
            return new_state
        count = state.count + 1
        bc1, bc2 = self.corrections(count)
        names = list(params)
        adam_kernels.adam_step(
            [params[n] for n in names], [grads[n] for n in names], [state.mu[n] for n in names],
            [state.nu[n] for n in names], [self.decays(n, params[n]) for n in names],
            b1=self.b1, b1_mu=_weak(self.b1, state.mu[names[0]].dtype), b2=self.b2, eps=self.eps,
            bc1=bc1, bc2=bc2, weight_decay=self.weight_decay, lr=lr, lr_scale=lr_scale,
        )
        return AdamState(count, state.mu, state.nu)


def make_optimizer(
    cfg, mu_dtype: Optional[torch.dtype] = None, weight_decay: float = 0.0,
    decay_tables: bool = False,
) -> Adam:
    """Adam sans LR from a TrainConfig (``adam_b1``, ``adam_b2``,
    ``adam_eps``); see :class:`Adam` and the JAX ``make_optimizer``."""
    return Adam(cfg.adam_b1, cfg.adam_b2, cfg.adam_eps, mu_dtype, weight_decay, decay_tables)


@dataclass
class TrainState:
    step: int
    params: Params  # the model's parameters, updated in place
    opt_state: AdamState
    lr_scale: torch.Tensor  # () f32, plateau-decayed multiplier
    ema_params: Optional[Params] = None  # EMA shadow of params (None: off)

    @classmethod
    def create(cls, params: Params, tx: Adam, ema: bool = False) -> "TrainState":
        device = next(iter(params.values())).device
        return cls(
            step=0,
            params=params,
            opt_state=tx.init(params),
            lr_scale=torch.ones((), dtype=torch.float32, device=device),
            ema_params={k: p.detach().clone() for k, p in params.items()} if ema else None,
        )

    def replace(self, **changes) -> "TrainState":
        return dataclasses.replace(self, **changes)


def eval_params(state: TrainState) -> Params:
    """Parameters to evaluate/export with: the EMA shadow when enabled."""
    return state.params if state.ema_params is None else state.ema_params


@torch.no_grad()
def ema_update(ema_params: Params, params: Params, step: int, decay: float) -> Params:
    """Ramped EMA, in place: decay_t = min(decay, (1 + t) / (10 + t)) in f32,
    ema = decay_t * ema + (1 - decay_t) * param."""
    f32 = np.float32
    d = np.minimum(f32(decay), (f32(1.0) + f32(step)) / (f32(10.0) + f32(step)))
    keep, take = float(d), float(f32(1.0) - d)
    for name, e in ema_params.items():
        e.mul_(keep).add_(take * params[name].to(e.dtype))
    return ema_params


def fused_head_ce_sums(
    model, batch: dict, generator: Optional[torch.Generator], num_valid: int,
) -> tuple[torch.Tensor, torch.Tensor]:
    """(nll_sum, mask_count) through the fused CE: no (B, P, V) logits.

    ``tied_softmax`` projects onto the item table (+ the optional
    ``tied_out_bias`` spread onto model-space rows); ``softmax`` streams its
    final ``Dense(V)`` weight and bias, rows padded and blinded."""
    head_kind = model.config.head.kind
    if head_kind not in ("tied_softmax", "softmax"):
        raise ValueError(f"fused CE requires a softmax-family head, got {head_kind}")
    gather = model.gather_head_inputs if head_kind == "tied_softmax" else model.head_trunk_outputs
    gathered = gather(batch["features"], batch.get("head_positions"), generator)
    table, bias, row_offset, _ = head_catalog(model.config, dict(model.named_parameters()))
    return fused_masked_ce_sums(gathered, table, batch["labels"], row_offset, num_valid, bias=bias)


def sampled_head_ce_sums(
    model, batch: dict, generator: Optional[torch.Generator], num_valid: int,
    negatives: torch.Tensor,
) -> tuple[torch.Tensor, torch.Tensor]:
    """(nll_sum, mask_count) through sampled softmax (``ops/losses.py``):
    O(N·S·D) instead of O(N·V·D). The same heads and sums contract as
    :func:`fused_head_ce_sums`; ``negatives`` (S,) are label-space ids
    (``sample_negatives``)."""
    head_kind = model.config.head.kind
    if head_kind not in ("tied_softmax", "softmax"):
        raise ValueError(f"sampled softmax requires a softmax-family head, got {head_kind}")
    gather = model.gather_head_inputs if head_kind == "tied_softmax" else model.head_trunk_outputs
    gathered = gather(batch["features"], batch.get("head_positions"), generator)
    table, bias, row_offset, _ = head_catalog(model.config, dict(model.named_parameters()))
    labels = batch["labels"].reshape(-1)
    nll = sampled_softmax_ce(
        gathered.reshape(-1, gathered.shape[-1]), table, labels, row_offset, num_valid, negatives,
        bias=bias,
    )
    return nll.sum(), (labels != LABEL_PAD).float().sum()


def loss_for_head(head_kind: str) -> Callable:
    if head_kind in ("softmax", "tied_softmax"):
        return masked_softmax_cross_entropy
    if head_kind == "binary":
        return masked_binary_cross_entropy
    if head_kind == "multilabel":
        return masked_multilabel_cross_entropy
    raise ValueError(head_kind)


def make_loss_fn(
    model, loss_fn: Optional[Callable] = None, fused_ce_num_valid: Optional[int] = None,
) -> Callable:
    """``(batch, generator, negatives=None) -> scalar loss`` of the train
    step: the fused CE (``fused_ce_num_valid`` = the raw label vocabulary
    size V, softmax-family heads), sampled softmax over ``negatives`` when
    they are given (with ``fused_ce_num_valid``), or dense logits through
    ``loss_fn``; plus each MoE layer's balance loss of that forward
    (``MoE.aux``) where the model has such layers."""
    head_kind = model.config.head.kind
    loss_fn = loss_fn or loss_for_head(head_kind)
    use_fused = fused_ce_num_valid is not None and head_kind in ("tied_softmax", "softmax")
    moe_layers = [m for m in model.modules() if isinstance(m, MoE)]

    def head_loss(batch: dict, generator: Optional[torch.Generator], negatives: Optional[torch.Tensor]):
        if use_fused and negatives is not None:
            total, count = sampled_head_ce_sums(model, batch, generator, fused_ce_num_valid, negatives)
            return total / count.clamp(min=1.0)
        if use_fused:
            total, count = fused_head_ce_sums(model, batch, generator, fused_ce_num_valid)
            return total / count.clamp(min=1.0)
        logits = model(batch["features"], batch.get("head_positions"), generator)
        return loss_fn(logits, batch["labels"])

    def compute_loss(
        batch: dict, generator: Optional[torch.Generator] = None,
        negatives: Optional[torch.Tensor] = None,
    ) -> torch.Tensor:
        loss = head_loss(batch, generator, negatives)
        return loss + sum(m.aux for m in moe_layers) if moe_layers else loss

    return compute_loss


def make_train_step(
    model,
    tx: Adam,
    schedule: Callable[[int], float],
    loss_fn: Optional[Callable] = None,
    fused_ce_num_valid: Optional[int] = None,
    ema_decay: float = 0.0,
    sampled_softmax_samples: Optional[int] = None,
    negatives_generator: Optional[torch.Generator] = None,
) -> Callable:
    """Returns ``(state, batch, generator=None, negatives=None) -> (state,
    loss)``.

    batch: ``{'features': {...}, 'head_positions': (B, P), 'labels':
    (B, P)}`` int32 tensors on the model's device (``data.pipeline.
    to_device``). ``state.params`` must be the model's parameters.
    ``generator``: the dropout RNG (None: no dropout). The loss comes back
    as a device scalar (no host sync).

    sampled_softmax_samples: with ``fused_ce_num_valid`` (it supplies V),
    train on S batch-shared uniform negatives instead of the full catalog
    (``ops/losses.py:sampled_softmax_ce``); eval stays exact. Each step
    draws them from ``negatives_generator`` (default: a generator on the
    model's device seeded with 0) unless the call passes ``negatives``.
    """
    head_kind = model.config.head.kind
    use_fused = fused_ce_num_valid is not None and head_kind in ("tied_softmax", "softmax")
    if sampled_softmax_samples is not None:
        if not use_fused:
            raise ValueError(
                "sampled_softmax_samples requires fused_ce_num_valid (it supplies the "
                "valid-row count) and a softmax-family head"
            )
        if sampled_softmax_samples <= 0:
            raise ValueError("sampled_softmax_samples must be positive")
        if negatives_generator is None:
            device = next(model.parameters()).device
            negatives_generator = torch.Generator(device).manual_seed(0)
    compute_loss = make_loss_fn(model, loss_fn, fused_ce_num_valid)

    @profiling.span("b4cp.step")
    def step(
        state: TrainState, batch: dict, generator: Optional[torch.Generator] = None,
        negatives: Optional[torch.Tensor] = None,
    ):
        names = list(state.params)
        if sampled_softmax_samples is not None and negatives is None:
            negatives = sample_negatives(fused_ce_num_valid, sampled_softmax_samples, negatives_generator)
        loss = compute_loss(batch, generator, negatives)
        grads = dict(zip(names, torch.autograd.grad(loss, [state.params[n] for n in names])))
        return apply_gradients(state, grads, tx, schedule, ema_decay), loss.detach()

    return step


def apply_gradients(
    state: TrainState, grads: Params, tx: Adam, schedule: Callable[[int], float], ema_decay: float = 0.0,
) -> TrainState:
    """One optimizer update in place: Adam at the LR ``schedule(step) *
    lr_scale`` (:meth:`Adam.apply`: one kernel on the card), the EMA;
    returns the state one step on (shared by the single-device step and the
    parallel tiers), in the span ``b4cp.optimizer``."""
    with profiling.span("b4cp.optimizer"):
        opt_state = tx.apply(grads, state.opt_state, state.params, schedule(state.step), state.lr_scale)
        if ema_decay > 0.0:
            if state.ema_params is None:
                raise ValueError("ema_decay > 0 requires TrainState.create(..., ema=True)")
            ema_update(state.ema_params, state.params, state.step, ema_decay)
        return state.replace(step=state.step + 1, opt_state=opt_state)


def dropout_generator(device, seed: int, step: int = 0) -> torch.Generator:
    """The generator a run's dropout draws from, seeded from (seed, step).

    A fresh run (step 0) is seeded with ``seed`` itself. A run resumed at
    step N gets another stream, so its steps do not repeat the masks that
    steps 0, 1, ... of the first run drew, and two resumes from the same
    checkpoint draw the same masks. Counterpart of the JAX step folding
    ``state.step`` into its dropout key; the streams themselves differ."""
    mixed = (int(seed) + int(step) * 0x9E3779B97F4A7C15) % (1 << 63)
    return torch.Generator(device).manual_seed(mixed)


def unstack(stacked: dict, i: int) -> dict:
    """Batch i of a stacked batch (leaves carry a leading (K, ...) axis)."""
    return {
        "features": {k: v[i] for k, v in stacked["features"].items()},
        "head_positions": stacked["head_positions"][i],
        "labels": stacked["labels"][i],
    }


def make_scan_train_step(model, tx: Adam, schedule: Callable[[int], float], **kwargs) -> Callable:
    """Returns ``(state, stacked_batches, generator=None) -> (state, losses)``:
    K train steps over a batch dict whose leaves carry a leading (K, ...)
    axis and already sit on the device. The math is K calls of
    :func:`make_train_step` (kwargs forward to it); ``losses`` is a (K,)
    device tensor, returned without a host sync."""
    return looped(make_train_step(model, tx, schedule, **kwargs))


def looped(step: Callable) -> Callable:
    """``step`` over a stacked batch, one call per leading index:
    ``(state, stacked, generator=None) -> (state, (K,) losses)``."""

    def multi(state: TrainState, stacked: dict, generator: Optional[torch.Generator] = None):
        losses = []
        for i in range(stacked["labels"].shape[0]):
            state, loss = step(state, unstack(stacked, i), generator)
            losses.append(loss)
        return state, torch.stack(losses)

    return multi


@contextlib.contextmanager
def _standing_in(model, params: Params):
    """Run the model on ``params`` (keyed like ``named_parameters()``): where
    they are not the model's own tensors, they replace each parameter's
    ``.data`` until the block ends. No copy, no graph (callers hold
    ``torch.no_grad()``)."""
    own = dict(model.named_parameters())
    if set(params) != set(own):
        raise KeyError(f"params do not match the model's: {sorted(set(params) ^ set(own))}")
    swapped = {k: p.data for k, p in own.items() if params[k] is not p}
    for k in swapped:
        own[k].data = params[k].data
    try:
        yield
    finally:
        for k, data in swapped.items():
            own[k].data = data


def make_eval_step(
    model,
    loss_fn: Optional[Callable] = None,
    ks=(5, 10),
    chunked_num_valid: Optional[int] = None,
    steps_per_call: int = 1,
) -> Callable:
    """Returns ``(params, batch) -> stats``: a dict of **sums** (``loss_sum``,
    ``n``; ``recall@k_sum``, ``ndcg@k_sum`` for the softmax-family heads;
    ``positives_sum``, ``pred_positives_sum``, ``tp_sum`` for the binary
    and multilabel heads) as device tensors, so a pass
    accumulates exactly across batches and fetches once
    (``ops.metrics.merge`` / ``finalize``). Runs without dropout and without
    a graph.

    params: the parameters to evaluate with, keyed like
    ``model.named_parameters()`` (``eval_params(state)``: the model's own,
    or the EMA shadow, which stands in for the model's tensors for the
    length of the call, without a copy).

    chunked_num_valid: for softmax-family heads, evaluate via the chunked
    full-catalog scan (``ops/chunked_eval.py``) instead of dense (B, P, V)
    logits; pass the raw label vocabulary size V. The tied head ranks
    against the item table, the MLP softmax head against its final
    ``Dense(V)`` rows.

    steps_per_call > 1: the step takes a stacked (K, B, ...) batch, loops
    over the leading axis and returns the summed stats, identical to K
    separate calls merged.
    """
    head_kind = model.config.head.kind
    loss_fn = loss_fn or loss_for_head(head_kind)
    chunked = chunked_num_valid is not None and head_kind in ("tied_softmax", "softmax")

    def one(params: Params, batch: dict) -> dict:
        feats, positions, labels = batch["features"], batch.get("head_positions"), batch["labels"]
        if chunked:
            gather = model.gather_head_inputs if head_kind == "tied_softmax" else model.head_trunk_outputs
            gathered = gather(feats, positions)
            table, bias, row_offset, _ = head_catalog(model.config, params)
            return chunked_eval_stats(
                gathered, table, labels, ks=ks, row_offset=row_offset, num_valid=chunked_num_valid,
                # rows bounds the (B*P, chunk) f32 logits tile the scan holds
                chunk=pick_chunk(table.shape[0], rows=gathered.shape[0] * gathered.shape[1]),
                bias=bias,
            )
        logits = model(feats, positions)
        n = (labels != LABEL_PAD).float().sum()
        stats = {"loss_sum": loss_fn(logits, labels) * n, "n": n}
        if head_kind in ("softmax", "tied_softmax"):
            rstats = metrics_lib.ranking_stats(logits, labels, ks=ks)
            rstats.pop("n")
            stats.update(rstats)
        else:
            # binary_stats is elementwise, so it takes (B, C) multi-hot
            # labels unchanged (per-class counts pooled)
            bstats = metrics_lib.binary_stats(logits, labels)
            bstats.pop("n")
            stats.update(bstats)
        return stats

    @torch.no_grad()
    def step(params: Params, batch: dict) -> dict:
        with _standing_in(model, params):
            if steps_per_call <= 1:
                return one(params, batch)
            k = batch["labels"].shape[0]
            return metrics_lib.merge(*(one(params, unstack(batch, i)) for i in range(k)))

    return step
