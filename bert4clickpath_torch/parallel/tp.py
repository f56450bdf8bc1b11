"""The tensor-parallel tier: a Megatron-sharded encoder over the mesh's
model group (counterpart of ``bert4clickpath_tpu/parallel/tp.py``).

The JAX tier annotates the parameters' shardings and lets pjit's
partitioner split the encoder and insert the collectives. Here every rank
runs its own slices explicitly, through the TP encoder
(``parallel/tp_encoder.py``) that :func:`shard_tp_state` installs on the
model, with the same layout:

* ``wq``, ``wk``, ``wv`` and ``ffn1`` column-parallel (each rank owns
  ``num_heads / S`` heads and ``ffn_dim / S`` hidden units), their biases
  sharded with them;
* ``wo`` and ``ffn2`` row-parallel, one sum over the model group after
  each, their biases replicated;
* everything else (tables, LayerNorms, heads) replicated, and Adam's
  moments and the EMA shard with their parameter.

The batch shards over the data group, so the tier composes with data
parallelism on one mesh. The loss is the JAX tier's dense one (logits and
the head's loss, no fused CE; the table stays replicated), and the
semantics are global as in the data-parallel tier
(``spmd.summed_train_step``): loss sums, mask counts and every gradient
summed over the data group only, since f/g already make a replicated
parameter's gradient whole and equal on every model rank. For a vocabulary
too large to replicate, the composed tier is ``parallel/tp_spmd.py``.
"""

from __future__ import annotations

from typing import Callable, Optional

from bert4clickpath_torch.parallel import spmd
from bert4clickpath_torch.parallel.mesh import Mesh
from bert4clickpath_torch.parallel.support import validate_tier
from bert4clickpath_torch.parallel.tp_encoder import TPEncoder, check_divisible
from bert4clickpath_torch.training.train_state import TrainState

# column-parallel projections shard the rows of the torch (out, in) weight
# and their bias; row-parallel ones shard the weight's columns and keep a
# replicated bias
_COL_PARALLEL = ("wq", "wk", "wv", "ffn1")
_ROW_PARALLEL = ("wo", "ffn2")


def _tp_spec(name: str) -> Optional[int]:
    """The dimension of a parameter that shards over the model group, from
    its name (None: replicated)."""
    parts = name.split(".")
    if parts[0] != "encoder" or len(parts) < 3:
        return None
    module, leaf = parts[-2], parts[-1]
    if module in _COL_PARALLEL:
        return 0
    if module in _ROW_PARALLEL and leaf == "weight":
        return 1
    return None


def tp_param_specs(params: dict, config) -> dict:
    """Per parameter, the dimension that shards over the model group: the
    encoder's projections and FFN as in the module docstring, everything
    else replicated. Adam's moments and the EMA take their parameter's spec
    (``spmd.shard_by_specs``)."""
    return {k: _tp_spec(k) for k in params}


def _check_tp_supported(model, mesh: Mesh, tier: str = "tp", **flags) -> None:
    """Heads and FFN divisible by the model group, then the support
    matrix (``flags`` replacing the model's own)."""
    check_divisible(model.config, mesh.model_size)
    validate_tier(tier, model.config.head.kind, **{**spmd._features_flags(model), **flags})


def install_tp_encoder(model, mesh: Mesh) -> None:
    """Replace the model's encoder by an uninitialised TP encoder of this
    rank's slices (same parameter names, same dropout back end)."""
    model.encoder = TPEncoder(model.config, mesh, model.encoder.dropout_impl, device=mesh.device)


def shard_tp_state(state: TrainState, model, mesh: Mesh) -> TrainState:
    """This rank's TP state from a full single-device state (the same on
    every rank): the model takes the TP encoder filled with this rank's
    slices, the Adam moments and the EMA are cut the same way; the returned
    state's params are the model's parameters. Shard before building the
    tier's steps."""
    _check_tp_supported(model, mesh)
    install_tp_encoder(model, mesh)
    return spmd.shard_by_specs(state, model, mesh, tp_param_specs(state.params, model.config))


shard_tp_batch = spmd.shard_batch


def make_tp_train_step(
    model,
    tx,
    schedule: Callable[[int], float],
    mesh: Mesh,
    loss_fn: Optional[Callable] = None,
    ema_decay: float = 0.0,
) -> Callable:
    """The TP train step, any head kind: ``(state, batch, generator=None)
    -> (state, loss)`` on a state from :func:`shard_tp_state` and this
    rank's rows of the global batch (:func:`shard_tp_batch`). The loss is
    the head's (or ``loss_fn``: a masked mean over the labels that are not
    LABEL_PAD) on dense logits, with global semantics; the dropout
    generator is the rank's ``spmd.tier_generator``."""
    check_divisible(model.config, mesh.model_size)
    spmd.check_tier(model, "tp")
    return spmd.summed_train_step(
        lambda batch, generator: spmd.logits_sums(model, batch, generator, loss_fn=loss_fn),
        mesh, tx, schedule, ema_decay,
    )


def make_tp_eval_step(model, mesh: Mesh, ks=(5, 10), **kwargs) -> Callable:
    """The TP eval step: ``(params, batch) -> stats``, the single-device
    eval's sums over the data group (``spmd.summed_eval_step``; kwargs:
    ``loss_fn``, ``chunked_num_valid``)."""
    check_divisible(model.config, mesh.model_size)
    spmd.check_tier(model, "tp")
    return spmd.summed_eval_step(model, mesh, ks, **kwargs)
