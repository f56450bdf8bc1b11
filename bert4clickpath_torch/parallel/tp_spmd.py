"""The composed tier: a Megatron-sharded encoder and a row-sharded item
table with the vocab-parallel fused CE on one (data, model) mesh
(counterpart of ``bert4clickpath_tpu/parallel/tp_spmd.py``).

The encoder shards over the model group as in ``parallel/tp.py`` (the TP
encoder of ``parallel/tp_encoder.py``); the item table, its moments and
its EMA row-shard over the same group as in ``parallel/spmd.py``, whose
train and eval steps run unchanged: they look items up through the
sharded lookup and take the loss through the sharded fused CE (the CE
kernels with their ``row_start``), and the encoder they run is the
model's, which :func:`shard_state` replaced by the TP encoder. So a wide
encoder and a large catalog share one mesh.
"""

from __future__ import annotations

from typing import Callable

from bert4clickpath_torch.parallel import spmd, tp
from bert4clickpath_torch.parallel.mesh import Mesh
from bert4clickpath_torch.parallel.tp_encoder import check_divisible
from bert4clickpath_torch.training.train_state import TrainState


def param_specs(params: dict, config) -> dict:
    """The item table's rows (the SPMD layout) and the encoder's TP slices
    (the TP layout) over the model group; everything else replicated."""
    table = spmd.table_name(config)
    return {k: 0 if k == table else tp._tp_spec(k) for k in params}


def shard_state(state: TrainState, model, mesh: Mesh) -> TrainState:
    """This rank's composed state from a full single-device state (the
    same on every rank; the table's rows padded by
    ``spmd.padded_vocab_rows``): the TP encoder with this rank's slices,
    the table's row shard, the moments and the EMA cut alike. Shard before
    building the tier's steps."""
    tp._check_tp_supported(model, mesh, "tp_spmd", embed_impl="xla")
    tp.install_tp_encoder(model, mesh)
    return spmd.shard_by_specs(state, model, mesh, param_specs(state.params, model.config))


def make_tp_spmd_train_step(
    model,
    mesh: Mesh,
    tx,
    schedule: Callable[[int], float],
    label_vocab_size: int,
    ema_decay: float = 0.0,
    steps_per_call: int = 1,
) -> Callable:
    """The composed train step: ``(state, batch, generator=None) -> (state,
    loss)`` with the contract of ``spmd.make_spmd_train_step`` (a state
    from :func:`shard_state`, batches from ``spmd.shard_batch`` or
    ``spmd.shard_stacked_batch``)."""
    check_divisible(model.config, mesh.model_size)
    return spmd.make_spmd_train_step(
        model, mesh, tx, schedule, label_vocab_size, ema_decay=ema_decay, steps_per_call=steps_per_call,
        _tier="tp_spmd",
    )


def make_tp_spmd_eval_step(model, mesh: Mesh, label_vocab_size: int, ks=(5, 10)) -> Callable:
    """The composed eval step: the TP encoder's forward and each shard's
    chunked catalog scan (the stats of ``spmd.make_spmd_eval_step``)."""
    check_divisible(model.config, mesh.model_size)
    return spmd.make_spmd_eval_step(model, mesh, label_vocab_size, ks=ks, _tier="tp_spmd")
