"""The single-device train step of a DeepSeek-V2 configuration with the
program's input pipeline.

The program's ``ModelConfig`` with a ``DeepSeekV2Config`` block, built from
the configuration file's published keys, through the same factories as
``single_train.py``: ``make_train_step`` with the fused CE
(``fused_ce_num_valid`` = the catalog), Adam and a constant learning rate,
fed by ``ClozeDataset.train_batches`` (the native batcher) through
``to_device`` and ``prefetch_to_device``. The program names its parameters
as the reference does, so the layout is the identity.
"""

from __future__ import annotations

import torch

from bert4clickpath_torch.config import DeepSeekV2Config, FeatureConfig, HeadConfig, ModelConfig
from bert4clickpath_torch.data.pipeline import ClozeDataset, prefetch_to_device, to_device
from bert4clickpath_torch.models.model import ClickstreamModel
from bert4clickpath_torch.training import schedules
from bert4clickpath_torch.training.train_state import Adam, TrainState, make_train_step
from bert4clickpath_torch.vocab import Vocabulary

from portbench.harness import manifest
from portbench.harness import traffic as traffic_lib
from portbench.harness.session import Session

PREFETCH_DEPTH = 2


def model_config(cfg: dict, max_masked: int) -> ModelConfig:
    rs = cfg["rope_scaling"]
    block = DeepSeekV2Config(
        kv_lora_rank=cfg["kv_lora_rank"], qk_nope_head_dim=cfg["qk_nope_head_dim"],
        qk_rope_head_dim=cfg["qk_rope_head_dim"], v_head_dim=cfg["v_head_dim"],
        first_k_dense_replace=cfg["first_k_dense_replace"], n_routed_experts=cfg["n_routed_experts"],
        num_experts_per_tok=cfg["num_experts_per_tok"], n_shared_experts=cfg["n_shared_experts"],
        moe_intermediate_size=cfg["moe_intermediate_size"], rms_norm_eps=cfg["rms_norm_eps"],
        rope_theta=float(cfg["rope_theta"]), rope_factor=float(rs["factor"]),
        rope_original_max_position=rs["original_max_position_embeddings"], rope_beta_fast=float(rs["beta_fast"]),
        rope_beta_slow=float(rs["beta_slow"]), rope_mscale=rs["mscale"], rope_mscale_all_dim=rs["mscale_all_dim"],
        aux_loss_alpha=cfg["aux_loss_alpha"],
    )
    return ModelConfig(
        features={"items": FeatureConfig(cfg["table_rows"], cfg["hidden_size"])},
        num_layers=cfg["num_hidden_layers"], num_heads=cfg["num_attention_heads"], ffn_dim=cfg["intermediate_size"],
        dropout_rate=cfg["dropout_rate"], max_len=cfg["max_len"], positional="rope",
        head=HeadConfig("tied_softmax", output_size=cfg["n_items"]), max_masked=max_masked, dtype=cfg["dtype"],
        norm_style="pre", block=block,
    )


def build(cfg: dict, traffic: traffic_lib.Traffic, fill_weights, seeds: dict, device) -> Session:
    t = traffic.params
    vocab = Vocabulary([f"item_{i}" for i in range(cfg["n_items"])])
    if vocab.model_vocab_size != cfg["table_rows"]:
        raise ValueError("the vocabulary's rows differ from the configuration's table")
    dataset = ClozeDataset(
        traffic.sessions, vocab, max_items=t["max_items"], max_masked=t["max_masked"],
        masked_percentage=t["masked_percentage"], backend=t["batcher"],
    )
    model = ClickstreamModel(model_config(cfg, t["max_masked"]), device=device)
    opt = cfg["optimizer"]
    tx = Adam(opt["b1"], opt["b2"], opt["eps"], mu_dtype=getattr(torch, opt["mu_dtype"]))
    params = dict(model.named_parameters())
    lay = {n: (n, None) for n, _, _ in manifest.reference(cfg).param_specs(cfg)}
    fill_weights(params)
    state = TrainState.create(params, tx)
    step_fn = make_train_step(model, tx, schedules.constant(opt["lr"]), fused_ce_num_valid=cfg["n_items"])
    host = ((b, traffic_lib.batch_stats(_arrays(b))) for b in dataset.train_batches(t["batch"], seed=seeds["batches"]))
    feed = prefetch_to_device(host, lambda pair: (to_device(pair[0], device), pair[1]), depth=PREFETCH_DEPTH)
    return Session(model=model, state=state, step_fn=step_fn, generator=None, device=device, layout=lay,
                   batch_size=t["batch"], feed=feed)


def _arrays(batch) -> dict:
    return {"tokens": batch.features["items"], "positions": batch.head_positions, "labels": batch.labels}
