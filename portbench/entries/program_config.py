"""The program's ``ModelConfig`` of a configuration file, and where each of
the reference's parameters lies in the program's (shared by the entries)."""

from __future__ import annotations

from bert4clickpath_torch.config import FeatureConfig, HeadConfig, ModelConfig


def model_config(cfg: dict) -> ModelConfig:
    return ModelConfig(
        features={"items": FeatureConfig(cfg["table_rows"], cfg["d_model"])},
        num_layers=cfg["num_layers"],
        num_heads=cfg["num_heads"],
        ffn_dim=cfg["ffn_dim"],
        dropout_rate=cfg["dropout_rate"],
        max_len=cfg["max_len"],
        positional=cfg["positional"],
        head=HeadConfig("tied_softmax", output_size=cfg["n_items"]),
        dtype=cfg["dtype"],
        qkv_fused=cfg["qkv_fused"],
        norm_style=cfg["norm_style"],
    )


def layout(cfg: dict, ref_names) -> dict:
    """reference name -> (program name, rows or None). With ``qkv_fused``
    the program keeps the query, key and value projections in one (3D, D)
    tensor ``wqkv``; the reference's ``wq``, ``wk``, ``wv`` are its thirds."""
    d = cfg["d_model"]
    out = {}
    for name in ref_names:
        head, _, leaf = name.rpartition(".")
        owner, _, proj = head.rpartition(".")
        if cfg["qkv_fused"] and proj in ("wq", "wk", "wv"):
            i = ("wq", "wk", "wv").index(proj)
            out[name] = (f"{owner}.wqkv.{leaf}", slice(i * d, (i + 1) * d))
        else:
            out[name] = (name, None)
    return out
