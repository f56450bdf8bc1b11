"""String-in serving over an exported bundle (counterpart of
``bert4clickpath_tpu/training/serving.py``).

The bundle (:func:`bert4clickpath_torch.training.checkpoint.export_serving`)
carries the state_dict, the ModelConfig and the vocab artifacts. This shim
does the host-side string->id step, pads the batch to a power-of-two
bucket, runs the single-[MASK] forward on the device and ranks the full
catalog with the chunked scan. It keeps the JAX version's contract: the
same buckets, the appended [MASK]/[NA] slot, truncation to
``max_items - 1``, dict sessions for multi-feature models, ``instance_ids``
pass-through, log-prob scores and label-space ids.

It runs where it is told: ``device="cuda"`` (the default) raises if no card
is found; it never carries on on the CPU. Pass ``device="cpu"`` to serve
through the kernels' plain versions.
"""

from __future__ import annotations

import json
import os
from typing import Optional, Sequence

import numpy as np
import torch

from bert4clickpath_torch.config import ModelConfig
from bert4clickpath_torch.constants import (
    CLS_ID,
    LABEL_PAD,
    MASK_ID,
    NA_ID,
    NUM_RESERVED_TOKENS,
    PAD_ID,
    SEP_ID,
)
from bert4clickpath_torch.data.cloze import ITEM_OFFSET, token_length
from bert4clickpath_torch.models.model import ClickstreamModel, head_catalog
from bert4clickpath_torch.ops.chunked_eval import chunked_scores, pick_chunk
from bert4clickpath_torch.training import checkpoint as ckpt_lib
from bert4clickpath_torch.vocab import Vocabulary


def _bucket(b: int) -> int:
    """Next power-of-two batch bucket (min 1), so request sizes map onto a
    small, reused set of shapes."""
    out = 1
    while out < b:
        out *= 2
    return out


class ServingModel:
    """Load an exported bundle and score item sequences from raw strings.

    ``device``: where the model, the catalog and the scan live. ``"cuda"``
    requires a card and raises without one.
    ``warmup_batches``: client batch sizes to run once at load (each rounded
    up to its bucket), so the first live request at those shapes pays no
    one-off cost (kernel build and load, cuBLAS handles, allocator growth).
    ``warmup_k``: the k value(s) to warm (int or sequence of ints).
    """

    def __init__(
        self,
        export_dir: str,
        device="cuda",
        warmup_batches: Sequence[int] = (),
        warmup_k=10,
    ):
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                "ServingModel(device='cuda'): no CUDA device is available; "
                "pass device='cpu' to serve on the CPU"
            )
        export_dir = os.path.abspath(export_dir)
        with open(os.path.join(export_dir, "model_config.json")) as f:
            self.config = ModelConfig.from_json(f.read())
        with open(os.path.join(export_dir, "MANIFEST.json")) as f:
            manifest = json.load(f)
        self.vocabs = {
            name: Vocabulary.load_artifact(export_dir, name)
            for name in manifest["vocabs"]
        }
        cfg = self.config
        if cfg.head.kind not in ("tied_softmax", "softmax"):
            raise ValueError(
                "ServingModel.recommend ranks the item catalog; head kind "
                f"{cfg.head.kind!r} has no catalog to rank"
            )
        self.model = ClickstreamModel(cfg, device=self.device)
        self.model.load_state_dict(ckpt_lib.load_serving_params(export_dir, self.device))
        self.model.eval().requires_grad_(False)
        # the catalog feature the head ranks; other features are paired
        # per-event context (multi-variable models, e.g. (action, item))
        self._item_feature = (
            cfg.item_feature if cfg.item_feature in cfg.features else next(iter(cfg.features))
        )
        # catalog prep (row padding) runs once at load; table and bias stay
        # on the device
        table, bias, _, base_rows = head_catalog(cfg, self.model.state_dict(), pad_rows=True)
        self._catalog = (table, bias)
        if cfg.head.kind == "tied_softmax":
            self._row_offset = NUM_RESERVED_TOKENS
            self._num_valid = cfg.head.output_size or (base_rows - NUM_RESERVED_TOKENS - 1)
        else:  # 'softmax' MLP head: final Dense(V) rows as the catalog
            self._row_offset = 0
            self._num_valid = base_rows
        if warmup_batches:
            self.warmup(warmup_batches, k=warmup_k)

    def warmup(self, batch_sizes: Sequence[int], k=10) -> None:
        """Score all-empty sessions once per (batch bucket, k)."""
        ks = (k,) if isinstance(k, int) else tuple(k)
        names = list(self.config.features)
        empty = [] if len(names) == 1 else {f: [] for f in names}
        for bs in sorted({_bucket(b) for b in batch_sizes}):
            for kk in ks:
                self.recommend([empty] * bs, k=kk)

    @torch.inference_mode()
    def head_inputs(self, feats: dict[str, torch.Tensor], positions: torch.Tensor) -> torch.Tensor:
        """The single-[MASK] forward: (B, 1, d_head) f32 inputs to the
        catalog projection."""
        if self.config.head.kind == "tied_softmax":
            return self.model.gather_head_inputs(feats, positions)
        return self.model.head_trunk_outputs(feats, positions)

    @torch.inference_mode()
    def rank(self, x: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
        """Chunked catalog scan of (B, 1, d_head) head inputs ->
        (log-probs (B, k), label-space ids (B, k))."""
        table, bias = self._catalog
        no_labels = torch.full(x.shape[:2], LABEL_PAD, dtype=torch.int32, device=x.device)
        logz, _, vals, rowids = chunked_scores(
            x, table, no_labels, k,
            row_offset=self._row_offset, num_valid=self._num_valid,
            chunk=pick_chunk(table.shape[0], rows=x.shape[0] * x.shape[1]), bias=bias,
        )
        logprobs = vals[:, 0] - logz[:, 0, None]  # (B, k)
        return logprobs, rowids[:, 0] - self._row_offset

    def encode(self, sessions) -> tuple[dict[str, torch.Tensor], torch.Tensor]:
        """Host side of a request: strings -> bucket-padded (Bp, L) int32 token
        ids per feature and the (Bp, 1) [MASK] positions, on the device. Pad
        rows are all-PAD sessions that score the inert slot ITEM_OFFSET."""
        cfg = self.config
        names = list(cfg.features)
        max_items = cfg.max_len - 3  # [CLS][SEP] ... [SEP]
        b = len(sessions)

        # single-feature models take each session as a token list;
        # multi-variable models take {feature: [tokens...]} per session
        if isinstance(sessions[0], dict):
            per_feature = {}
            for f in names:
                try:
                    per_feature[f] = [s[f] for s in sessions]
                except KeyError:
                    raise ValueError(f"session missing feature {f!r}")
        elif len(names) > 1:
            raise ValueError(
                f"model has features {names}; pass each session as a dict "
                "{feature: [tokens...]} with aligned lengths"
            )
        else:
            per_feature = {self._item_feature: sessions}
        lens = [len(s) for s in per_feature[self._item_feature]]
        for f in names:
            for i, s in enumerate(per_feature[f]):
                if len(s) != lens[i]:
                    raise ValueError(
                        f"session {i}: feature {f!r} has {len(s)} events, "
                        f"{self._item_feature!r} has {lens[i]}"
                    )

        # pad the batch to its bucket with all-PAD rows, sliced off below
        bp = _bucket(b)
        positions = np.full((bp, 1), ITEM_OFFSET, np.int32)  # pad rows: inert slot 2
        feats = {}
        for f in names:
            vf = self.vocabs[f]
            tokens = np.full((bp, token_length(max_items)), PAD_ID, np.int32)
            tokens[:, 0] = CLS_ID
            tokens[:, 1] = SEP_ID
            tokens[:, -1] = SEP_ID
            for i, session in enumerate(per_feature[f]):
                # truncate all features to the same most-recent window
                ids = vf.encode_model(list(session))[-(max_items - 1):]
                n = len(ids)
                tokens[i, ITEM_OFFSET : ITEM_OFFSET + n] = ids
                # the appended next-item slot: [MASK] on the item feature,
                # [NA] on paired features
                tokens[i, ITEM_OFFSET + n] = MASK_ID if f == self._item_feature else NA_ID
                positions[i, 0] = ITEM_OFFSET + n
            feats[f] = torch.from_numpy(tokens).to(self.device)
        return feats, torch.from_numpy(positions).to(self.device)

    def recommend(
        self,
        sessions: Sequence[Sequence[str]],
        k: int = 10,
        instance_ids: Optional[Sequence[str]] = None,
    ) -> list:
        """Next-item recommendation: append a [MASK] slot after each session
        and rank the full catalog for it. Returns per-session top-k
        (item, score) with scores as softmax log-probabilities; with
        ``instance_ids``, ``[{"instance_id": ..., "items": [...]}, ...]``.
        """
        if instance_ids is not None and len(instance_ids) != len(sessions):
            raise ValueError(
                f"{len(instance_ids)} instance_ids for {len(sessions)} sessions"
            )
        b = len(sessions)
        if b == 0:
            return []
        feats, positions = self.encode(sessions)
        scores, idx = self.rank(self.head_inputs(feats, positions), k)
        vocab = self.vocabs[self._item_feature]
        scores, idx = scores.cpu().numpy()[:b], idx.cpu().numpy()[:b]
        results = [
            [(vocab.decode_label(int(idx[i, j])), float(scores[i, j])) for j in range(k)]
            for i in range(b)
        ]
        if instance_ids is not None:
            return [
                {"instance_id": iid, "items": items}
                for iid, items in zip(instance_ids, results)
            ]
        return results
