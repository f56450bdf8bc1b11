"""ClickstreamModel — the model facade (counterpart of
``bert4clickpath_tpu/models/model.py``).

Inputs are integer ids with static shapes; routing is a fixed-width (B, P)
gather of positions (``routing='mask'``) or a static slice
(``routing='segment'``). Module and parameter names mirror the flax tree
(``embed_<feature>``, ``positions``, ``encoder/layer_i/...``, ``head``,
``tied_transform_i``, ``tied_proj``, ``tied_out_bias``), so
:func:`bert4clickpath_torch.convert.state_dict_from_flax` maps one onto
the other by name.

Ported: ``encode``, ``gather_head_inputs``, ``head_trunk_outputs``, the
catalog (``head_catalog``) and ``forward``: the (B, P, V) logits of the
tied-softmax and softmax heads (the dense training and eval path), the
(B, P) logits of the binary head and the (B, C) logits of the multilabel
head on one routed position ((B, P, C) on P > 1). A
single-feature model without an input projection embeds through the fused
gather kernel (one rounding of table*sqrt(d)+pos, as the JAX kernel path
does); other models follow the JAX xla path (per-feature embed, concat,
x sqrt(width) before ``input_proj``, then + pos). Every method takes an
optional ``torch.Generator``: with one, the encoder's dropout is live
(training); without, the forward is deterministic. ``dropout_impl``
(``"mask"``, the default, or ``"fused"``, the dropout kernel) is the JAX
model's ``dropout_impl`` (``"xla"`` / ``"pallas"``); ``remat`` the JAX model's
``remat`` (each encoder layer recomputed in the backward).
"""

from __future__ import annotations

import math
from typing import Callable, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from bert4clickpath_torch.config import ModelConfig
from bert4clickpath_torch.constants import NUM_RESERVED_TOKENS, SEP_ID
from bert4clickpath_torch.models.encoder import Dense, Encoder, LayerNorm
from bert4clickpath_torch.models.heads import BinaryHead, MultiLabelHead, SoftmaxHead
from bert4clickpath_torch.models.positional import LearnedPositions, sinusoidal_positions
from bert4clickpath_torch.ops.fused_ce import padded_rows
from bert4clickpath_torch.ops.kernels.gather import gather_scale_pos
from bert4clickpath_torch.ops.masking import padding_bias, segment_ids
from bert4clickpath_torch.utils import profiling


def _embedding(rows: int, dim: int, device) -> nn.Embedding:
    # f32 table, allocated uninitialised (weights come from a state_dict)
    return nn.Embedding(rows, dim, _weight=torch.empty(rows, dim, device=device))


class ClickstreamModel(nn.Module):
    def __init__(self, config: ModelConfig, device, dropout_impl: str = "mask", remat: bool = False):
        super().__init__()
        cfg = config
        self.config = cfg
        self.dtype = torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32
        dtype = self.dtype
        # the fused CE's input: f32, as the JAX package hands it over; the
        # DeepSeek-V2 block keeps its compute dtype to the head (bf16
        # products with f32 sums in the CE kernels, as the encoder's)
        self.head_dtype = dtype if cfg.block is not None else torch.float32
        for name, fc in cfg.features.items():
            self.add_module(f"embed_{name}", _embedding(fc.vocab_rows, fc.embedding_dim, device))
        embed_sum = sum(fc.embedding_dim for fc in cfg.features.values())
        self.input_proj: Optional[Dense] = None
        if cfg.encoder_dim and cfg.encoder_dim != embed_sum:
            # ALBERT-style factorized input (config.encoder_dim)
            self.input_proj = Dense(embed_sum, cfg.d_model, dtype, device=device)
        if cfg.positional == "learned":
            self.positions = LearnedPositions(cfg.max_len, cfg.d_model, device=device)
        elif cfg.positional != "rope":  # RoPE: positions enter the block's attention, the lookup adds none
            self.register_buffer(
                "sinusoid",
                torch.from_numpy(sinusoidal_positions(cfg.max_len, cfg.d_model)).to(device),
                persistent=False,
            )
        self.segment_embed = (
            _embedding(cfg.max_segments, cfg.d_model, device)
            if cfg.use_segment_embeddings else None
        )
        self.encoder = Encoder(
            cfg.num_layers, cfg.d_model, cfg.num_heads, cfg.ffn_dim,
            cfg.dropout_rate, dtype, cfg.qkv_fused, cfg.norm_style, dropout_impl, remat, cfg.block,
            device=device,
        )
        head = cfg.head
        if head.kind == "softmax":
            self.head = SoftmaxHead(
                cfg.d_model, tuple(head.dense_dims), head.output_size, dtype, device=device
            )
        elif head.kind == "binary":
            self.head = BinaryHead(cfg.d_model, tuple(head.dense_dims), dtype, device=device)
        elif head.kind == "multilabel":
            self.head = MultiLabelHead(
                cfg.d_model, tuple(head.dense_dims), head.output_size, dtype, device=device
            )
        self.n_tied_transform = 0
        self.tied_proj: Optional[Dense] = None
        if head.kind == "tied_softmax":
            # optional BERT-MLM-style transform before the tied projection
            width = cfg.d_model
            for i, dim in enumerate(head.dense_dims):
                self.add_module(f"tied_transform_{i}", Dense(width, dim, dtype, device=device))
                width = dim
            self.n_tied_transform = len(head.dense_dims)
            if head.dense_dims:
                self.tied_transform_ln = LayerNorm(width, dtype, device=device)
            d_item = cfg.features[cfg.item_feature].embedding_dim
            if width != d_item:
                # down/up-project to the item embedding width before tying
                self.tied_proj = Dense(width, d_item, dtype, device=device)
            if head.tied_bias:
                v = head.output_size or (
                    cfg.features[cfg.item_feature].vocab_rows - NUM_RESERVED_TOKENS - 1
                )
                self.tied_out_bias = nn.Parameter(torch.empty(v, device=device))

    def encode(
        self, features: dict[str, torch.Tensor], generator: Optional[torch.Generator] = None,
        item_lookup: Optional[Callable[[torch.Tensor], torch.Tensor]] = None,
    ) -> torch.Tensor:
        """dict of (B, L) int32 -> (B, L, d_model) contextual embeddings;
        dropout live iff a generator is given. ``item_lookup``: (B, L) ids ->
        (B, L, d_item) item embeddings in the compute dtype, in place of the
        item table's own lookup (the vocab-sharded tier's sharded lookup);
        the features then take the per-feature path."""
        cfg = self.config
        names = list(cfg.features)
        first = features[names[0]]
        with profiling.block("b4cp.embed") as blk:
            bias = padding_bias(first)
            seq_len = first.shape[1]
            if cfg.positional == "learned":
                pos = blk.after(self.positions(seq_len))
            elif cfg.positional == "rope":
                pos = None
            else:
                pos = self.sinusoid[:seq_len]
            if len(names) == 1 and self.input_proj is None and item_lookup is None:
                # fused gather+scale+pos-add kernel: one write of the activation
                embedded = blk.after(gather_scale_pos(
                    getattr(self, f"embed_{names[0]}").weight, first, pos,
                    math.sqrt(cfg.d_model), self.dtype,
                ))
            else:
                # per-feature embed, concat on the embedding axis
                embedded = torch.cat(
                    [
                        blk.after(item_lookup(features[n])) if item_lookup is not None and n == cfg.item_feature
                        else blk.after(getattr(self, f"embed_{n}")(features[n])).to(self.dtype)
                        for n in names
                    ],
                    dim=-1,
                )
                # x sqrt(embedding width) in the compute dtype, BEFORE any
                # factorized up-projection (see the JAX model's note)
                width = embedded.shape[-1]
                scale = torch.tensor(float(width), dtype=self.dtype).sqrt().item()
                embedded = self.apply_input_proj(embedded * scale)
                if pos is not None:
                    embedded = embedded + pos.to(self.dtype)[None]
            if self.segment_embed is not None:
                # cumulative-SEP markers: [CLS][SEP] s1 [SEP] s2 -> 0 1.. 2..
                seg = segment_ids(first, SEP_ID).clamp(0, cfg.max_segments - 1)
                embedded = embedded + blk.after(self.segment_embed(seg)).to(self.dtype)
            embedded = blk.output(embedded)
        return self.encoder(embedded, bias, generator)

    def apply_input_proj(self, x: torch.Tensor) -> torch.Tensor:
        """Factorized-input up-projection (identity unless ``encoder_dim`` is
        set and differs from the concatenated embedding width)."""
        if self.input_proj is not None:
            return self.input_proj(x)
        return x

    def apply_tied_transform(self, x: torch.Tensor) -> torch.Tensor:
        """Dense + tanh-gelu per configured dim then LayerNorm (identity when
        dense_dims is empty), plus the width-matching projection to the item
        embedding dim. Output is ready for ``x @ E^T``."""
        if self.config.head.kind != "tied_softmax":
            return x
        if self.n_tied_transform:
            x = x.to(self.dtype)
            for i in range(self.n_tied_transform):
                # flax nn.gelu is the tanh approximation
                x = F.gelu(getattr(self, f"tied_transform_{i}")(x), approximate="tanh")
            x = self.tied_transform_ln(x)
        if self.tied_proj is not None:
            x = self.tied_proj(x)
        return x

    def _route(self, h: torch.Tensor, head_positions: Optional[torch.Tensor]) -> torch.Tensor:
        """Gather the head's input positions from the encoder output."""
        cfg = self.config
        if cfg.routing == "mask":
            if head_positions is None:
                raise ValueError("routing='mask' requires head_positions")
            idx = head_positions.long()[..., None].expand(-1, -1, h.shape[-1])
            return torch.gather(h, 1, idx)
        start, end = cfg.segment_bounds
        return h[:, start:end]

    def gather_head_inputs(
        self, features: dict[str, torch.Tensor], head_positions: Optional[torch.Tensor] = None,
        generator: Optional[torch.Generator] = None,
        item_lookup: Optional[Callable[[torch.Tensor], torch.Tensor]] = None,
    ) -> torch.Tensor:
        """Encode, gather the routed positions, and (for tied heads) apply the
        pre-projection transform: everything except the catalog projection.
        (B, P, d_head) in ``head_dtype`` (f32; the DeepSeek-V2 block's
        compute dtype), the fused CE's input. ``item_lookup``: as
        :meth:`encode`."""
        h = self.encode(features, generator, item_lookup)
        with profiling.block("b4cp.head") as blk:
            return blk.output(self.apply_tied_transform(self._route(blk.input(h), head_positions)).to(self.head_dtype))

    def head_trunk_outputs(
        self, features: dict[str, torch.Tensor], head_positions: Optional[torch.Tensor] = None,
        generator: Optional[torch.Generator] = None,
        item_lookup: Optional[Callable[[torch.Tensor], torch.Tensor]] = None,
    ) -> torch.Tensor:
        """Encode, gather, and run the softmax head's MLP trunk: every layer
        except the final ``Dense(V)`` catalog projection. (B, P, d_trunk) f32.
        ``item_lookup``: as :meth:`encode`."""
        if self.config.head.kind != "softmax":
            raise ValueError("head_trunk_outputs requires head kind 'softmax'")
        h = self.encode(features, generator, item_lookup)
        with profiling.block("b4cp.head") as blk:
            return blk.output(self.head.trunk(self._route(blk.input(h), head_positions)).float())

    def forward(
        self, features: dict[str, torch.Tensor], head_positions: Optional[torch.Tensor] = None,
        generator: Optional[torch.Generator] = None,
    ) -> torch.Tensor:
        """Head logits: (B, P, V) for the softmax heads, (B, P) for the
        binary head, (B, C) for the multilabel head on one routed position.
        For the tied head, f32 logits of the transformed inputs against the
        item table's label rows (bf16 operands under bf16 compute, f32 sums,
        as the JAX einsum with ``preferred_element_type=f32``) plus
        ``tied_out_bias``; every other head returns its final Dense's output
        in the compute dtype."""
        h = self.encode(features, generator)
        gathered = self._route(h, head_positions)
        if self.config.head.kind == "tied_softmax":
            return self._tied_logits(gathered)
        return self.head(gathered)

    def _tied_logits(self, x: torch.Tensor) -> torch.Tensor:
        cfg = self.config
        x = self.apply_tied_transform(x)
        table = getattr(self, f"embed_{cfg.item_feature}").weight
        v = cfg.head.output_size or (table.shape[0] - NUM_RESERVED_TOKENS - 1)
        weights = table[NUM_RESERVED_TOKENS : NUM_RESERVED_TOKENS + v]
        logits = x.to(self.dtype).float() @ weights.to(self.dtype).float().T
        if cfg.head.tied_bias:
            logits = logits + self.tied_out_bias
        return logits


def tied_bias_model_space(bias: torch.Tensor, rows: int) -> torch.Tensor:
    """(rows,) model-space bias: the (V_label,) ``tied_out_bias`` placed at
    the reserved-token offset; reserved/OOV/padding rows stay 0."""
    out = torch.zeros(rows, dtype=bias.dtype, device=bias.device)
    out[NUM_RESERVED_TOKENS : NUM_RESERVED_TOKENS + bias.shape[0]] = bias
    return out


def head_catalog(config: ModelConfig, state_dict, pad_rows: bool = False):
    """The catalog a softmax-family head ranks: (table, bias, row_offset,
    base_rows), read from the port's ``state_dict``.

    tied_softmax: the (rows, D_item) item embedding table with
    ``tied_out_bias`` (if any) spread via :func:`tied_bias_model_space`;
    row_offset = NUM_RESERVED_TOKENS. softmax: the final Dense(V) weight,
    whose (V, d_trunk) torch layout already holds one row per label, plus
    its bias; row_offset 0, always padded through ``padded_rows``.
    ``pad_rows=True`` pads a tied table too. ``base_rows`` is the
    pre-padding row count, for deriving num_valid.
    """
    kind = config.head.kind
    if kind == "tied_softmax":
        table = state_dict[f"embed_{config.item_feature}.weight"]
        base_rows = table.shape[0]
        bias = (
            tied_bias_model_space(state_dict["tied_out_bias"], base_rows)
            if config.head.tied_bias
            else None
        )
        if pad_rows:
            pad = padded_rows(base_rows) - base_rows
            if pad:
                table = F.pad(table, (0, 0, 0, pad))
                bias = None if bias is None else F.pad(bias, (0, pad))
        return table, bias, NUM_RESERVED_TOKENS, base_rows
    if kind == "softmax":
        w = state_dict["head.out.weight"]  # (V, d_trunk)
        b = state_dict["head.out.bias"]  # (V,)
        v = w.shape[0]
        pad = padded_rows(v) - v
        return F.pad(w, (0, 0, 0, pad)), F.pad(b, (0, pad)), 0, v
    raise ValueError(f"softmax-family head required, got {kind!r}")


def init_state_dict(config: ModelConfig, seed: int) -> dict[str, torch.Tensor]:
    """Fresh weights for a run that starts from scratch, drawn as the JAX
    package's ``ClickstreamModel.init`` draws them (flax's defaults): Dense
    weights lecun-normal (a normal truncated at two standard deviations,
    variance 1 / fan_in), embedding tables N(0, 1 / dim), learned positions
    N(0, 0.02), biases and ``tied_out_bias`` 0, LayerNorm scale 1. The
    draws come from a numpy generator, so they are the same on every
    device; they are not JAX's bits."""
    rng = np.random.default_rng(seed)
    skeleton = ClickstreamModel(config, device="meta")
    modules = dict(skeleton.named_modules())
    out = {}
    for key, t in skeleton.state_dict().items():
        owner, _, leaf = key.rpartition(".")
        module = modules[owner]
        shape = tuple(t.shape)
        if leaf == "bias" or key == "tied_out_bias":
            arr = np.zeros(shape, np.float32)
        elif isinstance(module, LayerNorm):
            arr = np.ones(shape, np.float32)
        elif isinstance(module, Dense):
            # jax.nn.initializers.variance_scaling, "truncated_normal": the
            # std of a unit normal cut at +-2 is 0.8796...
            std = math.sqrt(1.0 / shape[1]) / 0.87962566103423978
            z = rng.standard_normal(shape)
            while (bad := np.abs(z) > 2.0).any():
                z[bad] = rng.standard_normal(int(bad.sum()))
            arr = (z * std).astype(np.float32)
        elif isinstance(module, nn.Embedding):
            arr = (rng.standard_normal(shape) / math.sqrt(shape[1])).astype(np.float32)
        elif isinstance(module, LearnedPositions):
            arr = (rng.standard_normal(shape) * 0.02).astype(np.float32)
        else:
            raise KeyError(f"no initialiser for {key!r} of {type(module).__name__}")
        out[key] = torch.from_numpy(arr)
    return out
