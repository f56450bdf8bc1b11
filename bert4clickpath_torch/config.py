"""Dataclass configuration for models, training, and the device mesh.

(Copied from ``bert4clickpath_tpu/config.py``, which imports no jax, so
that the port never imports the JAX package. Keep the two in step: both
packages read the same artifacts. The port adds one field of its own,
``ModelConfig.block`` (:data:`PORT_ONLY_FIELDS`): a DeepSeek-V2 block in
place of BERT4Rec's, which the JAX package does not have.)

Replaces the reference's three loose ctor dicts
(``sequential_input_config`` / ``feature_vocabs`` / ``embedding_dims``,
clickstream_transformer.py:160-227) and its spec-dict argparse generator
(source/utils.py:7-53) with typed configs that serialize to JSON so they can
travel with checkpoints.
"""

from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass, field
from typing import Optional

from bert4clickpath_torch.constants import MAX_MASKED_ITEMS


@dataclass(frozen=True)
class FeatureConfig:
    """One embedded sequential feature (e.g. items, actions).

    vocab_rows counts *model-space* rows: reserved + raw vocab + OOV bucket
    (see :class:`bert4clickpath_torch.vocab.Vocabulary.model_vocab_size`).
    """

    vocab_rows: int
    embedding_dim: int


@dataclass(frozen=True)
class HeadConfig:
    """A pluggable task head mounted on gathered encoder outputs.

    kind:
      * ``softmax`` — MLP -> V logits; the reference "parity head"
        (head.py:29-47 + source/main.py:262, dims [1024,512,256,128]).
      * ``tied_softmax`` — logits = x @ E_items^T over the raw-vocab rows of
        the item embedding table; the TPU-native default (ties weights, rides
        the MXU, enables vocab-sharded loss).
      * ``binary`` — MLP -> scalar logit per position (head.py:4-26).
      * ``multilabel`` — MLP -> C independent logits (head.py:50-69).

    All heads emit **logits**; activations fold into losses/metrics. The
    reference emitted probabilities (head.py:21,45,65) which is numerically
    inferior — intentionally not replicated.
    """

    kind: str = "softmax"
    dense_dims: tuple[int, ...] = ()
    output_size: int = 0  # V for softmax/multilabel; ignored for binary/tied
    # tied_softmax only: add a free per-item output bias (BERT's MLM decoder
    # ties weights but keeps its own bias). Lets popularity live in the bias
    # instead of distorting embedding norms. Supported on every path: dense
    # logits, fused CE (its kernels take a per-row bias input), the sharded
    # fused CE, chunked eval, and serving.
    tied_bias: bool = False

    def __post_init__(self):
        if self.kind not in ("softmax", "tied_softmax", "binary", "multilabel"):
            raise ValueError(f"unknown head kind {self.kind!r}")
        if self.tied_bias and self.kind != "tied_softmax":
            raise ValueError("tied_bias requires kind='tied_softmax'")


@dataclass(frozen=True)
class DeepSeekV2Config:
    """The DeepSeek-V2 block (https://arxiv.org/abs/2405.04434; keys and
    defaults of DeepSeek-V2-Lite's ``config.json``) in place of BERT4Rec's:
    pre-RMSNorm layers of multi-head latent attention (MLA: no query
    compression, a ``kv_lora_rank`` latent for keys and values, a decoupled
    RoPE key of ``qk_rope_head_dim`` shared by the heads, YaRN-scaled) and a
    SwiGLU feed-forward, dense (``ModelConfig.ffn_dim`` wide) in the first
    ``first_k_dense_replace`` layers and a mixture of experts after them:
    ``n_routed_experts`` SwiGLU experts of ``moe_intermediate_size``, a
    softmax router with greedy top-``num_experts_per_tok`` (weights not
    renormalised), no token dropped, plus ``n_shared_experts`` experts as
    one SwiGLU of ``n_shared_experts * moe_intermediate_size``. The
    sequence-wise balance loss, ``aux_loss_alpha`` times sum_i f_i P_i per
    session, is added to the training loss. ``ModelConfig.num_heads`` is the
    number of heads, ``d_model`` the hidden size."""

    kv_lora_rank: int = 512
    qk_nope_head_dim: int = 128
    qk_rope_head_dim: int = 64
    v_head_dim: int = 128
    first_k_dense_replace: int = 1
    n_routed_experts: int = 64
    num_experts_per_tok: int = 6
    n_shared_experts: int = 2
    moe_intermediate_size: int = 1408
    rms_norm_eps: float = 1e-6
    rope_theta: float = 10000.0
    # YaRN (rope_scaling of type "yarn")
    rope_factor: float = 40.0
    rope_original_max_position: int = 4096
    rope_beta_fast: float = 32.0
    rope_beta_slow: float = 1.0
    rope_mscale: float = 0.707
    rope_mscale_all_dim: float = 0.707
    aux_loss_alpha: float = 0.001

    def __post_init__(self):
        if self.qk_rope_head_dim % 2:
            raise ValueError("qk_rope_head_dim must be even (RoPE rotates pairs)")
        if not 0 < self.num_experts_per_tok <= self.n_routed_experts:
            raise ValueError("num_experts_per_tok must lie in [1, n_routed_experts]")

    @property
    def qk_head_dim(self) -> int:
        return self.qk_nope_head_dim + self.qk_rope_head_dim


# ModelConfig's fields that the JAX package's ModelConfig lacks
PORT_ONLY_FIELDS = ("block",)


@dataclass(frozen=True)
class ModelConfig:
    """Encoder + head + routing.

    Routing (reference clickstream_transformer.py:317-341): exactly one of

    * ``routing='mask'`` — gather encoder outputs at fixed-width
      ``(B, max_masked)`` positions supplied by the pipeline. Replaces the
      reference's ragged ``[MASK]``-position gather
      (clickstream_transformer.py:260-297) with static shapes.
    * ``routing='segment'`` — slice a static ``[start, end)`` token range of
      the chained sequence (e.g. the CLS summary, or a basket segment). With
      fixed per-segment lengths the offsets are static, deleting the
      reference's runtime SEP-scan (clickstream_transformer.py:81-94).
    """

    features: dict[str, FeatureConfig] = field(default_factory=dict)
    num_layers: int = 2
    num_heads: int = 2
    ffn_dim: int = 100  # reference hard-codes 100 (clickstream_transformer.py:225)
    dropout_rate: float = 0.1
    max_len: int = 53  # tokens incl. [CLS][SEP]...[SEP]
    positional: str = "sinusoidal"  # or "learned" (BERT4Rec-style)
    head: HeadConfig = field(default_factory=HeadConfig)
    routing: str = "mask"
    segment_bounds: Optional[tuple[int, int]] = None  # for routing='segment'
    max_masked: int = MAX_MASKED_ITEMS  # P, width of the head gather
    # Segment embeddings over cumulative-SEP markers: the reference scaffolded
    # but disabled these (transformer.py:358,392-395); useful with chained
    # multi-sequence inputs (routing='segment').
    use_segment_embeddings: bool = False
    max_segments: int = 8
    dtype: str = "float32"  # computation dtype: "bfloat16" on TPU
    # Residual/LayerNorm order: "post" = the reference's post-LN blocks
    # (transformer.py:202-213); "pre" = pre-LN (normalize sublayer inputs,
    # final LN after the stack) — unlocks depth: post-LN 6L collapses on
    # Beauty under every measured LR (BASELINE.md round 4).
    norm_style: str = "post"
    # name of the feature whose embedding the tied head shares
    item_feature: str = "items"
    # ALBERT-style factorized input: when > 0 and different from the sum of
    # embedding dims, a Dense projects the concatenated embeddings up to this
    # encoder width. Decouples table capacity (the overfitting lever on small
    # catalogs — the table is ~80% of flagship params) from encoder width;
    # the tied head's width-matching projection maps back to table space.
    encoder_dim: int = 0
    # Fused (D, 3D) QKV projection: one MXU matmul instead of three D-wide
    # ones per attention block (narrow-N matmuls under-fill the MXU at
    # d_model=256). Changes the parameter tree (wqkv replaces wq/wk/wv), so
    # it is an architecture field, not an impl switch. Not supported by the
    # tensor-parallel tier (its column-split specs are per-projection).
    qkv_fused: bool = False
    # The port's own: a DeepSeek-V2 block in place of BERT4Rec's (None:
    # BERT4Rec's). It takes positional="rope" and norm_style="pre"; the
    # model then adds no absolute positions.
    block: Optional[DeepSeekV2Config] = None

    def __post_init__(self):
        if self.routing not in ("mask", "segment"):
            raise ValueError(f"unknown routing {self.routing!r}")
        if self.routing == "segment" and self.segment_bounds is None:
            raise ValueError("routing='segment' requires segment_bounds")
        if self.positional not in ("sinusoidal", "learned", "rope"):
            raise ValueError(f"unknown positional {self.positional!r}")
        if (self.positional == "rope") != (self.block is not None):
            raise ValueError("positional='rope' goes with a DeepSeek-V2 block, and only with one")
        if self.block is not None and (self.norm_style != "pre" or self.qkv_fused or self.encoder_dim):
            raise ValueError("the DeepSeek-V2 block is pre-norm, without qkv_fused or encoder_dim")
        if self.norm_style not in ("post", "pre"):
            raise ValueError(f"unknown norm_style {self.norm_style!r}")

    @property
    def d_model(self) -> int:
        """Encoder width: ``encoder_dim`` if set, else the sum of per-feature
        embedding dims (reference transformer.py:336)."""
        return self.encoder_dim or sum(
            f.embedding_dim for f in self.features.values()
        )

    @property
    def head_width(self) -> int:
        """P — number of positions fed to the head."""
        if self.routing == "mask":
            return self.max_masked
        start, end = self.segment_bounds
        return end - start

    # -- serialization ----------------------------------------------------
    def to_json(self) -> str:
        def enc(o):
            if dataclasses.is_dataclass(o):
                return {k: enc(v) for k, v in dataclasses.asdict(o).items()}
            return o

        d = dataclasses.asdict(self)
        # the port's own fields only where set: a BERT4Rec model's artifact
        # stays byte for byte the JAX package's
        for name in PORT_ONLY_FIELDS:
            if d[name] is None:
                del d[name]
        return json.dumps(d, indent=2)

    @classmethod
    def from_json(cls, payload: str) -> "ModelConfig":
        d = json.loads(payload)
        d["features"] = {k: FeatureConfig(**v) for k, v in d["features"].items()}
        # pass every field through so new HeadConfig fields (tied_bias, ...)
        # survive the round-trip instead of silently reverting to defaults
        d["head"] = HeadConfig(
            **{**d["head"], "dense_dims": tuple(d["head"]["dense_dims"])}
        )
        if d.get("segment_bounds") is not None:
            d["segment_bounds"] = tuple(d["segment_bounds"])
        if d.get("block") is not None:
            d["block"] = DeepSeekV2Config(**d["block"])
        return cls(**d)


@dataclass(frozen=True)
class TrainConfig:
    """Optimization + loop parameters (reference source/main.py:186-211)."""

    batch_size: int = 100  # global batch
    eval_batch_size: int = 0  # 0 -> use batch_size
    learning_rate: float = 1e-3
    adam_b1: float = 0.9
    adam_b2: float = 0.999
    adam_eps: float = 1e-9
    lr_schedule: str = "constant"  # constant | rsqrt_warmup | exp_decay
    warmup_steps: int = 4000
    n_epochs: int = 10000
    steps_per_epoch: int = 100
    validation_steps: int = 0  # 0 -> full eval pass
    # Evaluate every N epochs (plateau/early-stop counters advance only on
    # evaluated epochs). Full-catalog eval costs ~10x a train epoch on the
    # remote-TPU backend, so metric runs often want 2-5 here.
    eval_every: int = 1
    early_stopping_patience: int = 30  # epochs (reference main.py:156)
    plateau_patience: int = 10  # epochs (reference main.py:134)
    plateau_factor: float = 0.317
    # What drives best-ckpt / plateau / early-stop. The reference monitored
    # val_loss (main.py:134,141,156), but full-softmax CE diverges while
    # ranking metrics still improve (BASELINE.md: val_loss monitoring
    # early-stops Beauty at ~0.02 recall@10 vs 0.036 NDCG-monitored).
    # "auto" = val_ndcg@10 when the head emits it, else val_loss.
    monitor: str = "auto"
    monitor_mode: str = "auto"  # resolved with "auto"; else "min" | "max"
    seed: int = 0
    log_every: int = 50  # steps
    remat: bool = False  # jax.checkpoint the encoder layers
    # Retain at most N best-so-far checkpoints under model_dir/ckpts
    # (0 = keep all, the reference's timestamped-ModelCheckpoint
    # accumulation, source/main.py:137-142 — ~10 GB per Beauty run).
    ckpt_keep: int = 0
    # EMA of params for eval/export (0 disables). Polyak averaging is a
    # standard production-recsys quality lever the reference lacks; the
    # shadow is updated in the train step and ranked/exported instead of
    # the raw params (training/train_state.py:eval_params).
    ema_decay: float = 0.0

    def __post_init__(self):
        if self.monitor == "auto" and self.monitor_mode != "auto":
            # with monitor unresolved, a pinned mode can invert best-model
            # selection (e.g. mode='min' while auto picks val_ndcg@10 —
            # the trainer would track the WORST epoch); reject the combo
            raise ValueError(
                "monitor='auto' requires monitor_mode='auto' — pin the "
                "monitor metric when pinning its mode"
            )
        if self.monitor_mode not in ("auto", "min", "max"):
            raise ValueError(f"monitor_mode {self.monitor_mode!r}")


@dataclass(frozen=True)
class MeshConfig:
    """Logical device mesh: data-parallel x model(vocab-shard) axes.

    Replaces the reference's MirroredStrategy (source/main.py:46-57) with an
    explicit ``jax.sharding.Mesh``; collectives ride ICI via psum/all_gather.
    """

    data: int = 1
    model: int = 1

    @property
    def num_devices(self) -> int:
        return self.data * self.model
