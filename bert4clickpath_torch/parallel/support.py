"""Tier x feature support matrix: the single source of truth (copy of
``bert4clickpath_tpu/parallel/support.py``; the matrix is data).

Each parallel tier composes with a subset of (head kind, attention /
dropout / embedding impl, qkv_fused, sampled softmax). Every tier
constructor (``parallel/spmd.py``, ``tp.py``, ``tp_spmd.py``) and the
training driver call :func:`validate_tier` before they build anything. The
feature names keep the JAX package's impl names: ``attn:pallas``,
``dropout:pallas`` and ``embed:pallas`` are the port's hand-written
kernels (its attention always, ``dropout_impl="fused"``, the gather
kernel).

``RULES`` is the JAX package's table, feature for feature, except for the
cells of :data:`PORT_ACCEPTS`, which the port accepts where the JAX
package refuses. The JAX package refuses its Pallas kernels in the
tensor-parallel and sampled SPMD tiers because pjit's partitioner has no
rules for them and its composed tier runs its own per-head attention. The
port's tiers are explicit per-rank programs, with no partitioner, and its
attention kernel takes heads as column ranges of any slice, so called on a
rank's D / S columns with H / S heads it is the head-sharded attention.
The port's models always run that kernel (on a card there is no plain
attention), so without these cells the three tiers would refuse every
model; with them they compute what the JAX tiers compute with
``attn_impl="xla"``.
"""

from __future__ import annotations

from typing import Optional

TIERS = ("single", "dp", "spmd", "tp", "tp_spmd", "sampled_spmd")
HEAD_KINDS = ("tied_softmax", "softmax", "binary", "multilabel")

_P_RANK_PROGRAMS = (
    "the port's tier is an explicit per-rank program (no partitioner), and its "
    "attention kernel takes heads as column ranges of any (B, L, D / S) slice"
)
# the cells the port accepts and the JAX package refuses, with the reason
PORT_ACCEPTS: dict[str, dict[str, str]] = {
    "tp": {"attn:pallas": _P_RANK_PROGRAMS, "dropout:pallas": _P_RANK_PROGRAMS, "embed:pallas": _P_RANK_PROGRAMS},
    "tp_spmd": {"attn:pallas": _P_RANK_PROGRAMS, "dropout:pallas": _P_RANK_PROGRAMS},
    "sampled_spmd": {"attn:pallas": _P_RANK_PROGRAMS, "dropout:pallas": _P_RANK_PROGRAMS},
}

# Blocks of the port's own (``ModelConfig.block``) that a tier refuses by
# name; the matrix above has no row for them (the JAX package has no
# such block). Only the single-device step runs the DeepSeek-V2 block: the
# data-parallel tiers reduce the CE's sums without its balance loss, and the
# tensor-parallel and vocab-sharded tiers build BERT4Rec's layers.
_R_DEEPSEEK = (
    "the DeepSeek-V2 block (MLA and the expert layer) runs on the single-device "
    "step only: this tier neither shards the experts nor adds their balance loss"
)
PORT_BLOCKS: dict[str, dict[str, str]] = {
    tier: {"deepseek_v2": _R_DEEPSEEK} for tier in ("dp", "spmd", "tp", "tp_spmd", "sampled_spmd")
}

# Why-strings double as error messages and matrix footnotes.
_R_SPMD_HEAD = (
    "the vocab-sharded SPMD tier requires the tied head (the projection "
    "shards with the table); MLP-softmax/binary/multilabel heads use the "
    "pure data-parallel tier"
)
_R_TP_QKV = (
    "tensor-parallel column splits are per-projection (wq/wk/wv); the fused "
    "(D, 3D) kernel's q|k|v blocks do not align with contiguous shards"
)
_R_SAMPLED_HEAD = "sampled softmax requires a softmax-family head"
_R_SAMPLED_DP = (
    "the DP tier reduces exact fused-CE sums; run sampled softmax "
    "single-device or via the sampled_spmd pjit tier"
)
_R_SAMPLED_SPMD = (
    "the vocab-sharded fused-CE tier computes the exact partition function; "
    "for sampled softmax over a sharded table use sampled_spmd"
)
_R_SAMPLED_TP = (
    "sampled softmax + tensor parallelism is an unvalidated composition; "
    "run sampled softmax via sampled_spmd (table sharding) instead"
)
_R_SSPMD_PALLAS = (
    "the sampled_spmd tier is pjit auto-sharding; Pallas kernels have no "
    "SPMD partitioning rules"
)
_R_SPMD_EMBED = (
    "the SPMD tier always looks items up through its own row-sharded kernel "
    "(parallel/embedding.py:sharded_embedding_lookup); embed_impl selects "
    "the single-device/DP lookup only"
)
_R_SSPMD_SAMPLES = "the sampled_spmd tier IS the sampled-softmax path (pass num_samples > 0)"

# rules[tier][feature] -> None (supported) | reason string (rejected).
# Features: per head kind, the three pallas impls, qkv_fused, sampled.
_OK = None
RULES: dict[str, dict[str, Optional[str]]] = {
    "single": {},  # everything composes on one chip
    "dp": {"sampled": _R_SAMPLED_DP},
    "spmd": {
        "head:softmax": _R_SPMD_HEAD,
        "head:binary": _R_SPMD_HEAD,
        "head:multilabel": _R_SPMD_HEAD,
        "embed:pallas": _R_SPMD_EMBED,
        "sampled": _R_SAMPLED_SPMD,
    },
    "tp": {
        # PORT_ACCEPTS: attn:pallas, dropout:pallas, embed:pallas
        "qkv_fused": _R_TP_QKV,
        "sampled": _R_SAMPLED_TP,
    },
    "tp_spmd": {
        "head:softmax": _R_SPMD_HEAD,
        "head:binary": _R_SPMD_HEAD,
        "head:multilabel": _R_SPMD_HEAD,
        # PORT_ACCEPTS: attn:pallas, dropout:pallas
        "embed:pallas": _R_SPMD_EMBED,
        "qkv_fused": _R_TP_QKV,
        "sampled": _R_SAMPLED_SPMD,
    },
    "sampled_spmd": {
        "head:binary": _R_SAMPLED_HEAD,
        "head:multilabel": _R_SAMPLED_HEAD,
        # PORT_ACCEPTS: attn:pallas, dropout:pallas
        "embed:pallas": _R_SSPMD_PALLAS,
        "no_sampled": _R_SSPMD_SAMPLES,
    },
}
# sampled softmax additionally requires a softmax-family head on EVERY tier
for _t in TIERS:
    RULES[_t].setdefault("sampled+head:binary", _R_SAMPLED_HEAD)
    RULES[_t].setdefault("sampled+head:multilabel", _R_SAMPLED_HEAD)


def validate_tier(
    tier: str,
    head_kind: str,
    *,
    attn_impl: str = "xla",
    dropout_impl: str = "xla",
    embed_impl: str = "xla",
    qkv_fused: bool = False,
    sampled: int = 0,
    block: str = "bert4rec",
) -> None:
    """Raise ValueError with the matrix reason if the combination is
    unsupported; silent when it composes. Tier constructors and the training
    driver both call this BEFORE building a step. ``block``: the encoder's
    block, ``"bert4rec"`` or one of the port's own (``PORT_BLOCKS``)."""
    if tier not in TIERS:
        raise ValueError(f"unknown tier {tier!r}; expected one of {TIERS}")
    if block != "bert4rec":
        reason = PORT_BLOCKS.get(tier, {}).get(block)
        if reason is not None:
            raise ValueError(f"tier {tier!r} rejects block {block!r}: {reason}")
    if head_kind not in HEAD_KINDS:
        raise ValueError(
            f"unknown head kind {head_kind!r}; expected one of {HEAD_KINDS}"
        )
    rules = RULES[tier]
    active = [f"head:{head_kind}"]
    # "auto" may resolve to the Pallas kernel at long L, so tiers that
    # cannot run Pallas must reject it too (conservative)
    if attn_impl in ("pallas", "auto"):
        active.append("attn:pallas")
    if dropout_impl == "pallas":
        active.append("dropout:pallas")
    if embed_impl == "pallas":
        active.append("embed:pallas")
    if qkv_fused:
        active.append("qkv_fused")
    if sampled:
        active.append("sampled")
        active.append(f"sampled+head:{head_kind}")
    else:
        active.append("no_sampled")
    for feat in active:
        reason = rules.get(feat)
        if reason is not None:
            raise ValueError(f"tier {tier!r} rejects {feat!r}: {reason}")


def _cell(tier: str, feat: str) -> str:
    return "yes" if RULES[tier].get(feat) is None else "no"


def render_matrix() -> str:
    """The COMPONENTS.md support table, generated from RULES."""
    feats = [
        ("head tied_softmax", "head:tied_softmax"),
        ("head softmax (MLP)", "head:softmax"),
        ("head binary", "head:binary"),
        ("head multilabel", "head:multilabel"),
        ("attn_impl pallas", "attn:pallas"),
        ("dropout_impl pallas", "dropout:pallas"),
        ("embed_impl pallas", "embed:pallas"),
        ("qkv_fused", "qkv_fused"),
        ("sampled softmax", "sampled"),
    ]
    lines = [
        "| feature \\ tier | " + " | ".join(TIERS) + " |",
        "|---|" + "---|" * len(TIERS),
    ]
    for label, feat in feats:
        if feat == "sampled":
            # sampled_spmd REQUIRES sampling; every other tier consults the
            # 'sampled' rule
            cells = [
                "required" if t == "sampled_spmd" else _cell(t, "sampled")
                for t in TIERS
            ]
        else:
            cells = [_cell(t, feat) for t in TIERS]
        lines.append(f"| {label} | " + " | ".join(cells) + " |")
    return "\n".join(lines)
