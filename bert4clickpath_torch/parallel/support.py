"""Tier x feature support matrix: the single source of truth (copy of
``bert4clickpath_tpu/parallel/support.py``; the matrix is data).

Each parallel tier composes with a subset of (head kind, attention /
dropout / embedding impl, qkv_fused, sampled softmax). Every tier
constructor (``parallel/spmd.py``) and the training driver call
:func:`validate_tier` before they build anything. ``RULES`` is the JAX
package's table, feature for feature, so the port refuses what the JAX
package refuses. The feature names keep the JAX package's impl names:
``attn:pallas``, ``dropout:pallas`` and ``embed:pallas`` are the port's
hand-written kernels (its attention always, ``dropout_impl="fused"``, the
gather kernel).

Tiers the port has not got yet (:data:`UNPORTED`: tensor parallelism, its
composition with the vocab-sharded tier, and the sampled-softmax SPMD
tier) are refused by name.
"""

from __future__ import annotations

from typing import Optional

TIERS = ("single", "dp", "spmd", "tp", "tp_spmd", "sampled_spmd")
# in the JAX package's matrix, not in the port yet: refused by name
UNPORTED = ("tp", "tp_spmd", "sampled_spmd")
HEAD_KINDS = ("tied_softmax", "softmax", "binary", "multilabel")

# Why-strings double as error messages and matrix footnotes.
_R_SPMD_HEAD = (
    "the vocab-sharded SPMD tier requires the tied head (the projection "
    "shards with the table); MLP-softmax/binary/multilabel heads use the "
    "pure data-parallel tier"
)
_R_TP_PALLAS = (
    "the tensor-parallel tier is pjit auto-sharding; Pallas kernels have no "
    "SPMD partitioning rules (the sharded-kernel path is parallel/spmd.py)"
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
_R_TPSPMD_ATTN = (
    "the composed tp_spmd tier runs the per-head lane-slice attention on "
    "each shard's H/S heads; Pallas kernels are not head-sharded"
)

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
        "attn:pallas": _R_TP_PALLAS,
        "dropout:pallas": _R_TP_PALLAS,
        "embed:pallas": _R_TP_PALLAS,
        "qkv_fused": _R_TP_QKV,
        "sampled": _R_SAMPLED_TP,
    },
    "tp_spmd": {
        "head:softmax": _R_SPMD_HEAD,
        "head:binary": _R_SPMD_HEAD,
        "head:multilabel": _R_SPMD_HEAD,
        "attn:pallas": _R_TPSPMD_ATTN,
        "dropout:pallas": _R_TPSPMD_ATTN,
        "embed:pallas": _R_SPMD_EMBED,
        "qkv_fused": _R_TP_QKV,
        "sampled": _R_SAMPLED_SPMD,
    },
    "sampled_spmd": {
        "head:binary": _R_SAMPLED_HEAD,
        "head:multilabel": _R_SAMPLED_HEAD,
        "attn:pallas": _R_SSPMD_PALLAS,
        "dropout:pallas": _R_SSPMD_PALLAS,
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
) -> None:
    """Raise ValueError with the matrix reason if the combination is
    unsupported; silent when it composes. Tier constructors and the training
    driver both call this BEFORE building a step."""
    if tier not in TIERS:
        raise ValueError(f"unknown tier {tier!r}; expected one of {TIERS}")
    if tier in UNPORTED:
        raise ValueError(
            f"tier {tier!r} is not ported yet (the port has "
            f"{tuple(t for t in TIERS if t not in UNPORTED)})"
        )
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
