"""Streaming masked metrics as dicts of sums (counterpart of
``bert4clickpath_tpu/ops/metrics.py``).

Each ``*_stats`` returns a dict of scalar **sums** plus a count ``n``, as
tensors on the inputs' device (no host sync); accumulate with
:func:`merge` and read rates with :func:`finalize`, which fetches once.
:func:`psum_stats` sums them over a mesh axis (``parallel/mesh.py``).

``torch.topk`` and ``lax.top_k`` may order exact ties differently; the sums
agree wherever no tie straddles a cut-off.
"""

from __future__ import annotations

from typing import Callable, Mapping, Sequence

import numpy as np
import torch

from bert4clickpath_torch.constants import LABEL_PAD
from bert4clickpath_torch.parallel.mesh import sum_flat


def _mask(labels: torch.Tensor) -> torch.Tensor:
    return (labels != LABEL_PAD).float()


def ranking_stats(
    logits: torch.Tensor, labels: torch.Tensor, ks: Sequence[int] = (5, 10),
) -> dict[str, torch.Tensor]:
    """Recall@k and NDCG@k sums for single-ground-truth ranking.

    logits: (B, P, V); labels: (B, P) int with LABEL_PAD fill. Each masked
    position has exactly one true item, so IDCG = 1 and NDCG reduces to
    1/log2(rank + 2) if the true item ranks within k.
    """
    mask = _mask(labels)
    kmax = min(max(ks), logits.shape[-1])  # clamp for tiny test vocabularies
    topk = torch.topk(logits, kmax, dim=-1).indices  # (B, P, kmax)
    hit = (topk == labels[..., None]).float()  # one-hot over rank
    ranks = torch.arange(2, kmax + 2, dtype=torch.float32, device=logits.device)
    discounts = 1.0 / (torch.log(ranks) / torch.log(torch.tensor(2.0, device=logits.device)))
    stats = {"n": mask.sum()}
    for k in ks:
        kk = min(k, kmax)
        stats[f"recall@{k}_sum"] = (hit[..., :kk].sum(-1) * mask).sum()
        stats[f"ndcg@{k}_sum"] = ((hit[..., :kk] * discounts[:kk]).sum(-1) * mask).sum()
    return stats


def masked_accuracy_stats(logits: torch.Tensor, labels: torch.Tensor) -> dict:
    """Top-1 accuracy sum over non-pad positions."""
    mask = _mask(labels)
    correct = (logits.argmax(dim=-1) == labels).float() * mask
    return {"n": mask.sum(), "accuracy_sum": correct.sum()}


def binary_stats(
    logits: torch.Tensor, labels: torch.Tensor, threshold: float = 0.5,
) -> dict[str, torch.Tensor]:
    """Streaming counts for binary tasks over (B, P) logits / {0, 1, -1}
    labels: positives, predicted positives (sigmoid >= threshold) and true
    positives in one pass."""
    mask = _mask(labels)
    labels_f = torch.where(mask > 0, labels.float(), 0.0)
    pred = (torch.sigmoid(logits.float()) >= threshold).float() * mask
    return {
        "n": mask.sum(),
        "positives_sum": labels_f.sum(),
        "pred_positives_sum": pred.sum(),
        "tp_sum": (pred * labels_f).sum(),
    }


def masked_metric(fn: Callable, name: str) -> Callable:
    """Turn a per-position metric ``fn(logits, labels) -> (B, P)`` into a
    pad-masked streaming stat ``{"n", f"{name}_sum"}`` that accumulates with
    :func:`merge` and reads out via :func:`finalize`. For metrics that are
    not a per-position mean, use :func:`masked_stateful_metric`."""

    def stats_fn(logits: torch.Tensor, labels: torch.Tensor) -> dict:
        mask = _mask(labels)
        vals = torch.as_tensor(fn(logits, labels)).float()
        if vals.shape != labels.shape:
            raise ValueError(
                f"metric fn for {name!r} returned shape {tuple(vals.shape)}; "
                f"expected per-position values of shape {tuple(labels.shape)}"
            )
        return {"n": mask.sum(), f"{name}_sum": (vals * mask).sum()}

    return stats_fn


def masked_stateful_metric(fn: Callable) -> Callable:
    """Pad-masked wrapper for metrics with arbitrary (vector) accumulators:
    ``fn(logits, labels, mask) -> dict`` of sum-reducible tensors; this
    wrapper adds the masked-position count ``n``."""

    def stats_fn(logits: torch.Tensor, labels: torch.Tensor) -> dict:
        mask = _mask(labels)
        stats = dict(fn(logits, labels, mask))
        stats.setdefault("n", mask.sum())
        return stats

    return stats_fn


def auc_stats(
    logits: torch.Tensor, labels: torch.Tensor, num_thresholds: int = 200,
) -> dict[str, torch.Tensor]:
    """Streaming ROC-AUC accumulators for binary (B, P) logits: per-threshold
    TP/FP/FN/TN counts over ``sigmoid(logit)``, thresholds laid out like
    Keras AUC (num_thresholds - 2 evenly spaced in (0, 1) plus -eps / 1+eps
    endpoints); :func:`finalize` turns them into trapezoidal ROC-AUC."""

    def fn(logits, labels, mask):
        dev = logits.device
        probs = torch.sigmoid(logits.float())
        eps = 1e-7
        inner = torch.arange(1, num_thresholds - 1, dtype=torch.float32, device=dev) / (num_thresholds - 1)
        thr = torch.cat([torch.tensor([-eps], device=dev), inner, torch.tensor([1.0 + eps], device=dev)])  # (T,)
        labels_f = torch.where(mask > 0, labels.float(), 0.0)
        flat_p, flat_y, flat_m = probs.reshape(-1), labels_f.reshape(-1), mask.reshape(-1)
        pred = (flat_p[None, :] > thr[:, None]).float()  # (T, N)
        tp = (pred * (flat_y * flat_m)[None, :]).sum(dim=1)
        fp = (pred * ((1.0 - flat_y) * flat_m)[None, :]).sum(dim=1)
        pos = (flat_y * flat_m).sum()
        neg = ((1.0 - flat_y) * flat_m).sum()
        return {"auc_tp": tp, "auc_fp": fp, "auc_fn": pos - tp, "auc_tn": neg - fp}

    return masked_stateful_metric(fn)(logits, labels)


def merge(*stats: Mapping[str, torch.Tensor]) -> dict:
    """Elementwise-add accumulators (on whatever device they lie)."""
    out = dict(stats[0])
    for s in stats[1:]:
        for k, v in s.items():
            out[k] = out[k] + v if k in out else v
    return out


@torch.no_grad()
def psum_stats(stats: Mapping[str, torch.Tensor], mesh, axis: str = "data") -> dict:
    """Every sum summed over the mesh axis (the data group by default): one
    ``all_reduce`` of the packed sums, outside autograd."""
    keys = list(stats)
    return dict(zip(keys, sum_flat([stats[k] for k in keys], mesh, axis)))


def finalize(stats: Mapping[str, torch.Tensor]) -> dict[str, float]:
    """Turn sums into rates: every ``*_sum`` key divided by ``n``. The one
    place the accumulators are fetched from the device."""
    tensors = {k: torch.as_tensor(v).detach() for k, v in stats.items()}
    device = next((t.device for t in tensors.values() if t.device.type != "cpu"), "cpu")
    flat = torch.cat([t.to(device).double().reshape(-1) for t in tensors.values()]).cpu().numpy()
    host, at = {}, 0
    for k, t in tensors.items():
        host[k] = flat[at : at + t.numel()].reshape(tuple(t.shape))
        at += t.numel()
    n = float(host["n"])
    out: dict[str, float] = {"n": n}
    denom = max(n, 1.0)
    for k, v in host.items():
        if k.endswith("_sum"):
            out[k[: -len("_sum")]] = float(v) / denom
    # derived binary metric: F1
    if "tp_sum" in host:
        denom_f1 = float(host["positives_sum"]) + float(host["pred_positives_sum"])
        out["f1"] = 2.0 * float(host["tp_sum"]) / denom_f1 if denom_f1 > 0 else 0.0
    # bucketed ROC-AUC from auc_stats' per-threshold confusion counts
    if "auc_tp" in host:
        tp, fp, fn_, tn = (host[k] for k in ("auc_tp", "auc_fp", "auc_fn", "auc_tn"))
        tpr = tp / np.maximum(tp + fn_, 1e-12)
        fpr = fp / np.maximum(fp + tn, 1e-12)
        # thresholds ascend -> (fpr, tpr) descend; trapezoid over the ROC
        out["auc"] = float(np.sum((fpr[:-1] - fpr[1:]) * (tpr[:-1] + tpr[1:]) / 2.0))
    return out
