"""The sampled softmax: the negatives the traffic carries, the reference's
loss over them, the kept rows, the FLOPs counted, and the faults read."""

from __future__ import annotations

import math

import numpy as np
import pytest
import torch

from conftest import ROOT
from portbench import calibrate
from portbench.harness import manifest
from portbench.harness import traffic as traffic_lib
from portbench.reference import common
from portbench.reference import model as ref

MIX = {"generator": "synthetic", "batch": 8, "pool": 3, "lengths": {"kind": "uniform", "min": 5, "max": 50},
       "max_items": 50, "max_masked": 10, "negatives": 64}
N_ITEMS = 1000


def problem(seed: int = 0, n: int = 12, s: int = 9, d: int = 6, n_items: int = 40):
    """x (n, d), a table of 10 + n_items rows, labels, and negatives of
    which two equal a row's own label (to be blinded)."""
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(n, d, generator=g)
    table = torch.randn(common.NUM_RESERVED + n_items, d, generator=g)
    labels = torch.randint(0, n_items, (n,), generator=g)
    negatives = torch.randint(0, n_items, (s,), generator=g)
    negatives[:2] = labels[:2]
    return x, table, labels, negatives, n_items


def float64_loss(x, table, labels, negatives, n_items):
    """-log softmax([label, negatives + log(V / S)])[label] in float64, the
    negatives equal to the row's label left out; the mean over rows."""
    x, table = x.double(), table.double()
    w = table[common.NUM_RESERVED :]
    logits = torch.cat([(x * w[labels]).sum(-1, keepdim=True),
                        x @ w[negatives].t() + math.log(n_items / len(negatives))], dim=1)
    hit = torch.cat([torch.zeros(len(labels), 1, dtype=torch.bool), negatives[None, :] == labels[:, None]], dim=1)
    logits = logits.masked_fill(hit, -math.inf)
    return torch.nn.functional.cross_entropy(logits, torch.zeros(len(labels), dtype=torch.long))


def test_sampled_ce_is_a_float64_softmax_over_the_label_and_negatives():
    x, table, labels, negatives, n_items = problem()
    x.requires_grad_(True)
    table.requires_grad_(True)
    ours = ref.sampled_ce(x, table, labels, negatives, n_items, common.Numerics())
    gx, gt = torch.autograd.grad(ours, [x, table])
    x64, t64 = x.detach().double().requires_grad_(True), table.detach().double().requires_grad_(True)
    want = float64_loss(x64, t64, labels, negatives, n_items)
    wx, wt = torch.autograd.grad(want, [x64, t64])
    assert ours.item() == pytest.approx(want.item(), rel=1e-6)
    assert torch.allclose(gx.double(), wx, rtol=1e-5, atol=1e-7) and torch.allclose(gt.double(), wt, rtol=1e-5, atol=1e-7)
    # only the labels' and the negatives' rows get a gradient
    touched = set((torch.cat([labels, negatives]) + common.NUM_RESERVED).tolist())
    assert set(torch.nonzero(gt.abs().sum(1)).reshape(-1).tolist()) == touched


def test_sampled_ce_blinds_a_negative_equal_to_the_label():
    x, table, labels, negatives, n_items = problem()
    # moving the row's own label among the negatives changes nothing for that row
    other = negatives.clone()
    other[0] = (labels[0] + 1) % n_items
    a = ref.sampled_ce(x[:1], table, labels[:1], negatives, n_items, common.Numerics())
    b = ref.sampled_ce(x[:1], table, labels[:1], other, n_items, common.Numerics())
    assert a.item() != pytest.approx(b.item(), rel=1e-6)
    assert a.item() == pytest.approx(float64_loss(x[:1], table, labels[:1], negatives, n_items).item(), rel=1e-6)


def test_sampled_ce_matches_the_programs_in_float32():
    from bert4clickpath_torch.ops.losses import sampled_softmax_ce

    x, table, labels, negatives, n_items = problem(seed=3, n=30, s=50, d=16, n_items=200)
    padded = labels.clone()
    padded[::4] = common.LABEL_PAD
    live = padded != common.LABEL_PAD
    x.requires_grad_(True)
    table.requires_grad_(True)
    nll = sampled_softmax_ce(x, table, padded, common.NUM_RESERVED, n_items, negatives)
    program = nll.sum() / live.sum()
    px, pt = torch.autograd.grad(program, [x, table])
    ours = ref.sampled_ce(x[live], table, labels[live], negatives, n_items, common.Numerics())
    rx, rt = torch.autograd.grad(ours, [x, table])
    assert ours.item() == pytest.approx(program.item(), rel=1e-6)
    assert torch.allclose(rx, px, atol=1e-6) and torch.allclose(rt, pt, atol=1e-6)


def test_the_loss_samples_where_the_batch_carries_negatives():
    cfg = dict(manifest.cell("large_catalog.sampled", ROOT).config, d_model=16, num_heads=2, ffn_dim=32,
               n_items=N_ITEMS, table_rows=1024, dropout_rate=0.0)
    traffic = traffic_lib.make(MIX, N_ITEMS, 11)
    params = {n: torch.randn(s) * 0.1 for n, s, _ in ref.param_specs(cfg)}
    batch = {k: torch.from_numpy(v) for k, v in traffic.pool[0].items()}
    full = {k: v for k, v in batch.items() if k != "negatives"}
    num = common.Numerics()
    sampled, whole = ref.loss_fn(params, cfg, batch, None, num, 256), ref.loss_fn(params, cfg, full, None, num, 256)
    x = ref.head_inputs(params, cfg, batch["tokens"], batch["positions"], None, num).reshape(-1, 16)
    live = batch["labels"].reshape(-1) != common.LABEL_PAD
    labels = batch["labels"].reshape(-1)[live].long()
    assert sampled.item() == ref.sampled_ce(x[live], params["embed_items.weight"], labels,
                                            batch["negatives"].long(), N_ITEMS, num).item()
    # the log-Q correction brings the sampled estimate near the full softmax, not onto it
    assert whole.item() != pytest.approx(sampled.item(), rel=1e-5)


def test_negatives_follow_the_seed_on_a_stream_of_their_own():
    a, b, c = (traffic_lib.make(MIX, N_ITEMS, s) for s in (2**40 + 5, 2**40 + 5, 2**40 + 6))
    plain = traffic_lib.make({k: v for k, v in MIX.items() if k != "negatives"}, N_ITEMS, 2**40 + 5)
    for x, y, z, p in zip(a.pool, b.pool, c.pool, plain.pool):
        assert x["negatives"].shape == (64,) and ((x["negatives"] >= 0) & (x["negatives"] < N_ITEMS)).all()
        assert np.array_equal(x["negatives"], y["negatives"]) and not np.array_equal(x["negatives"], z["negatives"])
        # the sessions are those of the mix without negatives
        assert all(np.array_equal(x[k], p[k]) for k in ("tokens", "positions", "labels"))
    assert not np.array_equal(a.pool[0]["negatives"], a.pool[1]["negatives"])
    with pytest.raises(ValueError):
        traffic_lib.make({"generator": "clickstream", "negatives": 8}, N_ITEMS, 1)


def test_model_flops_count_the_sampled_head():
    cfg = manifest.cell("large_catalog.sampled", ROOT).config
    batch = traffic_lib.make(MIX, N_ITEMS, 3).pool[0]
    stats = traffic_lib.batch_stats(batch)
    assert stats["negatives"] == 64
    full = {k: v for k, v in stats.items() if k != "negatives"}
    head = 2.0 * stats["labelled"] * cfg["d_model"]
    assert ref.model_flops(cfg, stats) - ref.model_flops(cfg, full) == pytest.approx(
        3 * head * (65 - cfg["n_items"]))


def test_faults_keep_the_negatives_whole_and_shift_them():
    batches = traffic_lib.make(MIX, N_ITEMS, 5).pool
    assert calibrate.faults_of(batches) == calibrate.FAULTS + ("negatives_shift",)
    assert calibrate.faults_of([{k: v for k, v in b.items() if k != "negatives"} for b in batches]) == calibrate.FAULTS
    half = calibrate.half_batch(batches)
    assert half[0]["tokens"].shape[0] == 4 and np.array_equal(half[0]["negatives"], batches[0]["negatives"])
    shifted = calibrate.negatives_shift(batches, N_ITEMS)
    assert np.array_equal(shifted[0]["negatives"], (batches[0]["negatives"] + 1) % N_ITEMS)
    assert np.array_equal(shifted[0]["labels"], batches[0]["labels"])
