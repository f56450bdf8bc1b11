"""How ``correct`` is decided: the program's first steps against the
reference's.

Set-up drives the program's step through its first ``CHECKED_STEPS`` steps,
with the window's own call and feed, and reads from it, before the window:

* each step's loss;
* each leaf's first gradient as Adam holds it after one step: its norm from
  the second moment ((1 - b2) g^2, kept in float32), and the gradient itself
  from the first moment ((1 - b1) g), whole for every leaf and for an item
  table of up to ``FULL_TABLE_ROWS`` rows; of a larger table the rows of
  :func:`kept_rows` are kept: ``SAMPLE_ROWS`` drawn from the seed and every
  row a label of the checked batches falls on, where the label term of the
  softmax's gradient lies;
* the norm of each leaf's change after the checked steps, against the run's
  initial weights drawn again from the seed.

After the window the reference (``portbench/reference/``) runs the same
steps from the same seed: the weights and inputs the benchmark made, the
Cloze batches and dropout masks worked out again. Four numbers compare
the two, each against the cell's limit; a leaf's gap is taken over the
larger of the reference's norm of that leaf and of the median leaf:

* ``first_loss_gap``: |loss - reference| / reference at the first step (the
  later steps' losses are printed, not judged: Adam moves every weight
  whose gradient is nought to rounding by a whole step of either sign, so
  from the second step on the losses part by that noise);
* ``grad_gap``: the worst leaf's gap of first-gradient norms;
* ``grad_diff``: the worst leaf's norm of the difference of the first
  gradients (a gap of norms is of second order in a rounding error, and
  leaves a program one precision lower than the configuration's close to
  the right one; the norm of the difference is of first order);
* ``change_gap``: the worst leaf's gap of the norms of the change.

``grad_diff`` and ``change_gap`` leave out the leaves whose reference
gradient (root mean square) is under 1e-3 of the median leaf's: a leaf with
a gradient of nought in exact arithmetic (a key's bias under softmax) moves
under Adam by rounding alone, on either side.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Callable, Optional

import numpy as np
import torch

from portbench.harness import weights as weights_lib
from portbench.reference import cloze as ref_cloze
from portbench.reference import model as ref

CHECKED_STEPS = 3
EXCLUDE_BELOW = 1e-3  # of the median leaf's reference gradient (rms)
CE_BLOCK_ROWS = 262_144
FULL_TABLE_ROWS = 1 << 20  # an item table up to this size has its first gradient kept whole
SAMPLE_ROWS = 16_384  # rows drawn from a larger table whose first gradient is kept
TABLE = "embed_items.weight"
NUMBERS = ("first_loss_gap", "grad_gap", "grad_diff", "change_gap")


@dataclass
class Readings:
    losses: list
    grad_norms: dict
    first_grads: dict  # leaf -> float32 CPU tensor (the table: its kept rows)
    change_norms: dict


def kept_rows(cfg: dict, seed: int, batches_of: Callable[[], list]) -> Optional[torch.Tensor]:
    """The item table's rows whose first gradient is compared: None (all
    of them) for a table of up to ``FULL_TABLE_ROWS`` rows; else
    ``SAMPLE_ROWS`` rows drawn from the seed and the row of every label of
    the checked batches (``batches_of()``, as the reference works them out),
    so that a gradient written to the wrong label row shows."""
    table_rows = cfg["table_rows"]
    if table_rows <= FULL_TABLE_ROWS:
        return None
    rng = np.random.default_rng(weights_lib.mix(seed, weights_lib.SAMPLE))
    sample = rng.choice(table_rows, size=min(SAMPLE_ROWS, table_rows), replace=False)
    labels = np.concatenate([b["labels"][b["labels"] != ref.LABEL_PAD] for b in batches_of()])
    return torch.from_numpy(np.union1d(sample, labels.astype(np.int64) + ref.NUM_RESERVED))


def kept_gradient(grads: dict, rows: Optional[torch.Tensor], scale: float = 1.0) -> dict:
    """Each leaf's gradient on the host in float32 (the table: ``rows``,
    or whole where ``rows`` is None)."""
    out = {}
    for name, g in grads.items():
        part = g[rows.to(g.device)] if name == TABLE and rows is not None else g
        out[name] = part.float().cpu() * scale
    return out


def sum_f64(t: torch.Tensor, chunk: int = 1 << 26) -> float:
    flat = t.reshape(-1)
    return float(sum(flat[i : i + chunk].double().sum() for i in range(0, flat.numel(), chunk)))


def program_steps(session, cfg: dict, seed: int, rows: Optional[torch.Tensor]) -> Readings:
    """Run the program's checked steps through the session and read them
    (of the table's first gradient, ``rows``)."""
    opt = cfg["optimizer"]
    losses, grad_norms, first = [], {}, {}
    for k in range(CHECKED_STEPS):
        loss = session.step(session.next())
        losses.append(float(loss))
        if k == 0:
            nu = session.second_moments()
            grad_norms = {n: math.sqrt(max(sum_f64(nu[n]), 0.0) / (1.0 - opt["b2"])) for n in nu}
            first = kept_gradient(session.first_moments(), rows, 1.0 / (1.0 - opt["b1"]))
    change = weights_lib.change_norms(session.params, ref.param_specs(cfg), seed, cfg["init"]["table_std"])
    return Readings(losses, grad_norms, first, change)


def reference_batches(traffic, cfg: dict, seeds: dict) -> list:
    """The inputs of the checked steps, as the reference works them out."""
    if traffic.kind == "synthetic":
        return [traffic.pool[k % len(traffic.pool)] for k in range(CHECKED_STEPS)]
    t = traffic.params
    return ref_cloze.train_batches(
        traffic.sessions, t["batch"], seeds["batches"], CHECKED_STEPS, t["max_items"], t["max_masked"],
        t["masked_percentage"],
    )


def reference_steps(cfg: dict, batches: list, seed: int, seeds: dict, device, rows: Optional[torch.Tensor],
                    numerics: str = "float32", frozen: bool = False) -> tuple[Readings, dict]:
    """The reference's checked steps: (readings, gradient rms of each leaf
    at the first step). ``numerics="fp8"`` is the lower-precision control;
    ``frozen`` leaves the state unchanged (a fault's reading)."""
    ref.check_supported(cfg)
    prev_tf32 = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        specs = ref.param_specs(cfg)
        std = cfg["init"]["table_std"]
        params = weights_lib.draw(specs, seed, std, device)
        for p in params.values():
            p.requires_grad_(True)
        adam = ref.Adam(params, cfg["optimizer"])
        generator = torch.Generator(device).manual_seed(seeds["dropout"])
        num = ref.Numerics(numerics)
        losses, grad_norms, first = [], {}, {}
        for k, b in enumerate(batches):
            on_device = {k2: torch.from_numpy(np.ascontiguousarray(v)).to(device) for k2, v in b.items()}
            loss = ref.loss_fn(params, cfg, on_device, generator, num, CE_BLOCK_ROWS)
            grads = dict(zip(params, torch.autograd.grad(loss, list(params.values()))))
            losses.append(float(loss.detach()))
            if k == 0:
                grad_norms = ref.leaf_norms(grads)
                first = kept_gradient(grads, rows)
            if not frozen:
                adam.update(params, grads)
            del grads, loss
        sizes = {n: p.numel() for n, p in params.items()}
        with torch.no_grad():
            change = weights_lib.change_norms(params, specs, seed, std)
        del params, adam
        return Readings(losses, grad_norms, first, change), ref.gradient_rms(grad_norms, sizes)
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = prev_tf32


def leaf_gaps(ours: dict, theirs: dict, names) -> dict:
    floor = ref.median(theirs[n] for n in names)
    return {n: abs(ours[n] - theirs[n]) / max(theirs[n], floor) for n in names}


def difference_gaps(ours: dict, theirs: dict, names) -> dict:
    norms = {n: float(torch.linalg.vector_norm(theirs[n])) for n in theirs}
    floor = ref.median(norms.values())
    return {n: float(torch.linalg.vector_norm(ours[n] - theirs[n])) / max(norms[n], floor) for n in names}


def compare(ours: Readings, theirs: Readings, rms: dict) -> tuple[dict, dict]:
    """(numbers, where each was read: the leaf, the leaves left out, and
    every step's and leaf's gap)."""
    loss_gaps = [abs(a - b) / abs(b) for a, b in zip(ours.losses, theirs.losses)]
    grads = leaf_gaps(ours.grad_norms, theirs.grad_norms, list(theirs.grad_norms))
    floor = ref.median(rms.values())
    kept = [n for n in theirs.change_norms if rms[n] >= EXCLUDE_BELOW * floor]
    diffs = difference_gaps(ours.first_grads, theirs.first_grads, kept)
    changes = leaf_gaps(ours.change_norms, theirs.change_norms, kept)
    numbers = {"first_loss_gap": loss_gaps[0], "grad_gap": max(grads.values()),
               "grad_diff": max(diffs.values()), "change_gap": max(changes.values())}
    where = {"grad_gap": max(grads, key=grads.get), "grad_diff": max(diffs, key=diffs.get),
             "change_gap": max(changes, key=changes.get), "left_out": sorted(set(theirs.change_norms) - set(kept)),
             "steps": loss_gaps, "grad_leaves": grads, "diff_leaves": diffs, "change_leaves": changes}
    return numbers, where


def judge(numbers: dict, limits: dict) -> bool:
    return all(math.isfinite(numbers[k]) and numbers[k] <= limits[k] for k in NUMBERS)
