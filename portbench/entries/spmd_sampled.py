"""Sampled softmax over the row-sharded table, on a mesh of one rank.

``bert4clickpath_torch/parallel/spmd.py:make_sampled_spmd_train_step`` with
``num_samples`` the mix's ``negatives``, over a state from
``init_sharded_state`` (set up as ``entries/spmd_full_ce.py`` sets up the
full softmax's), as ``examples/large_catalog/stress_torch.py --sampled``
wires it: no CE kernel; the labels' and the negatives' rows through the
sharded lookup, Adam on every parameter. Each step passes its pool batch's
negatives, which the benchmark drew from the seed, so the program scores
the rows the reference scores.
"""

from __future__ import annotations

from bert4clickpath_torch.parallel import spmd

from portbench.entries.spmd_full_ce import sharded_session
from portbench.harness import traffic as traffic_lib
from portbench.harness.session import Session


def build(cfg: dict, traffic: traffic_lib.Traffic, fill_weights, seeds: dict, device) -> Session:
    def make_step(model, mesh, tx, schedule):
        sampled = spmd.make_sampled_spmd_train_step(model, mesh, tx, schedule, cfg["n_items"],
                                                    traffic.params["negatives"])
        return lambda state, batch, generator: sampled(state, batch, generator, batch["negatives"])

    return sharded_session(cfg, traffic, fill_weights, seeds, device, make_step)
