"""Catalog-row padding (counterpart of ``bert4clickpath_tpu/ops/pallas/fused_ce.py``).

Only :func:`padded_rows` is ported so far: it is the single source of the
catalog padding that training, eval and serving share. The fused-CE
kernels come into this module with the training slice.
"""

from __future__ import annotations


def padded_rows(v: int) -> int:
    """Smallest row count >= v that the fused-CE vocab tile and
    chunked_eval's ``pick_chunk`` accept: a multiple of 128 below the 4096
    whole-table cutoff, of 1024 above, of 65536 past 1M rows. Padding rows
    are blinded by every consumer (chunked_scores)."""
    if v > 1_000_000:
        return v + (-v % 65536)
    return v + (-v % (1024 if v > 4096 else 128))
