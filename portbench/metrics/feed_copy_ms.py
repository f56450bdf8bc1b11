"""Host milliseconds per step of the timed window spent moving batches to
the card (the program's span ``b4cp.feed.copy``, ``to_device``, from its
counter registry): the copies from pageable memory and the synchronise
that follows them, so the wait for the step already queued."""

from portbench.harness import spans


def read(ctx):
    return spans.host_ms_per_step(ctx, "b4cp.feed.copy")
