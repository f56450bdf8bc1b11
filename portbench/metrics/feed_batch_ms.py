"""Host milliseconds per step of the timed window spent making Cloze
batches (the program's span ``b4cp.feed.batch`` in
``ClozeDataset.train_batches``, from its counter registry)."""

from portbench.harness import spans


def read(ctx):
    return spans.host_ms_per_step(ctx, "b4cp.feed.batch")
