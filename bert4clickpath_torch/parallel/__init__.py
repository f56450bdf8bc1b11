"""The parallel tiers of the port over ``torch.distributed`` (counterpart of
``bert4clickpath_tpu/parallel/``): the (data, model) mesh, the support
matrix, the row-sharded embedding ops, the data-parallel tier and the
vocab-sharded SPMD tier."""
