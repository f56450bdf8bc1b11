"""bert4clickpath_torch — the PyTorch/CUDA port of bert4clickpath_tpu.

The JAX package stays the reference; this package mirrors its module paths
and names so each counterpart is easy to find. It imports torch and numpy
and never jax, flax, optax, orbax or anything of ``bert4clickpath_tpu``.

What is ported so far is the serving path and the train step. Serving: an
exported bundle is loaded by
:class:`bert4clickpath_torch.training.serving.ServingModel`, encoded on the
host, run through :class:`ClickstreamModel` and ranked against the full
catalog by the chunked scan. Training: Cloze batches from
:class:`bert4clickpath_torch.data.pipeline.ClozeDataset` go through
``training.train_state.make_train_step`` (or ``make_scan_train_step``): the
model, the fused softmax CE, and a hand-written Adam. Five hand-written
CUDA kernels carry both paths: the fused embedding gather, the masked MHA
forward and backward, and the fused CE forward and backward.
"""

__version__ = "0.1.0"

from bert4clickpath_torch.config import FeatureConfig, HeadConfig, ModelConfig  # noqa: F401
from bert4clickpath_torch.vocab import Vocabulary  # noqa: F401
