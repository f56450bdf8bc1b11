"""bert4clickpath_torch — the PyTorch/CUDA port of bert4clickpath_tpu.

The JAX package stays the reference; this package mirrors its module paths
and names so each counterpart is easy to find. It imports torch and numpy
and never jax, flax, optax, orbax or anything of ``bert4clickpath_tpu``.

What is ported so far is the serving path, the train step, the
long-session path and the training run. Serving: an exported bundle is
loaded by :class:`bert4clickpath_torch.training.serving.ServingModel`,
encoded on the host, run through :class:`ClickstreamModel` and ranked
against the full catalog by the chunked scan. Training: Cloze batches from
:class:`bert4clickpath_torch.data.pipeline.ClozeDataset` go through
``training.train_state.make_train_step`` (or ``make_scan_train_step``): the
model, the fused softmax CE, and a hand-written Adam;
:class:`bert4clickpath_torch.training.trainer.Trainer` runs epochs of them
with full-catalog eval (``make_eval_step``, ``ops.metrics``), plateau cuts,
early stopping, checkpoints and the serving export, as
``examples/bert4rec/train_torch.py`` drives it. Eleven hand-written CUDA
kernels (``csrc/``, one for every Pallas kernel of the JAX package) carry
these paths: the fused embedding gather, whole-row and blockwise attention
forward and backward, the fused CE forward, its merged backward and its
two-pass (dx, dW) backward, and the fused dropout.
"""

__version__ = "0.1.0"

from bert4clickpath_torch.config import FeatureConfig, HeadConfig, ModelConfig  # noqa: F401
from bert4clickpath_torch.vocab import Vocabulary  # noqa: F401
