"""bert4clickpath_torch — the PyTorch/CUDA port of bert4clickpath_tpu.

The JAX package stays the reference; this package mirrors its module paths
and names so each counterpart is easy to find. It imports torch and numpy
and never jax, flax, optax, orbax or anything of ``bert4clickpath_tpu``.

What is ported so far is the serving path: an exported bundle is loaded by
:class:`bert4clickpath_torch.training.serving.ServingModel`, encoded on the
host, run through :class:`ClickstreamModel` (two hand-written CUDA kernels:
the fused embedding gather and the masked MHA forward) and ranked against
the full catalog by the chunked scan.
"""

__version__ = "0.1.0"

from bert4clickpath_torch.config import FeatureConfig, HeadConfig, ModelConfig  # noqa: F401
from bert4clickpath_torch.vocab import Vocabulary  # noqa: F401
