"""The benchmark measures the port alone: no JAX in the process."""

from __future__ import annotations

import sys

# top-level module names, compared whole (the port's name begins with the
# JAX package's, so a prefix test would be wrong)
FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "optax", "orbax", "bert4clickpath_tpu"})


def forbidden_modules(modules=None) -> list:
    names = sys.modules if modules is None else modules
    return sorted({name.split(".", 1)[0] for name in names} & FORBIDDEN)
