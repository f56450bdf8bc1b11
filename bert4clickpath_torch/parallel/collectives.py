"""The Megatron f/g pair over the mesh's model group (counterpart of
``bert4clickpath_tpu/parallel/collectives.py``).

Tensor-parallel layers are built from two conjugate operations (Shoeybi et
al. 2019), each a ``torch.autograd.Function`` whose only collective is
``parallel/mesh.py:all_reduce`` (a no-op over a group of one; gloo carries
only ``all_reduce`` and ``broadcast`` for CUDA tensors):

* :func:`psum_bwd` ("f"): identity forward, sum backward. Placed where a
  replicated activation fans out into column-parallel compute: each rank's
  input gradient holds only its columns' share, and the sum over the model
  group restores the full, replicated gradient.
* :func:`psum_fwd` ("g"): sum forward, identity backward. Placed where the
  row-parallel partials are assembled: the output is replicated, so its
  gradient is already the full gradient of every rank's partial.

Both sum in f32 and return the input's dtype.
"""

from __future__ import annotations

import torch

from bert4clickpath_torch.parallel.mesh import MODEL_AXIS, Mesh, all_reduce


def _summed(t: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    return all_reduce(t.float().clone(), mesh, MODEL_AXIS).to(t.dtype)


class _PsumFwd(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh):
        return _summed(x, mesh)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _PsumBwd(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _summed(g, ctx.mesh), None


def psum_fwd(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """Sum over the model group forward, identity backward (Megatron "g")."""
    return _PsumFwd.apply(x, mesh)


def psum_bwd(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """Identity forward, sum over the model group backward (Megatron "f")."""
    return _PsumBwd.apply(x, mesh)
