"""Tensor parallelism over a mesh's 'model' axis: the collectives that the
split operators need (Megatron's three), as autograd Functions on this
rank's model group (its data row of a parallel/mesh.py::make_mesh_2d mesh).

The JAX package gets the same placement from GSPMD, which inserts the
collectives from the operators' shardings with no change to the model
(its `parallel/mesh.py:55-98`). Here models/gqe.py carries them, through
its `tp` argument:

- `copy`: identity forward, all-reduce of the gradient backward (the input
  of a column-parallel product, whose gradient each rank holds a part of);
- `gather`: all-gather of the last dim forward (the whole features of a
  column-parallel product), this rank's columns of the gradient backward;
- `reduce`: all-reduce forward (the partial sums of a row-parallel
  product), identity backward.

Each collective adds one to parallel/mesh.py's COLLECTIVES under 'model'.
At a model axis of 1 each is a copy, and the step is the 1-D mesh's.
"""

from __future__ import annotations

import dataclasses

import torch

from graphqembed_tpu_torch.parallel.mesh import (
    MODEL,
    Mesh,
    all_gather_model,
    all_reduce_model,
)


@dataclasses.dataclass(frozen=True)
class TensorParallel:
    """This rank's model group (None: the default group), its size and
    this rank's index in it."""
    group: object
    size: int
    index: int

    def columns(self, x: torch.Tensor) -> torch.Tensor:
        """This rank's block of x's last dim."""
        e = x.shape[-1] // self.size
        return x[..., self.index * e:(self.index + 1) * e]

    def copy(self, x: torch.Tensor) -> torch.Tensor:
        return _CopyToModel.apply(x, self)

    def gather(self, x: torch.Tensor) -> torch.Tensor:
        return _GatherFromModel.apply(x, self)

    def reduce(self, x: torch.Tensor) -> torch.Tensor:
        return _ReduceFromModel.apply(x, self)


def model_parallel(mesh: Mesh | None) -> TensorParallel | None:
    """The 'model' axis of a 2-D mesh, or None for no mesh or a 1-D one."""
    if mesh is None or MODEL not in mesh.axis_names:
        return None
    return TensorParallel(mesh.model_group, mesh.shape[1], mesh.coords[1])


def _summed(t: torch.Tensor, tp: TensorParallel) -> torch.Tensor:
    """A new contiguous tensor: t summed over the model ranks."""
    return all_reduce_model(t.contiguous().clone(), tp.group)


class _CopyToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, tp):
        ctx.tp = tp
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _summed(g, ctx.tp), None


class _GatherFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, tp):
        ctx.tp = tp
        parts = all_gather_model(x, tp.group, tp.size)   # [M, ..., e]
        return parts.movedim(0, -2).reshape(*x.shape[:-1], tp.size * x.shape[-1])

    @staticmethod
    def backward(ctx, g):
        return ctx.tp.columns(g), None


class _ReduceFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, tp):
        return _summed(x, tp)

    @staticmethod
    def backward(ctx, g):
        return g, None
