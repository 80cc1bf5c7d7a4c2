"""Bounding ops with identity-if-towards gradients (tfc lower/upper_bound).

The gradient passes where the input is inside the feasible region, or where
it would push the clipped value back towards it.
"""

import torch


class _LowerBound(torch.autograd.Function):

  @staticmethod
  def forward(ctx, x, bound):
    ctx.save_for_backward(x)
    ctx.bound = bound
    return torch.clamp(x, min=bound)

  @staticmethod
  def backward(ctx, g):
    (x,) = ctx.saved_tensors
    pass_through = (x >= ctx.bound) | (g < 0)
    return torch.where(pass_through, g, torch.zeros_like(g)), None


class _UpperBound(torch.autograd.Function):

  @staticmethod
  def forward(ctx, x, bound):
    ctx.save_for_backward(x)
    ctx.bound = bound
    return torch.clamp(x, max=bound)

  @staticmethod
  def backward(ctx, g):
    (x,) = ctx.saved_tensors
    pass_through = (x <= ctx.bound) | (g > 0)
    return torch.where(pass_through, g, torch.zeros_like(g)), None


def lower_bound(x: torch.Tensor, bound: float) -> torch.Tensor:
  """max(x, bound) with identity-if-towards gradient."""
  return _LowerBound.apply(x, float(bound))


def upper_bound(x: torch.Tensor, bound: float) -> torch.Tensor:
  """min(x, bound) with identity-if-towards gradient."""
  return _UpperBound.apply(x, float(bound))
