"""Quantization ops (mirrors shallow_ntc_tpu/ops/rounding.py): rounding and
the additive uniform noise of training."""

from typing import Optional

import torch


def round_st(x: torch.Tensor, offset: Optional[torch.Tensor] = None) -> torch.Tensor:
  """Straight-through rounding: forward rounds (about `offset`), grad is identity."""
  if offset is None:
    rounded = torch.round(x)
  else:
    rounded = torch.round(x - offset) + offset
  return x + (rounded - x).detach()


def sample_unoise(loc: torch.Tensor, noise: Optional[torch.Tensor] = None,
                  generator: Optional[torch.Generator] = None) -> torch.Tensor:
  """Additive uniform noise U(-.5, .5): the Balle-2017 proxy for quantization.

  `noise` is given explicitly (tests feed JAX's draws) or drawn from
  `generator` on loc's device.
  """
  if noise is None:
    noise = torch.rand(loc.shape, generator=generator, dtype=loc.dtype, device=loc.device) - 0.5
  elif noise.shape != loc.shape:
    raise ValueError(f"noise of shape {tuple(noise.shape)} for a loc of {tuple(loc.shape)}")
  return loc + noise


def quantize_eval(loc: torch.Tensor, offset: Optional[torch.Tensor] = None) -> torch.Tensor:
  """Hard rounding about an offset grid: the eval-time sample."""
  if offset is None:
    return torch.round(loc)
  return torch.round(loc - offset) + offset
