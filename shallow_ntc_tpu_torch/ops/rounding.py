"""Quantization ops of the eval path (mirrors shallow_ntc_tpu/ops/rounding.py)."""

from typing import Optional

import torch


def round_st(x: torch.Tensor, offset: Optional[torch.Tensor] = None) -> torch.Tensor:
  """Straight-through rounding: forward rounds (about `offset`), grad is identity."""
  if offset is None:
    rounded = torch.round(x)
  else:
    rounded = torch.round(x - offset) + offset
  return x + (rounded - x).detach()


def quantize_eval(loc: torch.Tensor, offset: Optional[torch.Tensor] = None) -> torch.Tensor:
  """Hard rounding about an offset grid: the eval-time sample."""
  if offset is None:
    return torch.round(loc)
  return torch.round(loc - offset) + offset
