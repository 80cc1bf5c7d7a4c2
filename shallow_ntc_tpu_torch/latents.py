"""Latent random variables (mirrors shallow_ntc_tpu/latents.py)."""

import dataclasses
from typing import Optional, Tuple

import torch

from shallow_ntc_tpu_torch.ops import rounding


@dataclasses.dataclass
class UQLatentRV:
  """A continuous latent expected to be uniformly quantized."""

  loc: torch.Tensor

  def quantize(self, offset: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Straight-through hard quantization (the test-time value)."""
    return rounding.round_st(self.loc, offset)

  def sample(self, training: bool, method: Optional[str] = None,
             offset: Optional[torch.Tensor] = None, noise: Optional[torch.Tensor] = None,
             generator: Optional[torch.Generator] = None, **kwargs) -> torch.Tensor:
    """A sample by the configured relaxation (latents.py:180-206).

    training=False: hard round about `offset`, with no straight-through.
    training=True: 'unoise' (`noise` uniform), 'sga' (kwargs['tau'], `noise`
    logistic, about `offset`) or 'soft_round' (kwargs['alpha'], about
    `offset`). Unused kwargs (a uq config's other keys) are ignored.
    """
    if not training:
      return rounding.quantize_eval(self.loc, offset)
    if method == "unoise":
      return rounding.sample_unoise(self.loc, noise, generator)
    if method == "sga":
      return rounding.sga_round(self.loc, kwargs["tau"], offset, noise, generator)
    if method == "soft_round":
      return rounding.soft_round(self.loc, kwargs["alpha"], offset)
    raise NotImplementedError(f"Unknown sampling method: {method}")


@dataclasses.dataclass
class LatentRVCollection:
  """The latents of one image batch: uq = (z, y) for mshyper."""

  uq: Tuple[UQLatentRV, ...] = ()
