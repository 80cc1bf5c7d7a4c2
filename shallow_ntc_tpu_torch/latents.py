"""Latent random variables (mirrors shallow_ntc_tpu/latents.py, loc only)."""

import dataclasses
from typing import Tuple

import torch


@dataclasses.dataclass
class UQLatentRV:
  """A continuous latent expected to be uniformly quantized."""

  loc: torch.Tensor


@dataclasses.dataclass
class LatentRVCollection:
  """The latents of one image batch: uq = (z, y) for mshyper."""

  uq: Tuple[UQLatentRV, ...] = ()
