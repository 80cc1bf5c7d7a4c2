"""Mean-scale hyperprior model (Minnen 2018), eval path.

Mirrors shallow_ntc_tpu/models/mshyper.py:
  x -> pad -> analysis -> y -> hyper-analysis -> z
  z -> [deep-factorized prior] -> z_hat, bits(z)
  z_hat -> hyper-synthesis -> (mu, scale index = exp(.))
  y -> [64-scale indexed noisy Gaussian, loc=mu] -> y_hat, bits(y)
  y_hat -> synthesis -> x_hat -> unpad
  rd_loss = bpp + scheduled_lambda * mse (255 scale)
Only the 'unoise' branch at training=False is ported; training and SGA come later.
"""

from typing import Any, Mapping, Optional, Tuple

import torch
from torch import nn

from shallow_ntc_tpu_torch.latents import LatentRVCollection, UQLatentRV
from shallow_ntc_tpu_torch.models import base
from shallow_ntc_tpu_torch.models.transforms import build_transform
from shallow_ntc_tpu_torch.ops import entropy
from shallow_ntc_tpu_torch.ops import metrics_ops


class Model(nn.Module):
  """Mean-scale hyperprior model built from a model_config dict (flax names kept)."""

  def __init__(self, transform_config: Mapping[str, Any], scheduled_num_steps: int = 1_500_000,
               rd_lambda: float = 0.01, offset_heuristic: bool = True,
               latent_config: Optional[Mapping[str, Any]] = None):
    super().__init__()
    self.scheduled_num_steps = scheduled_num_steps
    self.rd_lambda = rd_lambda
    self.offset_heuristic = offset_heuristic
    self.latent_config = dict(latent_config or {"uq": {"method": "unoise"}})
    base.resolve_uq_config(self.latent_config)  # raises for unported methods
    tc = transform_config
    self._analysis = build_transform(tc["analysis"], 3)
    bottleneck = self._analysis.output_depth
    self._synthesis = build_transform(tc["synthesis"], bottleneck)
    self._hyper_analysis = build_transform(
        tc.get("hyper_analysis", dict(cls="HyperAnalysis", bottleneck_size=bottleneck)),
        bottleneck)
    hyper_bottleneck = self._hyper_analysis.output_depth
    self._hyper_synthesis = build_transform(
        tc.get("hyper_synthesis", dict(cls="HyperSynthesis", bottleneck_size=bottleneck)),
        hyper_bottleneck)
    self._prior = entropy.DeepFactorizedPrior(channels=hyper_bottleneck)
    self.downsample_factor = (self._analysis.downsample_factor
                              * self._hyper_analysis.downsample_factor)

  def infer_latent_rvs(self, x: torch.Tensor) -> LatentRVCollection:
    x = metrics_ops.pad_images(x, self.downsample_factor)
    y = self._analysis(x)
    z = self._hyper_analysis(y)
    return LatentRVCollection(uq=(UQLatentRV(loc=z), UQLatentRV(loc=y)))

  def hyper_synthesize(self, z_hat: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """z_hat -> (mu, scale_indexes); the index is made positive by exp."""
    mu, raw = torch.chunk(self._hyper_synthesis(z_hat), 2, dim=-1)
    return mu, torch.exp(raw)

  def synthesize(self, y_hat: torch.Tensor) -> torch.Tensor:
    return self._synthesis(y_hat)

  def prior_quantization_offset(self) -> Optional[torch.Tensor]:
    return self._prior.quantization_offset() if self.offset_heuristic else None

  def frame_loss_given_latent_rvs(self, image_batch: torch.Tensor,
                                  latent_rvs: LatentRVCollection, training: bool = False,
                                  step: int = 0):
    """Returns (rd_loss, metrics, reconstruction on the 255 scale)."""
    if training:
      raise NotImplementedError("training-mode losses are not ported yet")
    z_rv, y_rv = latent_rvs.uq
    z_hat, z_bits = entropy.batched_em_call(
        self._prior, z_rv.loc, self.prior_quantization_offset())
    mu, indexes = self.hyper_synthesize(z_hat)
    y_hat, y_bits = entropy.indexed_em_call(y_rv.loc, indexes, mu)
    reconstruction = metrics_ops.unpad_images(self.synthesize(y_hat), image_batch.shape)

    num_pixels = float(image_batch.shape[1] * image_batch.shape[2])
    bpp_terms = {
        "hyper_latent": torch.mean(z_bits) / num_pixels,
        "latent": torch.mean(y_bits) / num_pixels,
    }
    mse, psnr, extra, rec255 = base.distortion_metrics(image_batch, reconstruction, training)
    rd_loss, metrics = base.assemble_rd_loss(
        bpp_terms, mse, psnr, self.rd_lambda, step, self.scheduled_num_steps, extra)
    return rd_loss, metrics, rec255

  def end_to_end_frame_loss(self, image_batch: torch.Tensor, training: bool = False,
                            step: int = 0):
    latent_rvs = self.infer_latent_rvs(image_batch)
    return self.frame_loss_given_latent_rvs(image_batch, latent_rvs, training, step)
