"""Factorized-prior model (Balle 2017).

Mirrors shallow_ntc_tpu/models/factorized.py: one latent y, coded under a
deep-factorized prior with no hyperprior.
  x -> pad -> analysis -> y
  y -> [deep-factorized prior] -> y_hat, bits(y)
  y_hat -> synthesis -> x_hat -> unpad
  rd_loss = bpp + scheduled_lambda * mse (255 scale)
The three relaxation branches are those of the mshyper model: 'unoise',
'mixedq' and the explicit sampling of iterative inference ('sga',
'soft_round'). In training the latent's noise is given as noise=(n_y,), or
drawn from a torch.Generator. transforms_dtype is the computation type of
the analysis and the synthesis, as in the mshyper model; the prior and the
latent stay float32. The metrics have one rate term, `bpp` (no `latent_bpp`).
"""

from typing import Any, Mapping, Optional, Tuple

import torch
from torch import nn

from shallow_ntc_tpu_torch.latents import LatentRVCollection, UQLatentRV
from shallow_ntc_tpu_torch.models import base
from shallow_ntc_tpu_torch.models.transforms import build_transform
from shallow_ntc_tpu_torch.ops import entropy
from shallow_ntc_tpu_torch.ops import metrics_ops
from shallow_ntc_tpu_torch.ops import rounding


class Model(nn.Module):
  """Factorized-prior model built from a model_config dict (flax names kept)."""

  def __init__(self, transform_config: Mapping[str, Any], scheduled_num_steps: int = 1_500_000,
               rd_lambda: float = 0.01, offset_heuristic: bool = True,
               latent_config: Optional[Mapping[str, Any]] = None,
               transforms_dtype: Optional[torch.dtype] = None):
    super().__init__()
    self.scheduled_num_steps = scheduled_num_steps
    self.rd_lambda = rd_lambda
    self.offset_heuristic = offset_heuristic
    self.latent_config = dict(latent_config or {"uq": {"method": "unoise"}})
    base.resolve_uq_config(self.latent_config)  # raises for an unknown method
    self.transforms_dtype = transforms_dtype
    self._analysis = build_transform(transform_config["analysis"], 3)
    bottleneck = self._analysis.output_depth
    self._synthesis = build_transform(transform_config["synthesis"], bottleneck)
    self._prior = entropy.DeepFactorizedPrior(channels=bottleneck)
    self.downsample_factor = self._analysis.downsample_factor

  def _in_transforms_dtype(self, x: torch.Tensor) -> torch.Tensor:
    return x if self.transforms_dtype is None else x.to(self.transforms_dtype)

  def infer_latent_rvs(self, x: torch.Tensor) -> LatentRVCollection:
    x = metrics_ops.pad_images(x, self.downsample_factor)
    return LatentRVCollection(uq=(UQLatentRV(loc=self._analysis(self._in_transforms_dtype(x))),))

  def training_noise(self, image_shape, generator: torch.Generator):
    """(u_y,): the uniform draw that a training step on a batch of
    `image_shape` [B, H, W, 3] takes from `generator`, at y's shape; what
    noise= takes (the mshyper model's training_noise)."""
    b, h, w = image_shape[:3]
    d = self.downsample_factor
    shape = (b, -(-h // d), -(-w // d), self._analysis.output_depth)
    return (rounding.uniform_noise(shape, generator, device=generator.device),)

  def synthesize(self, y_hat: torch.Tensor) -> torch.Tensor:
    return self._synthesis(self._in_transforms_dtype(y_hat))

  def prior_quantization_offset(self) -> Optional[torch.Tensor]:
    return self._prior.quantization_offset() if self.offset_heuristic else None

  def frame_loss_given_latent_rvs(self, image_batch: torch.Tensor,
                                  latent_rvs: LatentRVCollection, training: bool = False,
                                  step: int = 0, noise: Optional[Tuple[torch.Tensor]] = None,
                                  generator: Optional[torch.Generator] = None,
                                  frozen_offset: Optional[torch.Tensor] = None,
                                  itinf: bool = False,
                                  scalars: Optional[Mapping[str, torch.Tensor]] = None):
    """Returns (rd_loss, metrics, reconstruction on the 255 scale).

    `frozen_offset` is prior_quantization_offset() computed once by a caller
    that holds the prior fixed, as in the mshyper model; the unoise branch in
    training does not read the offset. `scalars` are the mshyper model's.
    """
    uq_cfg = base.resolve_uq_config(self.latent_config, step)
    sample_cfg = base.sampling_config(uq_cfg, scalars)
    method = uq_cfg.get("method", "unoise")
    (y_rv,) = latent_rvs.uq
    (n_y,) = noise if noise is not None else (None,)
    if not self.offset_heuristic or (training and method == "unoise"):
      offset = None
    elif frozen_offset is not None:
      offset = frozen_offset
    else:
      offset = self.prior_quantization_offset()
    if method in ("unoise", "mixedq"):
      y_hat, y_bits = entropy.batched_em_call(
          self._prior, y_rv.loc, offset, training=training, noise=n_y, generator=generator)
      if method == "mixedq":  # the bits of the noisy sample, the rounded latent onward
        y_hat = entropy.batched_em_quantize(y_rv.loc, offset)
    else:  # explicit sampling (sga, soft_round) for iterative inference
      y_hat = y_rv.sample(training, offset=offset, noise=n_y, generator=generator, **sample_cfg)
      y_bits = entropy.bits_from_log_prob(self._prior.log_prob_noisy(y_hat))
    reconstruction = metrics_ops.unpad_images(self.synthesize(y_hat), image_batch.shape)

    num_pixels = float(image_batch.shape[1] * image_batch.shape[2])
    bpp_terms = {"latent": torch.mean(y_bits) / num_pixels}
    mse, psnr, extra, rec255 = base.distortion_metrics(image_batch, reconstruction, training)
    rd_loss, metrics = base.assemble_rd_loss(
        bpp_terms, mse, psnr, self.rd_lambda, step, self.scheduled_num_steps, itinf, uq_cfg,
        extra, scalars)
    return rd_loss, metrics, rec255

  def end_to_end_frame_loss(self, image_batch: torch.Tensor, training: bool = False,
                            step: int = 0, noise: Optional[Tuple[torch.Tensor]] = None,
                            generator: Optional[torch.Generator] = None,
                            scalars: Optional[Mapping[str, torch.Tensor]] = None):
    latent_rvs = self.infer_latent_rvs(image_batch)
    return self.frame_loss_given_latent_rvs(image_batch, latent_rvs, training, step,
                                            noise, generator, scalars=scalars)
