"""Mean-scale hyperprior model (Minnen 2018).

Mirrors shallow_ntc_tpu/models/mshyper.py:
  x -> pad -> analysis -> y -> hyper-analysis -> z
  z -> [deep-factorized prior] -> z_hat, bits(z)
  z_hat -> hyper-synthesis -> (mu, scale index = exp(.))
  y -> [64-scale indexed noisy Gaussian, loc=mu] -> y_hat, bits(y)
  y_hat -> synthesis -> x_hat -> unpad
  rd_loss = bpp + scheduled_lambda * mse (255 scale)
The reference's three relaxation branches: 'unoise' (training and eval),
'mixedq' (the bits of the noisy sample, the straight-through rounded
latents onward; its eval is unoise's) and the explicit sampling of
iterative inference ('sga', 'soft_round'). In training the latents' noise
(uniform for unoise and mixedq, logistic for sga) is given as
noise=(n_z, n_y), or drawn from a torch.Generator, z's first.

transforms_dtype (None, or torch.bfloat16 for iterative inference) is the
computation type of the analysis, the hyper pair and the synthesis, as the
flax model's `dtype`: each transform's input is cast to it, and the
transforms compute in their input's type. Parameters, the entropy models and
the latents stay float32.
"""

import contextlib
from typing import Any, Mapping, Optional, Tuple

import torch
from torch import nn

from shallow_ntc_tpu_torch.latents import LatentRVCollection, UQLatentRV
from shallow_ntc_tpu_torch.models import base
from shallow_ntc_tpu_torch.models.transforms import build_transform
from shallow_ntc_tpu_torch.ops import entropy
from shallow_ntc_tpu_torch.ops import int8ops
from shallow_ntc_tpu_torch.ops import metrics_ops
from shallow_ntc_tpu_torch.ops import rounding


class Model(nn.Module):
  """Mean-scale hyperprior model built from a model_config dict (flax names kept)."""

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

  def _in_transforms_dtype(self, x: torch.Tensor) -> torch.Tensor:
    return x if self.transforms_dtype is None else x.to(self.transforms_dtype)

  def infer_latent_rvs(self, x: torch.Tensor) -> LatentRVCollection:
    x = metrics_ops.pad_images(x, self.downsample_factor)
    y = self._analysis(self._in_transforms_dtype(x))
    z = self._hyper_analysis(y)
    return LatentRVCollection(uq=(UQLatentRV(loc=z), UQLatentRV(loc=y)))

  def training_noise(self, image_shape, generator: torch.Generator):
    """(u_z, u_y): the uniform draws that a training step (unoise or mixedq)
    on a batch of `image_shape` [B, H, W, 3] takes from `generator`, in its
    order, at its latents' shapes; what noise= takes. The data-parallel step
    draws them for the global batch and keeps its rows."""
    b, h, w = image_shape[:3]
    d, fa = self.downsample_factor, self._analysis.downsample_factor
    fh = self._hyper_analysis.downsample_factor
    yh, yw = -(-h // d) * d // fa, -(-w // d) * d // fa
    shapes = ((b, yh // fh, yw // fh, self._hyper_analysis.output_depth),
              (b, yh, yw, self._analysis.output_depth))
    return tuple(rounding.uniform_noise(s, generator, device=generator.device) for s in shapes)

  def hyper_synthesize(self, z_hat: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """z_hat -> (mu, scale_indexes); the index is made positive by exp.

    z_hat is taken contiguous (NHWC): cuDNN and oneDNN pick their convolution
    algorithm by the memory layout too, so a view of the analysis's output
    and the codec's decoded z_hat would round mu differently. One layout is
    one program for every caller (codec/api.py's determinism contract).

    In the int8 decode's 'syn' mode the hyper-decoder stays float
    (int8ops.force(False)), so mu and the scale indexes, and with them the
    rate, are the float path's bit for bit. Every path that computes mu (the
    eval, the codec, SGA) comes through here."""
    z_hat = self._in_transforms_dtype(z_hat).contiguous()
    with int8ops.force(False) if int8ops.hyper_exempt() else contextlib.nullcontext():
      out = self._hyper_synthesis(z_hat)
    mu, raw = torch.chunk(out, 2, dim=-1)
    return mu, torch.exp(raw)

  def synthesize(self, y_hat: torch.Tensor) -> torch.Tensor:
    return self._synthesis(self._in_transforms_dtype(y_hat))

  def prior_quantization_offset(self) -> Optional[torch.Tensor]:
    return self._prior.quantization_offset() if self.offset_heuristic else None

  def frame_loss_given_latent_rvs(self, image_batch: torch.Tensor,
                                  latent_rvs: LatentRVCollection, training: bool = False,
                                  step: int = 0,
                                  noise: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
                                  generator: Optional[torch.Generator] = None,
                                  frozen_offset: Optional[torch.Tensor] = None,
                                  itinf: bool = False,
                                  scalars: Optional[Mapping[str, torch.Tensor]] = None):
    """Returns (rd_loss, metrics, reconstruction on the 255 scale).

    The offset heuristic's grid is a function of the prior's parameters
    alone, so a caller that holds them fixed (an eval pass, the codec,
    iterative inference) computes it once with prior_quantization_offset()
    and passes it as `frozen_offset`. The unoise branch in training skips
    it: its noisy sample does not read it. The SGA sample is taken about it
    in training too. `scalars` (base.step_scalar_values' names, 0-dim
    tensors on the model's device) replace the host values of the scheduled
    lambda and of SGA's tau: the train and SGA steps pass them, so that a
    captured step reads each step's own.
    """
    uq_cfg = base.resolve_uq_config(self.latent_config, step)
    sample_cfg = base.sampling_config(uq_cfg, scalars)
    method = uq_cfg.get("method", "unoise")
    z_rv, y_rv = latent_rvs.uq
    n_z, n_y = noise if noise is not None else (None, None)
    if not self.offset_heuristic or (training and method == "unoise"):
      offset = None
    elif frozen_offset is not None:
      offset = frozen_offset
    else:
      offset = self.prior_quantization_offset()
    if method in ("unoise", "mixedq"):
      z_hat, z_bits = entropy.batched_em_call(
          self._prior, z_rv.loc, offset, training=training, noise=n_z, generator=generator)
      if method == "mixedq":  # the bits of the noisy sample, the rounded latent onward
        z_hat = entropy.batched_em_quantize(z_rv.loc, offset)
      mu, indexes = self.hyper_synthesize(z_hat)
      y_hat, y_bits = entropy.indexed_em_call(
          y_rv.loc, indexes, mu, training=training, noise=n_y, generator=generator)
      if method == "mixedq":
        y_hat = entropy.indexed_em_quantize(y_rv.loc, mu)
    else:  # explicit sampling (sga, soft_round) for iterative inference
      z_hat = z_rv.sample(training, offset=offset, noise=n_z, generator=generator, **sample_cfg)
      z_bits = entropy.bits_from_log_prob(self._prior.log_prob_noisy(z_hat))
      mu, indexes = self.hyper_synthesize(z_hat)
      y_hat = y_rv.sample(training, offset=mu, noise=n_y, generator=generator, **sample_cfg)
      y_bits = entropy.bits_from_log_prob(
          entropy.indexed_em_log_prob_centered(y_hat, indexes, mu))
    reconstruction = metrics_ops.unpad_images(self.synthesize(y_hat), image_batch.shape)

    num_pixels = float(image_batch.shape[1] * image_batch.shape[2])
    bpp_terms = {
        "hyper_latent": torch.mean(z_bits) / num_pixels,
        "latent": torch.mean(y_bits) / num_pixels,
    }
    mse, psnr, extra, rec255 = base.distortion_metrics(image_batch, reconstruction, training)
    rd_loss, metrics = base.assemble_rd_loss(
        bpp_terms, mse, psnr, self.rd_lambda, step, self.scheduled_num_steps, itinf, uq_cfg,
        extra, scalars)
    return rd_loss, metrics, rec255

  def end_to_end_frame_loss(self, image_batch: torch.Tensor, training: bool = False,
                            step: int = 0,
                            noise: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
                            generator: Optional[torch.Generator] = None,
                            scalars: Optional[Mapping[str, torch.Tensor]] = None):
    latent_rvs = self.infer_latent_rvs(image_batch)
    return self.frame_loss_given_latent_rvs(image_batch, latent_rvs, training, step,
                                            noise, generator, scalars=scalars)
