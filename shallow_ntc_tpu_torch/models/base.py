"""Loss assembly and metrics shared by the model families (mirrors models/base.py)."""

import math
from typing import Dict, Mapping, Optional

import torch

from shallow_ntc_tpu_torch import schedule
from shallow_ntc_tpu_torch.ops import metrics_ops


def normalize_image(image):
  return image / 255.0 - 0.5


def unnormalize_image(x):
  return (x + 0.5) * 255.0


def floats_to_pixels(x: torch.Tensor, training: bool) -> torch.Tensor:
  """Map normalized floats back to [0, 255]; quantize to the uint8 grid in eval."""
  x = unnormalize_image(x)
  if not training:
    x = metrics_ops.quantize_image(x).float()
  return x


def resolve_uq_config(latent_config: Mapping) -> Dict:
  """Copy of latent_config['uq']; only the 'unoise' method is ported."""
  cfg = dict(latent_config.get("uq", {"method": "unoise"}))
  if cfg.get("method", "unoise") != "unoise":
    raise NotImplementedError(f"uq method {cfg['method']!r} is not ported yet")
  return cfg


def distortion_metrics(image_batch: torch.Tensor, reconstruction: torch.Tensor,
                       training: bool):
  """255-scale MSE/PSNR (+ MS-SSIM in eval). Returns (mse, psnr, extra, rec255)."""
  img255 = floats_to_pixels(image_batch, training)
  rec255 = floats_to_pixels(reconstruction, training)
  batch_mse, batch_psnr = metrics_ops.mse_psnr(img255, rec255)
  extra: Dict[str, torch.Tensor] = {}
  if not training:
    batch_msssim = metrics_ops.msssim_or_ssim(img255, rec255)
    extra["msssim"] = torch.mean(batch_msssim)
    extra["msssim_db"] = torch.mean(-10.0 * torch.log(1.0 - batch_msssim) / math.log(10.0))
  return torch.mean(batch_mse), torch.mean(batch_psnr), extra, rec255


def assemble_rd_loss(bpp_terms: Dict[str, torch.Tensor], mse: torch.Tensor,
                     psnr: torch.Tensor, rd_lambda_value: float, step: int,
                     scheduled_num_steps: int,
                     extra_metrics: Optional[Dict[str, torch.Tensor]] = None):
  """rd_loss = bpp + scheduled_lambda * mse, plus the reference's scalar set."""
  bpp = sum(bpp_terms.values())
  sched_lambda = torch.tensor(
      schedule.scheduled_rd_lambda(rd_lambda_value, step, scheduled_num_steps),
      dtype=torch.float32, device=mse.device)
  rd_loss = bpp + sched_lambda * mse
  metrics = {
      "rd_loss": rd_loss,
      "bpp": bpp,
      "mse": mse,
      "psnr": psnr,
      "sched_rd_lambda": sched_lambda,
  }
  if len(bpp_terms) > 1:
    metrics.update({f"{k}_bpp": v for k, v in bpp_terms.items()})
  if extra_metrics:
    metrics.update(extra_metrics)
  return rd_loss, metrics
