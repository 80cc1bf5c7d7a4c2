"""Loss assembly and metrics shared by the model families (mirrors models/base.py)."""

import logging
import math
from typing import Dict, Mapping, Optional

import numpy as np
import torch

from shallow_ntc_tpu_torch import schedule
from shallow_ntc_tpu_torch.ops import metrics_ops
from shallow_ntc_tpu_torch.ops import rounding


UQ_METHODS = ("unoise", "mixedq", "sga", "soft_round")


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


def resolve_uq_config(latent_config: Mapping, step: int = 0) -> Dict:
  """Copy of latent_config['uq'] with the SGA temperature of `step` injected
  (models/base.py:49-66; its `itinf` argument is unused there): for method
  'sga', tau = sga_schedule_at_step(step, tau_r, tau_ub, tau_lb, tau_t0,
  tau_scheme). The methods are 'unoise', 'mixedq', 'sga' and 'soft_round'.
  """
  cfg = dict(latent_config.get("uq", {"method": "unoise"}))
  method = cfg.get("method", "unoise")
  if method not in UQ_METHODS:
    raise NotImplementedError(f"uq method {method!r} is not one of {UQ_METHODS}")
  if method == "sga":
    cfg["tau"] = rounding.sga_schedule_at_step(
        step, r=cfg["tau_r"], ub=cfg["tau_ub"], lb=cfg.get("tau_lb", 1e-8),
        t0=cfg["tau_t0"], scheme=cfg.pop("tau_scheme", "exp"))
  return cfg


def effective_offset_heuristic(model_config: Mapping) -> bool:
  """mixedq training turns the offset heuristic off (models/base.py:123-138),
  with the JAX package's warning."""
  offset_heuristic = model_config.get("offset_heuristic", True)
  method = (model_config.get("latent_config") or {}).get("uq", {}).get("method", "unoise")
  if method == "mixedq" and offset_heuristic:
    logging.warning("modifying offset_heuristic from True to False, as it doesn't make "
                    "sense for mixedq training.")
    return False
  return offset_heuristic


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
                     scheduled_num_steps: int, itinf: bool = False,
                     uq_cfg: Optional[Mapping] = None,
                     extra_metrics: Optional[Dict[str, torch.Tensor]] = None):
  """rd_loss = bpp + scheduled_lambda * mse, plus the reference's scalar set
  (and the SGA temperature `tau` for method 'sga').

  The schedule's scalars are host values: lambda enters rd_loss as a Python
  float (a float32 value, so the product is JAX's), and the metrics
  sched_rd_lambda and tau are float32 CPU tensors, so that no step copies a
  scalar to the device and waits for it.
  """
  bpp = sum(bpp_terms.values())
  sched_lambda = np.float32(schedule.scheduled_rd_lambda(
      rd_lambda_value, step, scheduled_num_steps, itinf=itinf))
  rd_loss = bpp + float(sched_lambda) * mse
  metrics = {
      "rd_loss": rd_loss,
      "bpp": bpp,
      "mse": mse,
      "psnr": psnr,
      "sched_rd_lambda": torch.tensor(sched_lambda),
  }
  if len(bpp_terms) > 1:
    metrics.update({f"{k}_bpp": v for k, v in bpp_terms.items()})
  if uq_cfg is not None and uq_cfg.get("method") == "sga":
    metrics["tau"] = torch.tensor(np.float32(uq_cfg["tau"]))
  if extra_metrics:
    metrics.update(extra_metrics)
  return rd_loss, metrics
