"""Per-image R-D evaluation of either model family (mirrors
shallow_ntc_tpu/eval_lib.py:150-256).

No spatial sharding yet. The JSON written by eval_to_json has the JAX
eval's record keys: the model's metrics, "lpips" when an lpips_fn is given
(models/lpips.make_lpips_fn), instance_id and the run-name hparams.
"""

import json
import os
import re
from typing import Dict, Iterable, Iterator, List, Mapping, Optional

import numpy as np
import torch
from torch import nn

from shallow_ntc_tpu_torch import configs
from shallow_ntc_tpu_torch import params as params_lib
from shallow_ntc_tpu_torch.models import base as models_base
from shallow_ntc_tpu_torch.models import families


def resolve_device(device: Optional[str] = "cuda") -> torch.device:
  """The device an entry point runs on: CUDA unless the caller names another."""
  device = torch.device(device if device is not None else "cuda")
  if device.type == "cuda" and not torch.cuda.is_available():
    raise RuntimeError("CUDA is not available; pass device='cpu' to run on the CPU")
  return device


def build_model(model_config: Optional[Mapping] = None,
                params: Optional[Mapping] = None, init_seed: Optional[int] = None,
                device: Optional[str] = "cuda", family: str = "mshyper") -> nn.Module:
  """Build the Model of `family` (mshyper or factorized; families.build_model),
  load `params` (flax tree or flat map) or a seeded init, and move it to
  `device` in eval mode."""
  device = resolve_device(device)
  if (params is None) == (init_seed is None):
    raise ValueError("pass exactly one of params and init_seed")
  model, _ = families.build_model(model_config or configs.TWO_LAYER_SYN_RD, family)
  if params is None:
    params = params_lib.init_params(model, init_seed)
  params_lib.load_params(model, params)
  return model.to(device).eval()


def read_params(path: str):
  """(flat {flax path: array} params, step) of an .npz; step 0 without a "step" entry."""
  with np.load(path) as npz:
    params = {k: npz[k] for k in npz.files}
  return params, int(params.pop("step", 0))


def evaluate_images(model: nn.Module, images: Iterable, step: int = 0,
                    lpips_fn=None) -> Iterator[Dict[str, float]]:
  """Yield one metrics dict per image.

  `images` yields [1, H, W, 3] normalized arrays (or is a [B, ...] array,
  split into singles). Images go to the model's device. With an lpips_fn
  ((x255, y255) -> LPIPS) each record gets "lpips" of the image's pixels
  against the reconstruction, as the JAX eval's (eval_lib.py:200-202).
  """
  device = next(model.parameters()).device
  if hasattr(images, "shape"):
    images = [images[i : i + 1] for i in range(images.shape[0])]
  # The prior's offset depends on its frozen parameters alone: one bisection
  # per pass, not one per image.
  offset = model.prior_quantization_offset()
  for img in images:
    img = torch.as_tensor(np.asarray(img, np.float32), device=device)
    if img.ndim == 3:
      img = img[None]
    with torch.no_grad():
      _, metrics, rec = model.frame_loss_given_latent_rvs(
          img, model.infer_latent_rvs(img), training=False, step=step, frozen_offset=offset)
    out = {k: float(v) for k, v in metrics.items()}
    if lpips_fn is not None:
      out["lpips"] = float(lpips_fn(models_base.floats_to_pixels(img, training=False),
                                    rec.float()))
    yield out


def parse_runname(s: str) -> Dict[str, str]:
  """key=value pairs of a run name (shallow_ntc_tpu/utils/runname.py:parse_runname)."""
  pattern = r"(\w+)=((\d+_)+\d+|(-?\d*\.?\d+(?:e[+-]?\d+)?)+|\w+)"
  return {m.group(1): m.group(2) for m in re.finditer(pattern, s)}


def eval_to_json(model: nn.Module, images: Iterable, results_dir: str, runname: str,
                 xid: str, step: int = 0, lpips_fn=None) -> str:
  """Evaluate and dump a flat JSON list of per-image records; return its path."""
  hparams = parse_runname(runname)
  records: List[Dict] = []
  for instance_id, metrics in enumerate(evaluate_images(model, images, step, lpips_fn)):
    record = dict(metrics)
    record["instance_id"] = instance_id
    record.update(hparams)
    records.append(record)
  os.makedirs(results_dir, exist_ok=True)
  path = os.path.join(results_dir, f"{runname}-step={step}-xid={xid}.json")
  with open(path, "w") as f:
    json.dump(records, f, indent=2)
  return path
