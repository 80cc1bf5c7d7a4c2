"""Per-image R-D evaluation (mirrors shallow_ntc_tpu/eval_lib.py:150-256).

No LPIPS and no spatial sharding yet. The JSON written by eval_to_json has
the JAX eval's record keys: the model's metrics, instance_id and the
run-name hparams.
"""

import json
import os
import re
from typing import Dict, Iterable, Iterator, List, Mapping, Optional

import numpy as np
import torch

from shallow_ntc_tpu_torch import configs
from shallow_ntc_tpu_torch import params as params_lib
from shallow_ntc_tpu_torch.models.mshyper import Model


def resolve_device(device: Optional[str] = "cuda") -> torch.device:
  """The device an entry point runs on: CUDA unless the caller names another."""
  device = torch.device(device if device is not None else "cuda")
  if device.type == "cuda" and not torch.cuda.is_available():
    raise RuntimeError("CUDA is not available; pass device='cpu' to run on the CPU")
  return device


def build_model(model_config: Optional[Mapping] = None,
                params: Optional[Mapping] = None, init_seed: Optional[int] = None,
                device: Optional[str] = "cuda") -> Model:
  """Build the mshyper Model, load `params` (flax tree or flat map) or a seeded
  init, and move it to `device` in eval mode."""
  device = resolve_device(device)
  if (params is None) == (init_seed is None):
    raise ValueError("pass exactly one of params and init_seed")
  model_config = dict(model_config or configs.TWO_LAYER_SYN_RD)
  model_config.pop("optimizer_config", None)
  model = Model(**model_config)
  if params is None:
    params = params_lib.init_params(model, init_seed)
  params_lib.load_params(model, params)
  return model.to(device).eval()


def evaluate_images(model: Model, images: Iterable, step: int = 0) -> Iterator[Dict[str, float]]:
  """Yield one metrics dict per image.

  `images` yields [1, H, W, 3] normalized arrays (or is a [B, ...] array,
  split into singles). Images go to the model's device.
  """
  device = next(model.parameters()).device
  if hasattr(images, "shape"):
    images = [images[i : i + 1] for i in range(images.shape[0])]
  for img in images:
    img = torch.as_tensor(np.asarray(img, np.float32), device=device)
    if img.ndim == 3:
      img = img[None]
    with torch.no_grad():
      _, metrics, _ = model.end_to_end_frame_loss(img, training=False, step=step)
    yield {k: float(v) for k, v in metrics.items()}


def parse_runname(s: str) -> Dict[str, str]:
  """key=value pairs of a run name (shallow_ntc_tpu/utils/runname.py:parse_runname)."""
  pattern = r"(\w+)=((\d+_)+\d+|(-?\d*\.?\d+(?:e[+-]?\d+)?)+|\w+)"
  return {m.group(1): m.group(2) for m in re.finditer(pattern, s)}


def eval_to_json(model: Model, images: Iterable, results_dir: str, runname: str,
                 xid: str, step: int = 0) -> str:
  """Evaluate and dump a flat JSON list of per-image records; return its path."""
  hparams = parse_runname(runname)
  records: List[Dict] = []
  for instance_id, metrics in enumerate(evaluate_images(model, images, step)):
    record = dict(metrics)
    record["instance_id"] = instance_id
    record.update(hparams)
    records.append(record)
  os.makedirs(results_dir, exist_ok=True)
  path = os.path.join(results_dir, f"{runname}-step={step}-xid={xid}.json")
  with open(path, "w") as f:
    json.dump(records, f, indent=2)
  return path
