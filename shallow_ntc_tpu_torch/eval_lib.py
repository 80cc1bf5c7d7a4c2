"""Per-image R-D evaluation of either model family, and of a trained
workdir (mirrors shallow_ntc_tpu/eval_lib.py).

The JSON written by eval_to_json and eval_workdir has the JAX eval's
record keys: the model's metrics, "lpips" when an lpips_fn is given
(models/lpips.make_lpips_fn), the transforms' times with profile=True,
instance_id and the run-name hparams. A `devices` list splits each
image's height over those devices (parallel/mesh.ModelHeightSplit), as
the JAX eval's spatial sharding does. Each image's forward and its LPIPS
take cuDNN's deterministic algorithms, so that two runs of an eval agree
bit for bit. A workdir's model is rebuilt from
its config.json and the newest checkpoint under train/checkpoints; the
model sources copied beside them are provenance only, as in the JAX
package.
"""

import contextlib
import copy
import glob
import importlib.util
import json
import logging
import os
from typing import Any, Dict, Iterable, Iterator, List, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from shallow_ntc_tpu_torch import configs
from shallow_ntc_tpu_torch import params as params_lib
from shallow_ntc_tpu_torch.models import base as models_base
from shallow_ntc_tpu_torch.models import families
from shallow_ntc_tpu_torch.parallel import mesh as mesh_lib
from shallow_ntc_tpu_torch.utils import runname as runname_utils
from shallow_ntc_tpu_torch.utils.runname import parse_runname


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


def evaluate_images(model: nn.Module, images: Iterable, step: int = 0, lpips_fn=None,
                    devices: Optional[Sequence] = None) -> Iterator[Dict[str, float]]:
  """Yield one metrics dict per image.

  `images` yields [1, H, W, 3] normalized arrays (or is a [B, ...] array,
  split into singles). Images go to the model's device. With an lpips_fn
  ((x255, y255) -> LPIPS) each record gets "lpips" of the image's pixels
  against the reconstruction, as the JAX eval's (eval_lib.py:200-202).

  `devices` (None: unsplit) runs the analysis and the synthesis on
  len(devices) height strips, strip i on devices[i] (a list may name one
  device twice; the CLIs' --spatial_devices N is
  mesh.spatial_device_list(N)). The rest of the model runs whole on the
  model's device (eval_lib.py:150-200). Each image runs under cuDNN's
  deterministic algorithms, chosen by its heuristic (no benchmarking), with
  the caller's TF32 setting: cuDNN's default algorithm for a transposed conv
  may sum in another order from run to run.
  """
  device = next(model.parameters()).device
  if hasattr(images, "shape"):
    images = [images[i : i + 1] for i in range(images.shape[0])]
  split = contextlib.nullcontext()
  if devices is not None:
    split = mesh_lib.ModelHeightSplit(model, devices)
  # The prior's offset depends on its frozen parameters alone: one bisection
  # per pass, not one per image.
  offset = model.prior_quantization_offset()
  for img in images:
    img = torch.as_tensor(np.asarray(img, np.float32), device=device)
    if img.ndim == 3:
      img = img[None]
    with torch.no_grad(), split, torch.backends.cudnn.flags(
        enabled=True, benchmark=False, deterministic=True,
        allow_tf32=torch.backends.cudnn.allow_tf32):
      _, metrics, rec = model.frame_loss_given_latent_rvs(
          img, model.infer_latent_rvs(img), training=False, step=step, frozen_offset=offset)
      out = {k: float(v) for k, v in metrics.items()}
      if lpips_fn is not None:
        out["lpips"] = float(lpips_fn(models_base.floats_to_pixels(img, training=False),
                                      rec.float()))
    yield out


def eval_to_json(model: nn.Module, images: Iterable, results_dir: str, runname: str,
                 xid: str, step: int = 0, lpips_fn=None,
                 devices: Optional[Sequence] = None) -> str:
  """Evaluate and dump a flat JSON list of per-image records; return its path."""
  hparams = parse_runname(runname)
  records: List[Dict] = []
  for instance_id, metrics in enumerate(evaluate_images(model, images, step, lpips_fn,
                                                        devices)):
    record = dict(metrics)
    record["instance_id"] = instance_id
    record.update(hparams)
    records.append(record)
  os.makedirs(results_dir, exist_ok=True)
  path = os.path.join(results_dir, f"{runname}-step={step}-xid={xid}.json")
  with open(path, "w") as f:
    json.dump(records, f, indent=2)
  return path


# ---------------------------------------------------------------------------
# Trained workdirs (eval_lib.py:23-147, :206-258)
# ---------------------------------------------------------------------------
def _deep_update(base: Dict, upd: Mapping) -> Dict:
  for k, v in upd.items():
    if isinstance(v, Mapping) and isinstance(base.get(k), dict):
      base[k] = _deep_update(base[k], v)
    else:
      base[k] = v
  return base


def infer_model_family(workdir: str, config: Mapping) -> str:
  """The family from config.json's model_family key, else the run name."""
  if "model_family" in config:
    return config["model_family"]
  name = os.path.basename(os.path.normpath(workdir))
  for fam in ("mshyper", "factorized"):
    if fam in name:
      return fam
  return "mshyper"


def load_model_class(models_path: str):
  """The `Model` class of a Python file (the eval CLI's --models_path): a
  torch module with the family's method surface (end_to_end_frame_loss,
  infer_latent_rvs, frame_loss_given_latent_rvs, ...)."""
  spec = importlib.util.spec_from_file_location("_user_models", models_path)
  if spec is None:
    raise FileNotFoundError(f"not a Python file: {models_path!r}")
  mod = importlib.util.module_from_spec(spec)
  spec.loader.exec_module(mod)
  return mod.Model


def load_latest_ckpt(workdir: str, model_family: Optional[str] = None,
                     update_model_config: Optional[Mapping] = None,
                     model_cls: Optional[type] = None, transforms_dtype=None,
                     device: Optional[str] = "cuda") -> Tuple[nn.Module, Dict[str, Any]]:
  """(the model of <workdir>/config.json with the params of the newest
  checkpoint there, on `device` in eval mode; the config).

  update_model_config is laid over the saved model_config (itinf's SGA
  settings); transforms_dtype (a torch dtype) sets the transforms'
  computation type; model_cls replaces the family's class (--models_path).
  The config returned holds the model_config used and "_restored_step".
  """
  from shallow_ntc_tpu_torch import train_lib

  device = resolve_device(device)
  config = runname_utils.load_json(os.path.join(workdir, "config.json"))
  model_config = copy.deepcopy(config["model_config"])
  if update_model_config:
    model_config = _deep_update(model_config, copy.deepcopy(dict(update_model_config)))
  if transforms_dtype is not None:
    model_config["transforms_dtype"] = transforms_dtype
  model, _ = families.build_model(model_config, model_family
                                  or infer_model_family(workdir, config), model_cls)
  payload = train_lib.load_newest_checkpoint(train_lib.checkpoint_dir(workdir))
  model.load_state_dict(payload["model"])
  config["model_config"] = model_config
  config["_restored_step"] = int(payload["step"])
  return model.to(device).eval(), config


def find_workdir_by_wid(experiment_dir: str, wid) -> str:
  """The work unit wid=<wid>-* of an experiment directory; the directory
  itself when it is a workdir and holds no work units; the only workdir
  under it when none is named wid=<wid>-* (itinf_lib.py:167-174)."""
  matches = sorted(glob.glob(os.path.join(experiment_dir, f"wid={wid}-*")))
  if (not matches and not glob.glob(os.path.join(experiment_dir, "wid=*"))
      and os.path.isdir(os.path.join(experiment_dir, "train", "checkpoints"))):
    return experiment_dir
  if not matches:
    candidates = [d for d in sorted(glob.glob(os.path.join(experiment_dir, "*")))
                  if os.path.isdir(os.path.join(d, "train", "checkpoints"))]
    if len(candidates) == 1:
      logging.warning("No wid=%s-* under %s; using the only workdir %s", wid, experiment_dir,
                      candidates[0])
      return candidates[0]
    raise FileNotFoundError(f"No work unit wid={wid} under {experiment_dir}")
  return matches[0]


def load_latest_ckpt_from_experiment(experiment_dir: str, wid, model_family: Optional[str] = None,
                                     update_model_config: Optional[Mapping] = None,
                                     transforms_dtype=None, device: Optional[str] = "cuda"):
  """load_latest_ckpt of the work unit `wid` of an experiment directory."""
  return load_latest_ckpt(find_workdir_by_wid(experiment_dir, wid), model_family,
                          update_model_config, transforms_dtype=transforms_dtype, device=device)


def eval_workdir(workdir: str, eval_data: Iterable, dataset_name: str, results_dir: str,
                 skip_existing: bool = False, model_family: Optional[str] = None,
                 lpips_fn=None, profile: bool = False, model_cls: Optional[type] = None,
                 device: Optional[str] = "cuda",
                 devices: Optional[Sequence] = None) -> Optional[str]:
  """Evaluate a trained workdir on `eval_data` and dump a flat JSON list of
  per-image records to <results_dir>/<run name>-step=<n>-xid=<xid>.json
  (the run name without its wid= prefix, xid the experiment directory's
  name); return its path. With skip_existing an existing file is kept; with
  profile each record also gets the transforms' times of its image shape
  (utils/profiling.transform_timings), which stay unsplit.
  `devices` is evaluate_images'."""
  model, config = load_latest_ckpt(workdir, model_family, model_cls=model_cls, device=device)
  step = config["_restored_step"]
  wu_name = os.path.basename(os.path.normpath(workdir))
  xid = os.path.basename(os.path.dirname(os.path.normpath(workdir)))
  runname = wu_name.split("-", 1)[1] if wu_name.startswith("wid=") else wu_name
  results_path = os.path.join(results_dir, f"{runname}-step={step}-xid={xid}.json")
  if skip_existing and os.path.exists(results_path):
    logging.info("Skipping existing results %s", results_path)
    return results_path

  hparams = dict(parse_runname(wu_name))
  if hasattr(eval_data, "shape"):
    eval_data = [eval_data[i:i + 1] for i in range(eval_data.shape[0])]
  shapes: List[Tuple[int, ...]] = []

  def images():  # notes each image's shape as evaluate_images takes it
    for img in eval_data:
      img = np.asarray(img, np.float32)
      img = img[None] if img.ndim == 3 else img
      shapes.append(img.shape)
      yield img

  timing_cache: Dict[tuple, Dict[str, float]] = {}
  records: List[Dict] = []
  for instance_id, metrics in enumerate(evaluate_images(model, images(), step, lpips_fn,
                                                        devices)):
    record = dict(metrics)
    if profile:
      shape = shapes[instance_id]
      if shape not in timing_cache:
        from shallow_ntc_tpu_torch.utils import profiling

        dummy = torch.zeros(shape, device=next(model.parameters()).device)
        timing_cache[shape] = profiling.transform_timings(model, dummy)
      record.update(timing_cache[shape])
    record["instance_id"] = instance_id
    record.update(hparams)
    records.append(record)
    logging.info("img %d: %s", instance_id, record)
  runname_utils.dump_json(records, results_path)
  logging.info("Wrote %s", results_path)
  return results_path
