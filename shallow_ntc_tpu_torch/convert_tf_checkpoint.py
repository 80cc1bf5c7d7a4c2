"""Convert a reference (TF) shallow-ntc workdir into a port workdir (mirrors
scripts/convert_tf_checkpoint.py), with no TensorFlow.

  python -m shallow_ntc_tpu_torch.convert_tf_checkpoint --workdir_tf D --out O \\
      [--model_family mshyper|factorized] [--dump] [--device cuda|cpu]

D holds the reference's config.json and its TF checkpoints, in
D/train/checkpoints or in D itself (the `checkpoint` file names the newest);
utils/tf_checkpoint.py reads them. The mapping is structural: from the
config, utils/tf_convert.py enumerates the exact tf.train.Checkpoint object
paths the reference's keras-2.10 model has, each with the port's parameter
name and whether it is a deconv kernel (flipped and transposed). Every
variable is shape-checked, and a TF variable without a rule, a mapping
error or a parameter the checkpoint does not cover fails the whole
conversion. O gets D's config.json and a step-0 checkpoint
(train/checkpoints/ckpt_0.pt, a fresh optimizer state), so eval --workdir O,
compress --workdir O and the itinf warm start load it. Builds the model on
CUDA unless --device names another device. --dump lists the checkpoint's
variables (to extend the rules for a layout not seen yet).
"""

import argparse
import os
from typing import Dict, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

from shallow_ntc_tpu_torch import eval_lib, train_lib
from shallow_ntc_tpu_torch.models import families
from shallow_ntc_tpu_torch.utils import runname as runname_utils
from shallow_ntc_tpu_torch.utils import tf_checkpoint, tf_convert

_SUFFIX = "/.ATTRIBUTES/VARIABLE_VALUE"


def latest_checkpoint(workdir_tf: str) -> str:
  """The newest TF checkpoint prefix under <workdir_tf>/train/checkpoints,
  else under <workdir_tf>."""
  ckpt_dir = os.path.join(workdir_tf, "train", "checkpoints")
  latest = (tf_checkpoint.latest_checkpoint(ckpt_dir)
            or tf_checkpoint.latest_checkpoint(workdir_tf))
  if latest is None:
    raise FileNotFoundError(f"No TF checkpoint under {ckpt_dir} or {workdir_tf}")
  return latest


def read_tf_variables(ckpt_path: str) -> Dict[str, np.ndarray]:
  """The checkpoint's model variables: path relative to `model/` -> ndarray.
  Optimizer slots, save_counter and the reference's `model/optimizer/...`
  (Adam kept as a model attribute, models.py:85) are left out."""
  names = {}
  for name in tf_checkpoint.list_variables(ckpt_path):
    if ".OPTIMIZER_SLOT" in name or not name.endswith(_SUFFIX):
      continue
    rel = name[:-len(_SUFFIX)]
    if not rel.startswith("model/"):
      continue  # save_counter etc.
    rel = rel[len("model/"):]
    if rel.startswith("optimizer/"):
      continue
    names[name] = rel
  return {names[k]: v for k, v in tf_checkpoint.read_variables(ckpt_path, names).items()}


def build_translation(config: Mapping, model_family: str) -> Dict[str, Tuple[str, bool]]:
  """config.json -> {tf relative path: (parameter name, needs the deconv conversion)}."""
  tc = dict(config["model_config"]["transform_config"])
  entries = []
  entries += tf_convert.enumerate_transform_paths(dict(tc["analysis"]), "_analysis",
                                                  "_analysis")
  entries += tf_convert.enumerate_transform_paths(dict(tc["synthesis"]), "_synthesis",
                                                  "_synthesis")
  if model_family == "mshyper":
    ha = dict(tc.get("hyper_analysis", dict(cls="HyperAnalysis")))
    hs = dict(tc.get("hyper_synthesis", dict(cls="HyperSynthesis")))
    entries += tf_convert.enumerate_transform_paths(ha, "_hyper_analysis", "_hyper_analysis")
    entries += tf_convert.enumerate_transform_paths(hs, "_hyper_synthesis", "_hyper_synthesis")
  entries += tf_convert.enumerate_prior_paths()
  return {tf_path: (name, deconv) for tf_path, name, deconv in entries}


def assign_variables(model: torch.nn.Module, tf_vars: Mapping[str, np.ndarray],
                     table: Mapping[str, Tuple[str, bool]]) -> int:
  """Copy each TF variable into the parameter its rule names (deconv kernels
  flipped and transposed); return how many were assigned. Raises one
  RuntimeError listing every unmatched TF variable, mapping error and
  parameter the variables do not cover, before changing any parameter."""
  own = dict(model.named_parameters())
  new, unmatched, errors = {}, [], []
  for rel, arr in sorted(tf_vars.items()):
    if rel not in table:
      unmatched.append(rel)
      continue
    name, deconv = table[rel]
    arr = np.asarray(arr)
    if deconv:
      arr = tf_convert.conv_transpose_kernel_tf_to_flax(arr)
    if name not in own:
      errors.append(f"{rel} -> {name}: no such parameter")
      continue
    if arr.shape != tuple(own[name].shape):
      errors.append(f"{rel} -> {name}: shape {arr.shape} vs {tuple(own[name].shape)}")
      continue
    new[name] = torch.from_numpy(np.ascontiguousarray(arr)).to(own[name].dtype)
  missing = sorted(set(own) - set(new))
  problems = []
  if unmatched:
    problems.append("TF variables with no layout rule (extend "
                    "tf_convert.enumerate_transform_paths):\n  " + "\n  ".join(unmatched))
  if errors:
    problems.append("mapping errors:\n  " + "\n  ".join(errors))
  if missing:
    problems.append("parameters not covered by the checkpoint:\n  " + "\n  ".join(missing))
  if problems:
    raise RuntimeError("checkpoint conversion failed:\n" + "\n".join(problems))
  with torch.no_grad():
    for name, value in new.items():
      own[name].copy_(value)
  return len(new)


def convert_variables(config: Mapping, tf_vars: Mapping[str, np.ndarray], out_workdir: str,
                      model_family: str = "mshyper",
                      device: Optional[str] = "cuda") -> Tuple[torch.nn.Module, str]:
  """Build the `model_family` model of config["model_config"] on `device`,
  assign `tf_vars` (read_tf_variables' map) to it, and write `config` and a
  step-0 checkpoint with a fresh optimizer state to out_workdir. Returns the
  model and the checkpoint's path."""
  device = eval_lib.resolve_device(device)
  model, optimizer_config = families.build_model(config["model_config"], model_family)
  model = model.to(device)
  n = assign_variables(model, tf_vars, build_translation(config, model_family))
  state, _ = train_lib.create_train_state(model, optimizer_config)
  os.makedirs(out_workdir, exist_ok=True)
  runname_utils.dump_json(config, os.path.join(out_workdir, "config.json"))
  path = train_lib.save_checkpoint(out_workdir, state)
  print(f"Wrote converted checkpoint ({n} params) to {out_workdir}")
  return model, path


def convert(workdir_tf: str, out_workdir: str, model_family: str = "mshyper",
            device: Optional[str] = "cuda") -> Tuple[torch.nn.Module, str]:
  """Convert the newest TF checkpoint of a reference workdir (config.json +
  checkpoints) into a port workdir; see convert_variables."""
  config = runname_utils.load_json(os.path.join(workdir_tf, "config.json"))
  tf_vars = read_tf_variables(latest_checkpoint(workdir_tf))
  return convert_variables(config, tf_vars, out_workdir, model_family, device)


def main(argv: Optional[Sequence[str]] = None) -> None:
  parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
  parser.add_argument("--workdir_tf", required=True,
                      help="reference workdir (config.json + TF checkpoints)")
  parser.add_argument("--out", help="output workdir")
  parser.add_argument("--model_family", default="mshyper", choices=sorted(families.FAMILIES))
  parser.add_argument("--dump", action="store_true",
                      help="only list the TF checkpoint's variables")
  parser.add_argument("--device", default="cuda")
  args = parser.parse_args(argv)
  if args.dump:
    for name, (dtype, shape) in sorted(
        tf_checkpoint.list_variables(latest_checkpoint(args.workdir_tf)).items()):
      print(name, list(shape), dtype)
    return
  if args.out is None:
    parser.error("--out is required unless --dump")
  convert(args.workdir_tf, args.out, args.model_family, args.device)


if __name__ == "__main__":
  main()
