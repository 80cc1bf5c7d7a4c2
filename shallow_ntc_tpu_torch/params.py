"""Parameter bridge: flax parameter trees <-> the port's modules.

The port's modules keep every parameter in the flax layout under the flax
name, so the flax path with '/' replaced by '.' is the state-dict key
(`_analysis/Conv_0/kernel` -> `_analysis.Conv_0.kernel`) and a tree loads
without any reshaping. The layout changes happen inside the forward passes:
flax conv kernels are HWIO, and flax deconv kernels [k, k, in, out] are
correlated unflipped over the dilated input, so torch's conv_transpose2d
gets them flipped and with in/out swapped (ops/fast_deconv.py).

init_params makes a seeded set of parameters with numpy, drawn as flax's
initializers draw them, for running the model at full width with no
weights file.
"""

import math
from typing import Dict, Mapping

import numpy as np
import torch
from torch import nn

_GDN_PEDESTAL = 2.0**-18
_PRIOR_INIT_SCALE = 10.0
_PRELU_INIT_SLOPE = 0.25


def flatten_tree(tree: Mapping, prefix: str = "") -> Dict[str, np.ndarray]:
  """Nested flax parameter dict -> {"a/b/kernel": array}."""
  flat = {}
  for key, value in tree.items():
    path = f"{prefix}/{key}" if prefix else str(key)
    if isinstance(value, Mapping):
      flat.update(flatten_tree(value, path))
    else:
      flat[path] = np.asarray(value)
  return flat


def load_params(model: nn.Module, params) -> nn.Module:
  """Copy a flax tree (nested dict) or a flat {"a/b/kernel": array} map into `model`.

  Raises if a path is missing, left over, or of another shape.
  """
  flat = params if all(not isinstance(v, Mapping) for v in params.values()) else (
      flatten_tree(params))
  own = model.state_dict()
  theirs = {path.replace("/", "."): value for path, value in flat.items()}
  missing = sorted(set(own) - set(theirs))
  unexpected = sorted(set(theirs) - set(own))
  if missing or unexpected:
    raise KeyError(f"parameter paths differ: missing {missing[:8]}, unexpected {unexpected[:8]}")
  with torch.no_grad():
    for key, value in theirs.items():
      value = np.asarray(value)
      if tuple(value.shape) != tuple(own[key].shape):
        raise ValueError(f"{key}: shape {value.shape} != {tuple(own[key].shape)}")
      own[key].copy_(torch.from_numpy(np.ascontiguousarray(value, dtype=np.float32)))
  return model


def init_params(model: nn.Module, seed: int) -> Dict[str, np.ndarray]:
  """Seeded flax-style initial parameters for `model`, as a flat flax-path map.

  Conv and deconv kernels: glorot uniform; biases: zero; GDN: beta =
  sqrt(1 + pedestal), gamma = sqrt(0.1 I + pedestal); PReLU's slope: 0.25
  (models/transforms.py:123); deep factorized prior:
  as shallow_ntc_tpu/ops/entropy.py:DeepFactorizedPrior.setup.
  """
  rng = np.random.default_rng(seed)
  shapes = {name: tuple(p.shape) for name, p in model.named_parameters()}
  n_prior_layers = {}
  for name in shapes:
    head, _, leaf = name.rpartition(".")
    if leaf.startswith("matrix_"):
      n_prior_layers[head] = n_prior_layers.get(head, 0) + 1
  flat = {}
  for name, shape in shapes.items():
    head, _, leaf = name.rpartition(".")
    if leaf == "kernel":
      fan_in = shape[0] * shape[1] * shape[2]
      fan_out = shape[0] * shape[1] * shape[3]
      limit = math.sqrt(6.0 / (fan_in + fan_out))
      value = rng.uniform(-limit, limit, shape)
    elif leaf == "beta":
      value = np.full(shape, math.sqrt(1.0 + _GDN_PEDESTAL))
    elif leaf == "gamma":
      value = np.sqrt(0.1 * np.eye(shape[0]) + _GDN_PEDESTAL)
    elif leaf.startswith("matrix_"):
      scale = _PRIOR_INIT_SCALE ** (1.0 / n_prior_layers[head])
      value = np.full(shape, math.log(math.expm1(1.0 / scale / shape[1])))
    elif leaf.startswith("bias_"):
      value = rng.uniform(-0.5, 0.5, shape)
    elif leaf == "negative_slope":
      value = np.full(shape, _PRELU_INIT_SLOPE)
    elif leaf == "bias" or leaf.startswith("factor_"):
      value = np.zeros(shape)
    else:
      raise KeyError(f"no initializer for {name}")
    flat[name.replace(".", "/")] = value.astype(np.float32)
  return flat
