"""Shared helpers of the test_torch_* files: the JAX package against its port.

Inputs are made with numpy from a seed and handed to both packages; arrays
cross between them as numpy. JAX runs on the CPU in full float32
(tests/conftest.py), and so does torch here.
"""

import copy

import jax
import numpy as np
import torch

from shallow_ntc_tpu.models import mshyper as jax_mshyper
from shallow_ntc_tpu_torch import configs
from shallow_ntc_tpu_torch import params as params_lib
from shallow_ntc_tpu_torch.models.mshyper import Model

# ELIC at narrow widths; the synthesis keeps the flagship's (12, 3) widths,
# kernels and strides, so the final stage has the flagship geometry.
SMALL_CONFIG = copy.deepcopy(configs.TWO_LAYER_SYN_RD)
SMALL_CONFIG["transform_config"]["analysis"]["channels"] = (8, 8, 8, 16)


def to_torch(x) -> torch.Tensor:
  return torch.from_numpy(np.array(x, dtype=np.float32))


def to_numpy(x) -> np.ndarray:
  if isinstance(x, torch.Tensor):
    return x.detach().cpu().numpy()
  return np.asarray(x)


def rand(rng: np.random.Generator, shape, scale=1.0) -> np.ndarray:
  return (rng.standard_normal(shape) * scale).astype(np.float32)


def nest(flat):
  """{"a/b/kernel": x} -> {"a": {"b": {"kernel": x}}} (a flax parameter tree)."""
  tree = {}
  for path, value in flat.items():
    node = tree
    *heads, leaf = path.split("/")
    for h in heads:
      node = node.setdefault(h, {})
    node[leaf] = value
  return tree


def perturbed_init(model: torch.nn.Module, seed: int):
  """The port's flax-style init with every leaf nudged, so zero biases and
  the GDN's diagonal init do not hide a wrongly mapped parameter."""
  rng = np.random.default_rng(seed + 1000)
  flat = params_lib.init_params(model, seed)
  return {k: (v + rng.uniform(0.0, 0.02, v.shape)).astype(np.float32)
          for k, v in flat.items()}


def models(model_config=None, seed=0):
  """(flax Model, its params as a tree, port Model on the CPU with the same params)."""
  cfg = copy.deepcopy(model_config or SMALL_CONFIG)
  port = Model(**cfg).eval()
  flat = perturbed_init(port, seed)
  params_lib.load_params(port, flat)
  jax_model = jax_mshyper.Model(**cfg)
  return jax_model, jax.tree_util.tree_map(np.asarray, nest(flat)), port


def jax_eval(jax_model, params, images, step=0):
  """(rd_loss, metrics, rec255) of the JAX model's training=False loss."""
  return jax.jit(lambda p, x: jax_model.apply(
      {"params": p}, x, training=False, rng=None, step=step,
      method=type(jax_model).end_to_end_frame_loss))(params, images)
