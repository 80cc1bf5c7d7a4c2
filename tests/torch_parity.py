"""Shared helpers of the test_torch_* files: the JAX package against its port.

Inputs are made with numpy from a seed and handed to both packages; arrays
cross between them as numpy. JAX runs on the CPU in full float32
(tests/conftest.py), and so does torch here.
"""

import copy
import functools

import jax
import numpy as np
import torch

from shallow_ntc_tpu.models import base as jax_base
from shallow_ntc_tpu.models import factorized as jax_factorized
from shallow_ntc_tpu.models import mshyper as jax_mshyper
from shallow_ntc_tpu_torch import configs
from shallow_ntc_tpu_torch import params as params_lib
from shallow_ntc_tpu_torch.models import families

JAX_FAMILIES = {"mshyper": jax_mshyper.Model, "factorized": jax_factorized.Model}

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


def models(model_config=None, seed=0, family="mshyper"):
  """(flax Model, its params as a tree, port Model on the CPU with the same
  params), each built as its package's model factory builds it (mixedq turns
  the offset heuristic off)."""
  cfg = copy.deepcopy(model_config or SMALL_CONFIG)
  cfg.pop("optimizer_config", None)
  port = families.build_model(cfg, family)[0].eval()
  flat = perturbed_init(port, seed)
  params_lib.load_params(port, flat)
  cfg["offset_heuristic"] = jax_base.effective_offset_heuristic(cfg)
  jax_model = JAX_FAMILIES[family](**cfg)
  return jax_model, jax.tree_util.tree_map(np.asarray, nest(flat)), port


def jax_eval(jax_model, params, images, step=0):
  """(rd_loss, metrics, rec255) of the JAX model's training=False loss."""
  return jax.jit(lambda p, x: jax_model.apply(
      {"params": p}, x, training=False, rng=None, step=step,
      method=type(jax_model).end_to_end_frame_loss))(params, images)


def images(seed, hw):
  """One normalized [1, H, W, 3] image of random 0..255 pixels."""
  rng = np.random.default_rng(seed)
  return (rng.integers(0, 256, (1,) + hw + (3,)).astype(np.float32) / 255.0 - 0.5)


def check_eval_matches_jax(jax_model, params, port, x):
  """The port's training=False eval of image x against the JAX model's:
  latents atol 1e-4; the hyper-synthesis and synthesis from JAX's rounded
  latents atol 1e-4; bpp, PSNR, MSE and rd_loss rtol 1e-3; (MS-)SSIM atol
  1e-5 (it lies in [-1, 1] and is near 0 at a random init)."""
  cls = jax_mshyper.Model

  def apply(method, *args):  # jitted: one compile, not one per op
    return jax.jit(functools.partial(jax_model.apply, method=method))({"params": params}, *args)

  rv = apply(cls.infer_latent_rvs, x)
  z_j, y_j = (np.asarray(r.loc) for r in rv.uq)
  with torch.no_grad():
    rv_t = port.infer_latent_rvs(to_torch(x))
    z_t, y_t = (to_numpy(r.loc) for r in rv_t.uq)
  np.testing.assert_allclose(z_t, z_j, atol=1e-4)
  np.testing.assert_allclose(y_t, y_j, atol=1e-4)

  # Feed JAX's y_hat to the port's synthesis: a symbol that rounding flips
  # at a .5 boundary must not hide a reconstruction error.
  offset = apply(cls.prior_quantization_offset)
  offset = 0.0 if offset is None else np.asarray(offset)  # None: the heuristic is off
  z_hat = np.round(z_j - offset) + offset
  mu, idx = apply(cls.hyper_synthesize, z_hat)
  y_hat = np.round(y_j - np.asarray(mu)) + np.asarray(mu)
  rec_j = apply(cls.synthesize, y_hat)
  with torch.no_grad():
    mu_t, idx_t = port.hyper_synthesize(to_torch(z_hat))
    rec_t = port.synthesize(to_torch(y_hat))
  np.testing.assert_allclose(to_numpy(mu_t), np.asarray(mu), atol=1e-4)
  np.testing.assert_allclose(to_numpy(idx_t), np.asarray(idx), rtol=1e-4, atol=1e-4)
  np.testing.assert_allclose(to_numpy(rec_t), np.asarray(rec_j), atol=1e-4)

  _, m_j, _ = jax_eval(jax_model, params, x)
  with torch.no_grad():
    _, m_t, rec255 = port.end_to_end_frame_loss(to_torch(x), training=False)
  assert rec255.shape == x.shape
  assert set(m_t) == set(m_j)
  for key in ("bpp", "hyper_latent_bpp", "latent_bpp", "psnr", "mse", "rd_loss"):
    np.testing.assert_allclose(float(m_t[key]), float(m_j[key]), rtol=1e-3, err_msg=key)
  np.testing.assert_array_equal(float(m_t["sched_rd_lambda"]), float(m_j["sched_rd_lambda"]))
  np.testing.assert_allclose(float(m_t["msssim"]), float(m_j["msssim"]), atol=1e-5)
