"""The port's mshyper eval path end to end against the JAX package, and the
port's entry points (CPU, float32)."""

import json
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from shallow_ntc_tpu.models import mshyper as jax_mshyper
from shallow_ntc_tpu_torch import eval as eval_cli
from shallow_ntc_tpu_torch import eval_lib
from shallow_ntc_tpu_torch import params as params_lib
from shallow_ntc_tpu_torch.models.mshyper import Model
from tests.torch_parity import SMALL_CONFIG, jax_eval, models, to_numpy, to_torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _images(seed, hw):
  rng = np.random.default_rng(seed)
  return (rng.integers(0, 256, (1,) + hw + (3,)).astype(np.float32) / 255.0 - 0.5)


@pytest.fixture(scope="module")
def small_models():
  return models(SMALL_CONFIG, seed=0)


@pytest.mark.parametrize("hw", [(64, 64), (128, 192)])
def test_end_to_end_eval_matches_jax(small_models, hw):
  jax_model, params, port = small_models
  x = _images(hw[0], hw)
  cls = jax_mshyper.Model
  rv = jax_model.apply({"params": params}, x, method=cls.infer_latent_rvs)
  z_j, y_j = (np.asarray(r.loc) for r in rv.uq)
  with torch.no_grad():
    rv_t = port.infer_latent_rvs(to_torch(x))
    z_t, y_t = (to_numpy(r.loc) for r in rv_t.uq)
  np.testing.assert_allclose(z_t, z_j, atol=1e-4)
  np.testing.assert_allclose(y_t, y_j, atol=1e-4)

  # Feed JAX's y_hat to the port's synthesis: a symbol that rounding flips
  # at a .5 boundary must not hide a reconstruction error.
  offset = jax_model.apply({"params": params}, method=cls.prior_quantization_offset)
  z_hat = np.round(z_j - offset) + offset
  mu, idx = jax_model.apply({"params": params}, z_hat, method=cls.hyper_synthesize)
  y_hat = np.round(y_j - np.asarray(mu)) + np.asarray(mu)
  rec_j = jax_model.apply({"params": params}, y_hat, method=cls.synthesize)
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
  # (MS-)SSIM lies in [-1, 1]; a random-init model's is near 0, so absolute.
  np.testing.assert_allclose(float(m_t["msssim"]), float(m_j["msssim"]), atol=1e-5)


def test_numpy_init_has_the_flax_tree():
  """init_params gives exactly the paths and shapes of the flax Model.init."""
  jax_model = jax_mshyper.Model(**SMALL_CONFIG)
  shapes = jax.eval_shape(lambda: jax_model.init(
      jax.random.PRNGKey(0), np.zeros((1, 64, 64, 3), np.float32), training=False))["params"]
  flax_flat = {"/".join(str(k.key) for k in path): tuple(leaf.shape)
               for path, leaf in jax.tree_util.tree_leaves_with_path(shapes)}
  flat = params_lib.init_params(Model(**SMALL_CONFIG), seed=3)
  assert {k: v.shape for k, v in flat.items()} == flax_flat
  flat2 = params_lib.init_params(Model(**SMALL_CONFIG), seed=3)
  assert all(np.array_equal(flat[k], flat2[k]) for k in flat)


def test_load_params_refuses_a_mismatched_tree():
  port = Model(**SMALL_CONFIG)
  flat = params_lib.init_params(port, 0)
  with pytest.raises(KeyError):
    params_lib.load_params(port, {k: v for k, v in flat.items() if "_prior" not in k})
  flat["_prior/matrix_0"] = np.zeros((1, 1, 1), np.float32)
  with pytest.raises(ValueError):
    params_lib.load_params(port, flat)


def test_entry_points_need_cuda_unless_told_otherwise(monkeypatch, tmp_path):
  monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
  with pytest.raises(RuntimeError, match="CUDA is not available"):
    eval_lib.build_model(SMALL_CONFIG, init_seed=0)
  with pytest.raises(RuntimeError, match="CUDA is not available"):
    eval_cli.main(["--init_seed", "0", "--dataset", "synthetic",
                   "--results_dir", str(tmp_path)])
  assert eval_lib.build_model(SMALL_CONFIG, init_seed=0, device="cpu") is not None


def test_eval_cli_writes_the_jax_record_keys(tmp_path, monkeypatch):
  """The CLI on a params .npz and on .npy images, at the small config."""
  monkeypatch.setattr(eval_lib.configs, "TWO_LAYER_SYN_RD", SMALL_CONFIG)
  flat = params_lib.init_params(Model(**SMALL_CONFIG), 1)
  np.savez(tmp_path / "weights.npz", step=np.int64(30000), **flat)
  rng = np.random.default_rng(0)
  for i in range(2):
    np.save(tmp_path / f"img{i}.npy", rng.integers(0, 256, (40, 72, 3)).astype(np.uint8))
  path = eval_cli.main(["--params", str(tmp_path / "weights.npz"), "--images",
                        str(tmp_path / "img*.npy"), "--results_dir", str(tmp_path / "out"),
                        "--device", "cpu"])
  assert os.path.basename(path) == "mshyper-lmbda=0.01-num_steps=30000-step=30000-xid=weights.json"
  with open(path) as f:
    records = json.load(f)
  assert [r["instance_id"] for r in records] == [0, 1]
  assert set(records[0]) == {
      "rd_loss", "bpp", "mse", "psnr", "sched_rd_lambda", "hyper_latent_bpp", "latent_bpp",
      "msssim", "msssim_db", "instance_id", "lmbda", "num_steps"}
  assert records[0]["lmbda"] == "0.01" and records[0]["sched_rd_lambda"] == pytest.approx(0.01)
  assert all(np.isfinite(r["bpp"]) and np.isfinite(r["psnr"]) for r in records)


def test_port_imports_no_jax():
  """Importing every module of the port pulls in no JAX, flax or JAX-package module."""
  code = (
      "import importlib, pkgutil, sys\n"
      "import shallow_ntc_tpu_torch as p\n"
      "for m in pkgutil.walk_packages(p.__path__, 'shallow_ntc_tpu_torch.'):\n"
      "  importlib.import_module(m.name)\n"
      "bad = sorted(n for n in sys.modules if n.split('.')[0] in\n"
      "  ('jax', 'jaxlib', 'flax', 'optax', 'orbax', 'ml_collections', 'absl',\n"
      "   'PIL', 'tensorflow', 'shallow_ntc_tpu'))\n"
      "print(len(list(pkgutil.walk_packages(p.__path__))), bad)\n"
      "assert not bad, bad\n")
  proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                        text=True, timeout=120)
  assert proc.returncode == 0, proc.stderr
