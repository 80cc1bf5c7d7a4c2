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
from tests.torch_parity import SMALL_CONFIG, check_eval_matches_jax, images, models

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def small_models():
  return models(SMALL_CONFIG, seed=0)


@pytest.mark.parametrize("hw", [(64, 64), (128, 192)])
def test_end_to_end_eval_matches_jax(small_models, hw):
  check_eval_matches_jax(*small_models, images(hw[0], hw))


def test_eval_pass_computes_the_prior_offset_once(small_models, monkeypatch):
  """evaluate_images runs the offset's bisection once per pass and passes it
  down as frozen_offset; the per-image metrics of a 3-image pass equal, bit
  for bit, those of the path that recomputes it for every image
  (end_to_end_frame_loss)."""
  port = small_models[2]
  xs = np.concatenate([images(20 + i, (64, 64)) for i in range(3)])
  with torch.no_grad():
    per_image = [{k: float(v) for k, v in
                  port.end_to_end_frame_loss(torch.from_numpy(xs[i : i + 1]))[1].items()}
                 for i in range(3)]
  calls = []
  offset = port._prior.quantization_offset
  monkeypatch.setattr(port._prior, "quantization_offset",
                      lambda: calls.append(1) or offset())
  assert list(eval_lib.evaluate_images(port, xs)) == per_image
  assert len(calls) == 1


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


def test_eval_cli_sets_tf32_by_matmul_precision(tmp_path, monkeypatch):
  """--matmul_precision highest (the default) turns TF32 off for cuDNN convs
  and matmuls before the model is built; default turns it on."""
  monkeypatch.setattr(eval_lib.configs, "TWO_LAYER_SYN_RD", SMALL_CONFIG)
  monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", True)
  monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", True)
  seen = []
  build = eval_lib.build_model

  def spy(*args, **kwargs):
    seen.append((torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32))
    return build(*args, **kwargs)

  monkeypatch.setattr(eval_lib, "build_model", spy)
  np.save(tmp_path / "img.npy", np.zeros((64, 64, 3), np.uint8))
  argv = ["--init_seed", "0", "--images", str(tmp_path / "img.npy"), "--device", "cpu",
          "--results_dir", str(tmp_path / "out")]
  eval_cli.main(argv)
  assert seen[-1] == (False, False)
  assert not torch.backends.cudnn.allow_tf32 and not torch.backends.cuda.matmul.allow_tf32
  eval_cli.main(argv + ["--matmul_precision", "default"])
  assert seen[-1] == (True, True)
  assert torch.backends.cudnn.allow_tf32 and torch.backends.cuda.matmul.allow_tf32


def test_port_imports_no_jax():
  """Importing every module of the port pulls in no JAX, flax, scipy or JAX-package module."""
  code = (
      "import importlib, pkgutil, sys\n"
      "import shallow_ntc_tpu_torch as p\n"
      "for m in pkgutil.walk_packages(p.__path__, 'shallow_ntc_tpu_torch.'):\n"
      "  importlib.import_module(m.name)\n"
      "bad = sorted(n for n in sys.modules if n.split('.')[0] in\n"
      "  ('jax', 'jaxlib', 'flax', 'optax', 'orbax', 'ml_collections', 'absl',\n"
      "   'PIL', 'tensorflow', 'scipy', 'shallow_ntc_tpu'))\n"
      "names = {m.name for m in pkgutil.walk_packages(p.__path__, 'shallow_ntc_tpu_torch.')}\n"
      "need = {'shallow_ntc_tpu_torch.' + n for n in ('train_lib', 'train', 'ops.rb_chain',\n"
      "        'ops.resblock', 'eval', 'models.mshyper', 'ops.jpegl_decode', 'codec.api',\n"
      "        'codec.tables', 'codec.bindings', 'compress', 'itinf', 'itinf_lib',\n"
      "        'models.factorized', 'models.families', 'ops.int8ops', 'models.lpips',\n"
      "        'utils.tf_checkpoint', 'utils.tf_convert', 'convert_tf_checkpoint')}\n"
      "assert need <= names, need - names\n"
      "print(len(names), bad)\n"
      "assert not bad, bad\n")
  proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                        text=True, timeout=120)
  assert proc.returncode == 0, proc.stderr
