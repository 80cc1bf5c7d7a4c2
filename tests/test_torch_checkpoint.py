"""The committed flagship checkpoint, restored by the JAX package and bridged in
memory into the port: one 64x64 crop through both (CPU, float32)."""

import os

import numpy as np
import pytest
import torch

from shallow_ntc_tpu import eval_lib as jax_eval_lib
from shallow_ntc_tpu.models import base as jax_base
from shallow_ntc_tpu_torch import eval_lib
from tests.torch_parity import jax_eval, to_numpy, to_torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKDIR = os.path.join(REPO, "train_xms_rd", "201b91d1", "mshyper-lmbda=0.01-num_steps=30000")


def test_committed_checkpoint_crop_matches_jax():
  if not os.path.isdir(os.path.join(WORKDIR, "train", "checkpoints")):
    pytest.skip("the committed checkpoint is not in this copy of the repo")
  jax_model, params, config = jax_eval_lib.load_latest_ckpt(WORKDIR)
  step = config["_restored_step"]
  model_config = jax_base.to_plain_dict(config["model_config"])
  port = eval_lib.build_model(model_config, params=params, device="cpu")

  rng = np.random.default_rng(0)
  # A smooth 64x64 crop (the trained model's regime), plus pixel noise.
  yy, xx = np.meshgrid(np.linspace(0, 1, 64), np.linspace(0, 1, 64), indexing="ij")
  img = 128 + 80 * np.sin(6 * yy + 3 * xx)[..., None] * np.array([1.0, 0.7, -0.5])
  img = np.clip(img + rng.normal(0, 4, img.shape), 0, 255).round()
  x = (img[None] / 255.0 - 0.5).astype(np.float32)

  _, m_j, rec_j = jax_eval(jax_model, params, x, step=step)
  with torch.no_grad():
    rv = port.infer_latent_rvs(to_torch(x))
    rv_j = jax_model.apply({"params": params}, x, method=type(jax_model).infer_latent_rvs)
    for a, b in zip(rv.uq, rv_j.uq):
      np.testing.assert_allclose(to_numpy(a.loc), np.asarray(b.loc), atol=1e-4)
    _, m_t, rec_t = port.end_to_end_frame_loss(to_torch(x), training=False, step=step)
  for key in ("bpp", "psnr", "rd_loss"):
    np.testing.assert_allclose(float(m_t[key]), float(m_j[key]), rtol=1e-3, err_msg=key)
  assert float(m_t["psnr"]) > 20.0  # the trained model reconstructs the crop
  # Reconstructions on the 255 grid agree except where a flipped symbol or a
  # .5 rounding moves a pixel.
  assert np.mean(to_numpy(rec_t) == np.asarray(rec_j)) > 0.99
