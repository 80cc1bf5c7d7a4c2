"""The port's LPIPS (models/lpips.py) against the JAX package's on the CPU, and
the metric in the port's eval (eval_lib.evaluate_images, the eval CLI).

lpips_distance is held at rtol 1e-4 on the same random weights (the JAX
package's numpy draws): both run the same float32 VGG16 convolutions, which
sum in another order. The eval's LPIPS is held at rtol 1e-3, as the other
eval metrics: it reads the model's reconstruction.
"""

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from shallow_ntc_tpu import eval_lib as jax_eval_lib
from shallow_ntc_tpu.models import lpips as jax_lpips
from shallow_ntc_tpu_torch import eval as eval_cli
from shallow_ntc_tpu_torch import eval_lib
from shallow_ntc_tpu_torch.models import lpips
from tests.torch_parity import SMALL_CONFIG, images, models


def _pair(seed, shape, sigma):
  rng = np.random.default_rng(seed)
  x = rng.integers(0, 256, shape).astype(np.float32)
  return x, np.clip(np.round(x + rng.normal(0, sigma, shape)), 0, 255).astype(np.float32)


def test_random_weights_are_the_jax_draws():
  ref = jax_lpips.random_weights(3)
  ours = lpips.random_weights(3)
  assert sorted(ours) == sorted(ref)
  for k, v in ref.items():
    np.testing.assert_array_equal(ours[k].numpy(), np.asarray(v), err_msg=k)


@pytest.mark.parametrize("shape,sigma", [((2, 64, 64, 3), 20.0), ((1, 64, 64, 3), 3.0),
                                         ((1, 37, 53, 3), 40.0)])
def test_lpips_distance_matches_jax(shape, sigma):
  """64x64 at two distortions (a batch of two), and an odd size whose max
  pools drop a row and a column (2x2 VALID)."""
  x, y = _pair(len(shape) + int(sigma), shape, sigma)
  w_j, w_t = jax_lpips.random_weights(), lpips.random_weights()
  ref = np.asarray(jax_lpips.lpips_distance(w_j, jnp.asarray(x), jnp.asarray(y)))
  with torch.no_grad():
    out = lpips.lpips_distance(w_t, torch.from_numpy(x), torch.from_numpy(y)).numpy()
    same = lpips.lpips_distance(w_t, torch.from_numpy(x), torch.from_numpy(x)).numpy()
  assert out.shape == (shape[0],) and np.all(out > 0)
  np.testing.assert_allclose(out, ref, rtol=1e-4)
  np.testing.assert_allclose(same, 0.0, atol=1e-6)


def test_weights_file_is_the_jax_packages(tmp_path, monkeypatch):
  """One file serves both packages: the same default path, the same
  environment override, the same keys."""
  monkeypatch.delenv("SHALLOW_NTC_LPIPS_WEIGHTS", raising=False)
  assert lpips.default_weights_path() == jax_lpips.default_weights_path()
  path = tmp_path / "w.npz"
  np.savez(path, **{k: np.asarray(v) for k, v in jax_lpips.random_weights(5).items()})
  monkeypatch.setenv("SHALLOW_NTC_LPIPS_WEIGHTS", str(path))
  assert lpips.default_weights_path() == jax_lpips.default_weights_path() == str(path)
  x, y = _pair(1, (1, 32, 48, 3), 10.0)
  ref = float(jax_lpips.make_lpips_fn()(jnp.asarray(x), jnp.asarray(y)))
  out = float(lpips.make_lpips_fn()(torch.from_numpy(x), torch.from_numpy(y)))
  np.testing.assert_allclose(out, ref, rtol=1e-4)


def test_evaluate_images_adds_the_jax_evals_lpips(tmp_path):
  """evaluate_images(..., lpips_fn) against the JAX eval's per-image LPIPS
  (eval_lib.py:200-202), the narrow flagship on two 64x96 images."""
  path = tmp_path / "w.npz"
  np.savez(path, **{k: v.numpy() for k, v in lpips.random_weights().items()})
  jax_model, params, port = models(SMALL_CONFIG, seed=1)
  xs = np.concatenate([images(s, (64, 96)) for s in (1, 2)])
  ref = list(jax_eval_lib.evaluate_images(jax_model, params, xs,
                                          lpips_fn=jax_lpips.make_lpips_fn(str(path))))
  ours = list(eval_lib.evaluate_images(port, xs, lpips_fn=lpips.make_lpips_fn(str(path))))
  assert all("lpips" not in r for r in eval_lib.evaluate_images(port, xs[:1]))
  for r_t, r_j in zip(ours, ref):
    assert set(r_t) == set(r_j)
    np.testing.assert_allclose(r_t["lpips"], r_j["lpips"], rtol=1e-3)


def _eval_cli(tmp_path, monkeypatch, weights):
  monkeypatch.setattr(eval_lib.configs, "TWO_LAYER_SYN_RD", SMALL_CONFIG)
  monkeypatch.setenv("SHALLOW_NTC_LPIPS_WEIGHTS", str(weights))
  np.save(tmp_path / "img.npy", np.random.default_rng(0).integers(0, 256, (64, 64, 3))
          .astype(np.uint8))
  return eval_cli.main(["--init_seed", "0", "--images", str(tmp_path / "img.npy"),
                        "--device", "cpu", "--results_dir", str(tmp_path / "out")])


def test_eval_cli_adds_lpips_with_a_weights_file(tmp_path, monkeypatch):
  path = tmp_path / "w.npz"
  np.savez(path, **{k: v.numpy() for k, v in lpips.random_weights().items()})
  with open(_eval_cli(tmp_path, monkeypatch, path)) as f:
    (record,) = json.load(f)
  assert np.isfinite(record["lpips"]) and record["lpips"] > 0


def test_eval_cli_omits_lpips_without_a_weights_file(tmp_path, monkeypatch, caplog):
  with open(_eval_cli(tmp_path, monkeypatch, tmp_path / "missing.npz")) as f:
    (record,) = json.load(f)
  assert "lpips" not in record and np.isfinite(record["bpp"])
  assert "LPIPS unavailable" in caplog.text
  with pytest.raises(FileNotFoundError):
    lpips.make_lpips_fn(str(tmp_path / "missing.npz"))


def test_eval_cli_raises_on_a_corrupt_weights_file(tmp_path, monkeypatch):
  """Only a missing file omits the metric; any other fault raises."""
  path = tmp_path / "corrupt.npz"
  path.write_bytes(b"not an npz file")
  with pytest.raises(Exception) as info:
    _eval_cli(tmp_path, monkeypatch, path)
  assert not isinstance(info.value, FileNotFoundError)
  truncated = tmp_path / "truncated.npz"
  np.savez(truncated, conv0_w=np.zeros((3, 3, 3, 64), np.float32))
  with pytest.raises(KeyError, match="missing"):
    _eval_cli(tmp_path, monkeypatch, truncated)
