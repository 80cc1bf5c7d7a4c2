"""The port's JPEG-like decoder against the JAX package (CPU, float32 unless
stated): jpegl_synthesize's plain version against the Pallas kernel in
interpret mode and the XLA conv, the JPEG-like transforms against flax, the
JPEG-like model's eval and two train steps against JAX, its configs and the
eval CLI's --config."""

import copy
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from shallow_ntc_tpu.models import transforms as jT
from shallow_ntc_tpu.ops.pallas import jpegl_decode as jd
from shallow_ntc_tpu_torch import configs
from shallow_ntc_tpu_torch import eval as eval_cli
from shallow_ntc_tpu_torch import eval_lib
from shallow_ntc_tpu_torch.models import transforms as T
from shallow_ntc_tpu_torch.ops import jpegl_decode
from tests.test_torch_train import OPTIMIZER_CONFIG, check_two_train_steps_match_jax
from tests.test_torch_transforms import ATOL, _pair
from tests.torch_parity import check_eval_matches_jax, images, models, rand, to_numpy, to_torch


def _small(model_config):
  """A JPEG-like model config at narrow ELIC widths (8, 8, 8, 16)."""
  cfg = copy.deepcopy(model_config)
  cfg["transform_config"]["analysis"]["channels"] = (8, 8, 8, 16)
  return cfg


SMALL_CONFIGS = {"k18": _small(configs.JPEGL_RD), "k16": _small(configs.JPEGL_K16)}


def _op_inputs(k, c_in, shape, use_bias=True, seed=0):
  """As tests/test_pallas.py: z ~ N(0, 3), kernel and bias ~ N(0, 0.1)."""
  rng = np.random.default_rng(seed)
  b, hl, wl = shape
  z = rng.normal(0, 3, (b, hl, wl, c_in)).astype(np.float32)
  kernel = rng.normal(0, 0.1, (k, k, c_in, 3)).astype(np.float32)
  bias = rng.normal(0, 0.1, (3,)).astype(np.float32) if use_bias else None
  return z, kernel, bias


def _maybe(fn, a):
  return None if a is None else fn(a)


@pytest.mark.parametrize("k,c_in,shape,use_bias", [
    (16, 32, (2, 4, 6), True), (8, 16, (1, 3, 5), True), (16, 33, (1, 2, 3), False)])
def test_plain_matches_pallas_and_xla(k, c_in, shape, use_bias):
  """atol 1e-4, as tests/test_pallas.py holds the Pallas kernel to the conv;
  the CPU route of jpegl_synthesize is the plain version and counts nothing."""
  z, kernel, bias = _op_inputs(k, c_in, shape, use_bias)
  jb = _maybe(jnp.asarray, bias)
  ref = np.asarray(jd.jpegl_synthesize(jnp.asarray(z), jnp.asarray(kernel), jb))
  xla = np.asarray(jd.jpegl_synthesize_xla(jnp.asarray(z), jnp.asarray(kernel), jb))
  launches = jpegl_decode.STATS.launches
  with torch.no_grad():
    out = jpegl_decode.jpegl_synthesize(to_torch(z), to_torch(kernel), _maybe(to_torch, bias))
    plain = jpegl_decode.jpegl_synthesize_plain(to_torch(z), to_torch(kernel),
                                                _maybe(to_torch, bias))
  assert out.shape == (shape[0], shape[1] * k, shape[2] * k, 3)
  np.testing.assert_allclose(to_numpy(out), ref, atol=1e-4)
  np.testing.assert_allclose(to_numpy(out), xla, atol=1e-4)
  assert torch.equal(out, plain) and jpegl_decode.STATS.launches == launches


def test_bf16_plain_matches_pallas():
  """bf16 z with float32 kernel and bias: both round the weights to bf16, sum
  in float32, add the float32 bias and round the output once, so they differ
  only where the sums, in another order, round across a bf16 boundary:
  atol 1e-2 max|y| (one bf16 ulp is 2^-8 to 2^-7 of a value)."""
  z, kernel, bias = _op_inputs(16, 32, (2, 4, 6), seed=3)
  zb = jnp.asarray(z, jnp.bfloat16)
  ref = jd.jpegl_synthesize(zb, jnp.asarray(kernel), jnp.asarray(bias))
  assert ref.dtype == jnp.bfloat16
  ref = np.asarray(ref.astype(jnp.float32))
  with torch.no_grad():
    out = jpegl_decode.jpegl_synthesize(to_torch(np.asarray(zb.astype(jnp.float32))).bfloat16(),
                                        to_torch(kernel), to_torch(bias))
  assert out.dtype == torch.bfloat16
  np.testing.assert_allclose(to_numpy(out.float()), ref, rtol=0, atol=1e-2 * np.abs(ref).max())


def test_pack_weights_matches_jax():
  """The packed weights and bias rows equal the Pallas wrapper's: both flips
  and the [k, C, k*c_out] row layout (an asymmetric kernel, so a missing flip
  shows)."""
  _, kernel, bias = _op_inputs(4, 5, (1, 1, 1), seed=1)
  for b in (bias, None):
    w_j, rows_j = jd.pack_weights(jnp.asarray(kernel), _maybe(jnp.asarray, b))
    w_t, rows_t = jpegl_decode.pack_weights(to_torch(kernel), _maybe(to_torch, b))
    np.testing.assert_array_equal(to_numpy(w_t), np.asarray(w_j))
    np.testing.assert_array_equal(to_numpy(rows_t), np.asarray(rows_j))


def _kernel_index_synthesize(z, kernel, bias):
  """jpegl_synthesize by the CUDA kernels' index arithmetic, in numpy.

  Wt[n, c] is gathered from the flat flax kernel twice: as the tiled kernel
  does (w_base: kernel[k-1-r, k-1-rc, c, co]) and as the K16 kernel stages
  its slices (4 patch rows each; 48-byte units of 8 channels x 3 outputs at
  ((kr k + kcol) C + 8 c8) 3, kr = k-1-r, deinterleaved into rows
  n = 48 rl + 3 (k-1-kcol) + co); output (m, n) is scattered to out_offset.
  """
  b, hl, wl, c_in = z.shape
  k, c_out = kernel.shape[0], kernel.shape[3]
  kc, n_cols, flat = k * c_out, k * k * c_out, kernel.reshape(-1)
  n = np.arange(n_cols)
  r, j = n // kc, n % kc
  w_base = ((k - 1 - r) * k + (k - 1 - j // c_out)) * c_in * c_out + j % c_out
  wt = flat[w_base[:, None] + np.arange(c_in)[None, :] * c_out]
  wt_k16 = np.full_like(wt, np.nan)
  for sl in range(k // 4):
    for rl in range(4):
      for kcol in range(k):
        for c8 in range(c_in // 8):
          kr = k - 1 - (4 * sl + rl)
          unit = flat[((kr * k + kcol) * c_in + 8 * c8) * 3:][:24]
          for co in range(3):
            wt_k16[4 * kc * sl + kc * rl + 3 * (k - 1 - kcol) + co, 8 * c8:8 * c8 + 8] = unit[co::3]
  np.testing.assert_array_equal(wt_k16, wt)
  m = np.arange(b * hl * wl)
  row, w_l = m // wl, m % wl
  offset = (((row[:, None] * k + r[None, :]) * wl + w_l[:, None]) * kc + j[None, :])
  out = np.zeros(b * hl * k * wl * k * c_out, np.float32)
  out[offset] = z.reshape(-1, c_in) @ wt.T + (0 if bias is None else bias[n % c_out])
  return out.reshape(b, hl * k, wl * k, c_out), wt


@pytest.mark.parametrize("k,c_in,shape", [(16, 320, (1, 3, 5)), (8, 16, (2, 2, 3))])
def test_kernel_index_arithmetic_matches_pack_weights_and_pallas(k, c_in, shape):
  """The kernels' weight gathers equal pack_weights' rows (exactly), and the
  GEMM scattered by their output offsets equals the Pallas kernel in
  interpret mode (atol 1e-4, as tests/test_pallas.py)."""
  z, kernel, bias = _op_inputs(k, c_in, shape, seed=k)
  out, wt = _kernel_index_synthesize(z, kernel, bias)
  w_packed, _ = jpegl_decode.pack_weights(to_torch(kernel), to_torch(bias))
  np.testing.assert_array_equal(wt, to_numpy(w_packed).transpose(0, 2, 1).reshape(-1, c_in))
  ref = np.asarray(jd.jpegl_synthesize(jnp.asarray(z), jnp.asarray(kernel), jnp.asarray(bias)))
  np.testing.assert_allclose(out, ref, atol=1e-4)


def test_backward_raises_as_jax_cannot_differentiate_either():
  z, kernel, bias = _op_inputs(8, 16, (1, 2, 2))
  zt = to_torch(z).requires_grad_(True)
  out = jpegl_decode.jpegl_synthesize(zt, to_torch(kernel), to_torch(bias))
  with pytest.raises(NotImplementedError, match="no gradient"):
    out.sum().backward()
  with pytest.raises(AssertionError):
    jax.grad(lambda x: jd.jpegl_synthesize(x, jnp.asarray(kernel), jnp.asarray(bias)).sum())(
        jnp.asarray(z))


def test_cuda_entry_refuses_a_cpu_tensor():
  z, kernel, bias = _op_inputs(8, 16, (1, 2, 2))
  with pytest.raises(ValueError, match="CUDA tensor"):
    jpegl_decode.jpegl_synthesize_cuda(to_torch(z), to_torch(kernel), to_torch(bias))


@pytest.mark.parametrize("cfg,in_c", [
    (dict(cls="JPEGLikeSynthesis", kernel_size=16, strides=16), 16),
    (dict(cls="JPEGLikeSynthesis", kernel_size=18, strides=16), 16),
    (dict(cls="JPEGLikeSynthesis", kernel_size=16, strides=16, use_offset=True), 16),
    (dict(cls="JPEGLikeSynthesis", kernel_size=16, strides=16, use_pallas=True), 16),
    (dict(cls="JPEGLikeSynthesis", kernel_size=16, strides=16, use_pallas=True,
          use_offset=True, use_bias=False), 15),
    (dict(cls="JPEGLikeSynthesis", kernel_size=18, strides=16, use_pallas=True), 16),
    (dict(cls="JPEGLikeHyperSynthesis", bottleneck_size=8), 8),
])
def test_jpeg_like_transforms_match_flax(cfg, in_c):
  """Parameter paths and shapes equal flax's init (k18s16, k16s16 with and
  without offset or bias, k6s4), and the outputs on the port's perturbed
  init agree at atol 1e-4. use_pallas at k=16 runs the Pallas kernel in JAX
  and the kernel's route (its plain version here) in the port; at k=18 both
  take the conv."""
  x = rand(np.random.default_rng(in_c), (2, 2, 3, in_c))
  jax_mod = jT.build_transform(dict(cfg))
  port = T.build_transform(dict(cfg), in_c)
  shapes = jax.eval_shape(lambda: jax_mod.init(jax.random.PRNGKey(0), x))["params"]
  flax_flat = {"/".join(str(k.key) for k in path): tuple(leaf.shape)
               for path, leaf in jax.tree_util.tree_leaves_with_path(shapes)}
  assert flax_flat == {k.replace(".", "/"): tuple(v.shape)
                       for k, v in port.state_dict().items()}
  ref, out, _ = _pair(jax_mod, port, x)
  up = port.upsample_factor
  assert out.shape == (2, 2 * up, 3 * up, port.output_depth)
  np.testing.assert_allclose(out, ref, atol=ATOL)


@pytest.fixture(scope="module", params=sorted(SMALL_CONFIGS))
def jpegl_models(request):
  return models(SMALL_CONFIGS[request.param], seed=0)


@pytest.mark.parametrize("hw", [(64, 64), (128, 192)])
def test_end_to_end_eval_matches_jax(jpegl_models, hw):
  """The JPEG-like model (ELIC (8, 8, 8, 16)) at k18 (the conv) and K16 (the
  kernel's route), with test_torch_model.py's tolerances."""
  launches = jpegl_decode.STATS.launches
  check_eval_matches_jax(*jpegl_models, images(hw[0], hw))
  assert jpegl_decode.STATS.launches == launches


def test_two_jpegl_train_steps_match_jax():
  """jpegl_rd's model at narrow ELIC widths, trained with the smoke config's
  optimizer (lr 1e-3 from step 0, so both steps move the parameters), with
  test_torch_train.py's tolerances."""
  check_two_train_steps_match_jax(SMALL_CONFIGS["k18"], OPTIMIZER_CONFIG)


def test_jpegl_configs_are_jpegl_rd():
  """The port's JPEG-like configs are mshyper/configs/jpegl_rd.py's model,
  optimizer and schedule; the run name is the one the JAX runs used."""
  from shallow_ntc_tpu.mshyper.configs import jpegl_rd

  ref = jpegl_rd.get_config()
  ref_model = copy.deepcopy(ref.model_config.to_dict())
  port = configs.TRAIN_CONFIGS["jpegl_rd"]
  assert port["model_config"] == ref_model
  assert configs.JPEGL_RD == {k: v for k, v in ref_model.items() if k != "optimizer_config"}
  for key in ("num_steps", "log_metrics_every_steps", "checkpoint_every_steps",
              "eval_every_steps", "max_validation_steps"):
    assert port["train_eval_config"][key] == ref.train_eval_config[key]
  assert configs.JPEGL_RD_RUNNAME == "mshyper-" + jpegl_rd.get_cfg_str(ref)
  k16 = copy.deepcopy(configs.JPEGL_K16)
  assert k16["transform_config"].pop("synthesis") == dict(
      cls="JPEGLikeSynthesis", kernel_size=16, strides=16, use_pallas=True)
  assert k16["transform_config"] == {"analysis": configs.JPEGL_RD["transform_config"]["analysis"]}


def test_eval_cli_config_jpegl_rd(tmp_path, monkeypatch):
  """--config jpegl_rd evaluates the JPEG-like model and names the results by
  its run name (the model at narrow widths, on the CPU)."""
  monkeypatch.setattr(eval_lib.configs, "JPEGL_RD", SMALL_CONFIGS["k18"])
  np.save(tmp_path / "img.npy", np.random.default_rng(0).integers(0, 256, (48, 64, 3)))
  path = eval_cli.main(["--config", "jpegl_rd", "--init_seed", "0", "--images",
                        str(tmp_path / "img.npy"), "--results_dir", str(tmp_path / "out"),
                        "--device", "cpu"])
  assert os.path.basename(path) == (
      "mshyper-synthesis=jpegl-lmbda=0.01-num_steps=30000-step=0-xid=init_seed=0.json")
  with open(path) as f:
    (record,) = json.load(f)
  assert record["synthesis"] == "jpegl" and record["lmbda"] == "0.01"
  assert np.isfinite(record["bpp"]) and np.isfinite(record["psnr"])
