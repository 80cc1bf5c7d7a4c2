"""The port's numeric ops and single layers against the JAX package (CPU, float32)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from shallow_ntc_tpu import schedule as jax_schedule
from shallow_ntc_tpu.models import transforms as jT
from shallow_ntc_tpu.ops import entropy as jax_entropy
from shallow_ntc_tpu.ops import fast_deconv as jax_fd
from shallow_ntc_tpu.ops import math as jax_math
from shallow_ntc_tpu.ops import metrics_ops as jax_metrics
from shallow_ntc_tpu.ops import rounding as jax_rounding
from shallow_ntc_tpu_torch import schedule
from shallow_ntc_tpu_torch.models import transforms as T
from shallow_ntc_tpu_torch.ops import entropy
from shallow_ntc_tpu_torch.ops import fast_deconv as fd
from shallow_ntc_tpu_torch.ops import math as tmath
from shallow_ntc_tpu_torch.ops import metrics_ops
from shallow_ntc_tpu_torch.ops import rounding
from tests.torch_parity import rand, to_numpy, to_torch

ATOL = 1e-4  # as tests/test_pallas.py


def _load(module, flax_params):
  with torch.no_grad():
    for name, value in flax_params.items():
      getattr(module, name).copy_(to_torch(value))
  return module


@pytest.mark.parametrize("transpose", [False, True])
@pytest.mark.parametrize("k,s,c_in,c_out,hw", [
    (5, 2, 3, 8, (13, 10)),   # ELIC stem / hyper convs; odd sizes pad unevenly
    (3, 1, 8, 6, (7, 9)),     # hyper k3s1, ResidualBlock 3x3
    (1, 1, 8, 4, (5, 6)),     # ResidualBlock / attention 1x1
    (13, 8, 6, 5, (3, 4)),    # synthesis k13s8
])
def test_conv_and_deconv_match_flax(transpose, k, s, c_in, c_out, hw):
  rng = np.random.default_rng(k * 10 + s)
  x = rand(rng, (2,) + hw + (c_in,))
  cls_j = jT.FastConvTranspose if transpose else jT.Conv
  cls_t = T.FastConvTranspose if transpose else T.Conv
  mod = cls_j(features=c_out, kernel_size=(k, k), strides=(s, s))
  params = {"kernel": rand(rng, (k, k, c_in, c_out), 0.2), "bias": rand(rng, (c_out,))}
  ref = mod.apply({"params": params}, x)
  out = _load(cls_t(c_in, c_out, k, s), params)(to_torch(x))
  assert out.shape == ref.shape
  np.testing.assert_allclose(to_numpy(out), np.asarray(ref), atol=ATOL)


@pytest.mark.parametrize("inverse", [False, True])
def test_gdn_matches_flax(inverse):
  rng = np.random.default_rng(7)
  c = 6
  x = rand(rng, (2, 5, 4, c))
  params = {"beta": np.abs(rand(rng, (c,))) + 0.5,
            "gamma": np.abs(rand(rng, (c, c), 0.1)).astype(np.float32)}
  params["gamma"][0, 1] = -0.3  # exercises the nonneg reparameterization's bound
  ref = jT.GDN1(inverse=inverse).apply({"params": params}, x)
  out = _load(T.GDN(c, inverse=inverse), params)(to_torch(x))
  np.testing.assert_allclose(to_numpy(out), np.asarray(ref), atol=ATOL)


@pytest.mark.parametrize("which", ["lower", "upper"])
def test_bounds_identity_if_towards_gradient(which):
  rng = np.random.default_rng(1)
  x = rand(rng, (64,))
  g = rand(rng, (64,))
  jfn = jax_math.lower_bound if which == "lower" else jax_math.upper_bound
  tfn = tmath.lower_bound if which == "lower" else tmath.upper_bound
  y_j, vjp = jax.vjp(lambda v: jfn(v, 0.1), jnp.asarray(x))
  xt = to_torch(x).requires_grad_(True)
  y_t = tfn(xt, 0.1)
  y_t.backward(to_torch(g))
  np.testing.assert_array_equal(to_numpy(y_t), np.asarray(y_j))
  np.testing.assert_array_equal(to_numpy(xt.grad), np.asarray(vjp(jnp.asarray(g))[0]))


def test_rounding_matches():
  rng = np.random.default_rng(2)
  x = rand(rng, (4, 5, 3), 3.0)
  off = rand(rng, (3,), 0.3)
  for a, b in [(rounding.round_st(to_torch(x), to_torch(off)), jax_rounding.round_st(x, off)),
               (rounding.round_st(to_torch(x)), jax_rounding.round_st(x)),
               (rounding.quantize_eval(to_torch(x), to_torch(off)),
                jax_rounding.quantize_eval(x, off))]:
    np.testing.assert_array_equal(to_numpy(a), np.asarray(b))
  xt = to_torch(x).requires_grad_(True)
  rounding.round_st(xt).sum().backward()
  np.testing.assert_array_equal(to_numpy(xt.grad), np.ones_like(x))


@pytest.mark.parametrize("lmbda,step", [(0.01, 0), (0.01, 5999), (0.01, 6000), (0.02, 0)])
def test_scheduled_rd_lambda(lmbda, step):
  ref = float(jax_schedule.scheduled_rd_lambda(lmbda, step, 30_000))
  assert np.float32(schedule.scheduled_rd_lambda(lmbda, step, 30_000)) == np.float32(ref)


@pytest.mark.parametrize("hw", [(64, 64), (192, 192), (170, 200)])
def test_msssim_or_ssim_matches(hw):
  rng = np.random.default_rng(hw[0])
  x = rng.integers(0, 256, (2,) + hw + (3,)).astype(np.float32)
  y = np.clip(x + rng.normal(0, 12, x.shape), 0, 255).astype(np.float32)
  ref = jax_metrics.msssim_or_ssim(x, y)
  out = metrics_ops.msssim_or_ssim(to_torch(x), to_torch(y))
  np.testing.assert_allclose(to_numpy(out), np.asarray(ref), atol=1e-5)
  mse_j, psnr_j = jax_metrics.mse_psnr(x, y)
  mse_t, psnr_t = metrics_ops.mse_psnr(to_torch(x), to_torch(y))
  np.testing.assert_allclose(to_numpy(mse_t), np.asarray(mse_j), rtol=1e-5)
  np.testing.assert_allclose(to_numpy(psnr_t), np.asarray(psnr_j), rtol=1e-5)


def test_msssim_of_image_without_a_coarse_window_is_nan_as_in_jax():
  x = np.full((1, 128, 192, 3), 100.0, np.float32)
  assert np.isnan(np.asarray(jax_metrics.msssim_or_ssim(x, x))).all()
  assert torch.isnan(metrics_ops.msssim_or_ssim(to_torch(x), to_torch(x))).all()


@pytest.mark.parametrize("hw", [(50, 70), (64, 64)])
def test_pad_unpad_images(hw):
  x = rand(np.random.default_rng(3), (1,) + hw + (3,))
  ref = jax_metrics.pad_images(x, 64)
  out = metrics_ops.pad_images(to_torch(x), 64)
  np.testing.assert_array_equal(to_numpy(out), np.asarray(ref))
  np.testing.assert_array_equal(to_numpy(metrics_ops.unpad_images(out, x.shape)), x)


def _prior_params(rng, c):
  """DeepFactorizedPrior params: flax init plus noise, so every leaf matters."""
  prior = jax_entropy.DeepFactorizedPrior(channels=c)
  params = prior.init(jax.random.PRNGKey(0), jnp.zeros((1, c)))["params"]
  return prior, {k: (np.asarray(v) + rng.normal(0, 0.2, v.shape)).astype(np.float32)
                 for k, v in params.items()}


def test_deep_factorized_prior_matches():
  rng = np.random.default_rng(4)
  c = 5
  prior, params = _prior_params(rng, c)
  port = _load(entropy.DeepFactorizedPrior(c), params)
  y = rand(rng, (2, 3, 4, c), 4.0)
  for method in ("logits_cdf", "log_prob_noisy"):
    ref = prior.apply({"params": params}, y, method=getattr(type(prior), method))
    out = getattr(port, method)(to_torch(y))
    np.testing.assert_allclose(to_numpy(out), np.asarray(ref), atol=ATOL)
  ref_off = prior.apply({"params": params}, method=type(prior).quantization_offset)
  np.testing.assert_allclose(to_numpy(port.quantization_offset()), np.asarray(ref_off),
                             atol=1e-5)
  offset = to_torch(ref_off)
  s_t, bits_t = entropy.batched_em_call(port, to_torch(y), offset)
  s_j, bits_j = prior.apply(
      {"params": params}, y, method=lambda m, v: jax_entropy.batched_em_call(
          m, v, False, None, ref_off))
  np.testing.assert_array_equal(to_numpy(s_t), np.asarray(s_j))
  np.testing.assert_allclose(to_numpy(bits_t), np.asarray(bits_j), rtol=1e-5)


def test_indexed_em_call_matches():
  rng = np.random.default_rng(5)
  shape = (2, 4, 6, 8)
  y = rand(rng, shape, 5.0)
  loc = rand(rng, shape, 2.0)
  # Indexes reach below 0 and above 63, so both clips are exercised.
  indexes = rng.uniform(-3, 70, shape).astype(np.float32)
  s_j, bits_j = jax_entropy.indexed_em_call(y, indexes, loc, False, None)
  s_t, bits_t = entropy.indexed_em_call(to_torch(y), to_torch(indexes), to_torch(loc))
  np.testing.assert_allclose(to_numpy(s_t), np.asarray(s_j), atol=1e-5)
  np.testing.assert_allclose(to_numpy(bits_t), np.asarray(bits_j), rtol=1e-5)
  centered = rand(rng, (1000,), 30.0)
  scale = rng.uniform(0.11, 256, (1000,)).astype(np.float32)
  np.testing.assert_allclose(
      to_numpy(entropy.noisy_normal_log_prob(to_torch(centered), to_torch(scale))),
      np.asarray(jax_entropy.noisy_normal_log_prob(centered, scale)), atol=ATOL)


@pytest.mark.parametrize("k,s", [(13, 8), (5, 2), (3, 1)])
def test_phase_conv_and_depth_to_space_match(k, s):
  rng = np.random.default_rng(k)
  z = rand(rng, (2, 3, 4, 6))
  kernel = rand(rng, (k, k, 6, 4), 0.2)
  bias = rand(rng, (4,))
  ref = jax_fd.phase_conv(z, kernel, bias, s)
  out = fd.phase_conv(to_torch(z), to_torch(kernel), to_torch(bias), s)
  np.testing.assert_allclose(to_numpy(out), np.asarray(ref), atol=ATOL)
  np.testing.assert_array_equal(to_numpy(fd.depth_to_space(out, s)),
                                np.asarray(jax_fd.depth_to_space(np.asarray(to_numpy(out)), s)))
  np.testing.assert_allclose(
      to_numpy(fd.depth_to_space(out, s)),
      to_numpy(fd.fast_conv_transpose(to_torch(z), to_torch(kernel), to_torch(bias), s)),
      atol=ATOL)


@pytest.mark.parametrize("inverse", [False, True])
def test_gdn_phase_matches(inverse):
  rng = np.random.default_rng(8)
  c, phases = 4, 16
  x = rand(rng, (2, 3, 3, phases * c))
  beta = np.abs(rand(rng, (c,))) + 0.5
  gamma = np.abs(rand(rng, (c, c), 0.2))
  ref = jax_fd.gdn_phase(x, beta, gamma, phases, inverse)
  out = fd.gdn_phase(to_torch(x), to_torch(beta), to_torch(gamma), phases, inverse)
  np.testing.assert_allclose(to_numpy(out), np.asarray(ref), atol=ATOL)


@pytest.mark.parametrize("s,keep", [(8, 8), (8, 2)])
def test_packed_conv_transpose_matches(s, keep):
  rng = np.random.default_rng(s + keep)
  c_in, c_out, k = 3, 2, 5
  x_p = rand(rng, (2, 2, 3, s * s * c_in))
  kernel = rand(rng, (k, k, c_in, c_out), 0.2)
  bias = rand(rng, (c_out,))
  ref = jax_fd.packed_conv_transpose(jax_fd.partial_depth_to_space(x_p, s, keep),
                                     kernel, bias, 2, keep)
  out = fd.packed_conv_transpose(fd.partial_depth_to_space(to_torch(x_p), s, keep),
                                 to_torch(kernel), to_torch(bias), 2, keep)
  np.testing.assert_allclose(to_numpy(out), np.asarray(ref), atol=ATOL)
