"""final_deconv_phase: the port's plain version against the JAX Pallas kernel
(interpret mode on the CPU) and its dense reference. The CUDA kernel is held
against the plain version on the card in tests/test_torch_cuda.py."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from shallow_ntc_tpu.ops.pallas import twolayer_final as jax_tl
from shallow_ntc_tpu_torch.models import transforms as T
from shallow_ntc_tpu_torch.ops import fast_deconv as fd
from shallow_ntc_tpu_torch.ops import twolayer_final as tl
from tests.torch_parity import rand, to_numpy, to_torch

ATOL = 1e-4  # as tests/test_pallas.py


def _inputs(seed, b, h, w, c_in=12, c_out=3, k=5):
  rng = np.random.default_rng(seed)
  return (rand(rng, (b, h, w, 64 * c_in)), rand(rng, (k, k, c_in, c_out), 0.1),
          rand(rng, (c_out,), 0.1))


@pytest.mark.parametrize("b,h,w", [(1, 2, 3), (2, 2, 2), (2, 4, 3)])
def test_plain_matches_jax_kernel(b, h, w):
  """B in {1, 2} with even H: the shapes the JAX kernel takes (twolayer_final.py:243)."""
  mid_p, kernel, bias = _inputs(b * 10 + h, b, h, w)
  ref = jax_tl.final_deconv_phase(mid_p, kernel, bias, 12)
  out = tl.final_deconv_phase(to_torch(mid_p), to_torch(kernel), to_torch(bias), 12)
  assert out.shape == (b, 16 * h, 16 * w, 3)
  np.testing.assert_allclose(to_numpy(out), np.asarray(ref), atol=ATOL)


@pytest.mark.parametrize("b,h,w,k", [(3, 3, 2, 5), (1, 1, 1, 5), (2, 3, 2, 7), (1, 2, 2, 3)])
def test_plain_matches_jax_reference_any_batch_and_height(b, h, w, k):
  """Odd batch and height, and the other kernel sizes the route admits, held
  against the JAX dense reference, which has no parity restriction."""
  mid_p, kernel, bias = _inputs(b + h + k, b, h, w, c_in=4, c_out=3, k=k)
  ref = jax_tl._reference_final_deconv(mid_p, kernel, bias, 4)
  out = tl.final_deconv_phase(to_torch(mid_p), to_torch(kernel), to_torch(bias), 4)
  np.testing.assert_allclose(to_numpy(out), np.asarray(ref), atol=ATOL)


def test_gradients_match_jax_custom_vjp():
  mid_p, kernel, bias = _inputs(3, 2, 2, 3)
  cot = rand(np.random.default_rng(9), (2, 32, 48, 3))

  def loss(m, kk, b):
    return jnp.vdot(jax_tl.final_deconv_phase(m, kk, b, 12), cot)

  g_ref = jax.grad(loss, argnums=(0, 1, 2))(mid_p, kernel, bias)
  leaves = [to_torch(a).requires_grad_(True) for a in (mid_p, kernel, bias)]
  out = tl.final_deconv_phase(*leaves, 12)
  out.backward(to_torch(cot))
  for leaf, ref in zip(leaves, g_ref):
    np.testing.assert_allclose(to_numpy(leaf.grad), np.asarray(ref), atol=ATOL, rtol=1e-5)


def test_route_sends_flagship_geometry_to_the_kernel_at_any_batch(monkeypatch):
  calls = []
  monkeypatch.setattr(T, "final_deconv_phase",
                      lambda *a: calls.append(a[0].shape) or tl.final_deconv_plain(*a))
  mid_p, kernel, bias = (to_torch(a) for a in _inputs(0, 3, 3, 2))
  T._final_deconv_packed(mid_p, kernel, bias, 8, 2, 12)
  assert calls == [(3, 3, 2, 768)]
  # A mid tensor wider than 128 lanes per phase row takes the dense form.
  mid_wide, kernel_wide, bias_wide = (to_torch(a) for a in _inputs(1, 1, 1, 1, c_in=20))
  T._final_deconv_packed(mid_wide, kernel_wide, bias_wide, 8, 2, 20)
  assert len(calls) == 1


def test_kernel_wrapper_refuses_non_cuda_tensors():
  mid_p, kernel, bias = (to_torch(a) for a in _inputs(0, 1, 1, 1))
  with pytest.raises(ValueError, match="CUDA tensor"):
    tl.final_deconv_cuda(mid_p, kernel, bias, 12)
  launches = tl.STATS.launches
  tl.final_deconv_phase(mid_p, kernel, bias, 12)  # CPU: the plain version, no launch
  assert tl.STATS.launches == launches


def _quad_gemm(mid_p, kernel, bias, c_in):
  """The GEMM the CUDA kernel runs, in torch: each mid pixel's neighbourhood
  (X + d, Y + e), d and e in [d0, 1], its channels padded to 16, times the
  weights folded by fold_index, then each row's 4 parities scattered to its
  2x2 output quad."""
  k, c_out = kernel.shape[0], kernel.shape[3]
  d0, nd = tl.quad_taps(k)
  mid = fd.depth_to_space(mid_p, tl.S1)
  b, hm, wm, _ = mid.shape
  mid = F.pad(mid, (0, tl.K_PAD - c_in, -d0, 1, -d0, 1))
  rows = torch.stack([mid[:, dy:dy + hm, dx:dx + wm] for dy in range(nd) for dx in range(nd)],
                     dim=3)
  flat = F.pad(kernel.reshape(-1), (0, 1))  # the index past the kernel reads 0
  wf = flat[tl.fold_index(k, c_in, c_out).long()]
  quads = torch.einsum("bxytk,ctkn->bxycn", rows, wf)
  quads = quads.reshape(b, hm, wm, wf.shape[0], tl.S2, tl.S2, tl.CO_CHUNK)
  out = quads.permute(0, 1, 4, 2, 5, 3, 6).reshape(b, tl.S2 * hm, tl.S2 * wm, -1)
  return out[..., :c_out] + bias


@pytest.mark.parametrize("k,c_in,c_out", [(3, 12, 3), (5, 12, 3), (7, 12, 3), (5, 5, 5),
                                          (7, 16, 8)])
def test_kernel_weight_folding_matches_plain_and_jax(k, c_in, c_out):
  """fold_index, checked where the CUDA kernel cannot run: the quad GEMM
  against the plain version, and against the JAX Pallas kernel in interpret
  mode, or at k=7 against the JAX dense reference (the Pallas kernel skips
  the d=-2 taps there, ROADMAP queue 3)."""
  mid_p, kernel, bias = _inputs(k + c_in + c_out, 2, 2, 3, c_in=c_in, c_out=c_out, k=k)
  out = _quad_gemm(to_torch(mid_p), to_torch(kernel), to_torch(bias), c_in)
  plain = tl.final_deconv_plain(to_torch(mid_p), to_torch(kernel), to_torch(bias), c_in)
  jax_fn = jax_tl._reference_final_deconv if k == 7 else jax_tl.final_deconv_phase
  ref = jax_fn(mid_p, kernel, bias, c_in)
  assert out.shape == (2, 32, 48, c_out)
  np.testing.assert_allclose(to_numpy(out), to_numpy(plain), atol=ATOL)
  np.testing.assert_allclose(to_numpy(out), np.asarray(ref), atol=ATOL)


def test_plain_adds_a_float32_bias_to_bfloat16_mid_as_the_jax_kernel():
  """bfloat16 mid with float32 parameters, as a compute dtype below the
  parameters' gives: the Pallas kernel (interpret mode) rounds the weights to
  bfloat16, sums the products and adds the float32 bias in float32, and
  rounds once. The plain version must equal it at >= 99% of the outputs and
  lie within one bfloat16 ulp elsewhere (a sum in another order can round
  across). The biases lie off the bfloat16 grid: rounding them first, as the
  port did, leaves about 30% of these outputs one ulp away."""
  rng = np.random.default_rng(11)
  mid_p = (rng.standard_normal((2, 2, 3, 768)) * 0.05).astype(np.float32)
  kernel = rand(rng, (5, 5, 12, 3), 0.1)
  bias = np.array([1 + 3 * 2**-10, -2 + 5 * 2**-9, 0.5 + 2**-11], np.float32)
  mid_bf16 = jnp.asarray(mid_p, jnp.bfloat16)
  ref = jax_tl.final_deconv_phase(mid_bf16, kernel, bias, 12)
  assert ref.dtype == jnp.bfloat16
  ref = np.asarray(ref.astype(jnp.float32))
  out = tl.final_deconv_phase(to_torch(np.asarray(mid_bf16.astype(jnp.float32))).bfloat16(),
                              to_torch(kernel), to_torch(bias), 12)
  assert out.dtype == torch.bfloat16
  out = to_numpy(out.float())
  ulp = 2.0 ** (np.floor(np.log2(np.abs(ref))) - 7)
  assert np.mean(out == ref) >= 0.99
  assert np.all(np.abs(out - ref) <= ulp)
