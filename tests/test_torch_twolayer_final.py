"""final_deconv_phase: the port's plain version against the JAX Pallas kernel
(interpret mode on the CPU) and its dense reference. The CUDA kernel is held
against the plain version on the card in tests/test_torch_cuda.py."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from shallow_ntc_tpu.ops.pallas import twolayer_final as jax_tl
from shallow_ntc_tpu_torch.models import transforms as T
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
