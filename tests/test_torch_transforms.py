"""The port's transforms against the flax modules on the same parameters (CPU, float32)."""

import jax
import numpy as np
import pytest
import torch

from shallow_ntc_tpu.models import elic as jax_elic
from shallow_ntc_tpu.models import transforms as jT
from shallow_ntc_tpu_torch import params as params_lib
from shallow_ntc_tpu_torch.models import elic
from shallow_ntc_tpu_torch.models import transforms as T
from tests.torch_parity import nest, perturbed_init, rand, to_numpy, to_torch

ATOL = 1e-4  # as tests/test_pallas.py
SYN_CFG = dict(cls="TwoLayerResSynthesis", channels=(12, 3), strides=(8, 2),
               kernel_sizes=(13, 5), activation_type="igdn", res_type="conv")


def _pair(jax_module, port_module, x, seed=0):
  """Apply both modules to x with the port's perturbed init; return (ref, out, flat)."""
  flat = perturbed_init(port_module, seed)
  params_lib.load_params(port_module, flat)
  ref = jax_module.apply({"params": nest(flat)}, x)
  with torch.no_grad():
    out = port_module(to_torch(x))
  return np.asarray(ref), to_numpy(out), flat


def test_port_param_paths_match_flax_init():
  """Every flax parameter path and shape has its state-dict key, and no more."""
  z = np.zeros((1, 2, 3, 16), np.float32)
  shapes = jax.eval_shape(lambda: jT.build_transform(dict(SYN_CFG)).init(
      jax.random.PRNGKey(0), z))["params"]
  flat = {"/".join(str(k.key) for k in path): leaf.shape
          for path, leaf in jax.tree_util.tree_leaves_with_path(shapes)}
  port = T.build_transform(dict(SYN_CFG), 16)
  assert flat == {k.replace(".", "/"): tuple(v.shape) for k, v in port.state_dict().items()}


@pytest.mark.parametrize("batch,hw", [(1, (3, 4)), (2, (2, 3)), (4, (2, 2))])
def test_two_layer_res_synthesis_fused_matches_flax_fused_and_port_unfused(batch, hw):
  """batch 4 takes the JAX grouped-tap branch, which the port computes densely."""
  z = rand(np.random.default_rng(batch), (batch,) + hw + (16,))
  port = T.build_transform(dict(SYN_CFG), 16)
  ref, out, flat = _pair(jT.build_transform(dict(SYN_CFG)), port, z)
  assert out.shape == (batch, 16 * hw[0], 16 * hw[1], 3)
  np.testing.assert_allclose(out, ref, atol=ATOL)
  unfused = T.build_transform(dict(SYN_CFG), 16, fused=False)
  params_lib.load_params(unfused, flat)
  with torch.no_grad():
    np.testing.assert_allclose(to_numpy(unfused(to_torch(z))), out, atol=ATOL)


def test_two_layer_res_synthesis_unfused_matches_flax_unfused():
  z = rand(np.random.default_rng(11), (1, 2, 3, 16))
  ref, out, _ = _pair(jT.build_transform(dict(SYN_CFG), fused=False),
                      T.build_transform(dict(SYN_CFG), 16, fused=False), z)
  np.testing.assert_allclose(out, ref, atol=ATOL)


def test_fused_synthesis_gradients_match_unfused():
  z = rand(np.random.default_rng(12), (3, 2, 2, 16))
  grads = []
  for fused in (True, False):
    port = T.build_transform(dict(SYN_CFG), 16, fused=fused)
    params_lib.load_params(port, perturbed_init(port, 0))
    zt = to_torch(z).requires_grad_(True)
    port(zt).square().sum().backward()
    grads.append([zt.grad] + [p.grad for p in port.parameters()])
  for a, b in zip(*grads):
    torch.testing.assert_close(a, b, atol=1e-3, rtol=1e-4)


@pytest.mark.parametrize("cls,in_c,b,hw", [
    ("HyperAnalysis", 16, 8, (8, 12)), ("HyperSynthesis", 8, 16, (2, 3))])
def test_hyper_transforms_match_flax(cls, in_c, b, hw):
  x = rand(np.random.default_rng(in_c), (1,) + hw + (in_c,))
  cfg = dict(cls=cls, bottleneck_size=b)
  ref, out, _ = _pair(jT.build_transform(dict(cfg)), T.build_transform(dict(cfg), in_c), x)
  np.testing.assert_allclose(out, ref, atol=ATOL)


@pytest.mark.parametrize("channels", [(8, 8, 8, 16), (8, 8, 16)])
def test_elic_analysis_matches_flax(channels):
  x = rand(np.random.default_rng(len(channels)), (1, 32, 48, 3), 0.3)
  n = len(channels)
  ref, out, _ = _pair(
      jax_elic.ElicAnalysis(channels=channels, kernel_sizes=(5,) * n, strides=(2,) * n),
      elic.ElicAnalysis(3, channels, (5,) * n, (2,) * n), x)
  np.testing.assert_allclose(out, ref, atol=ATOL)


def test_simple_attention_matches_flax():
  x = rand(np.random.default_rng(13), (2, 5, 6, 8))
  ref, out, _ = _pair(jax_elic.SimpleAttention(), elic.SimpleAttention(8), x)
  np.testing.assert_allclose(out, ref, atol=ATOL)
