"""The port's ELIC residual-block kernels (their plain versions on the CPU)
against the JAX package's Pallas kernels in interpret mode, as
tests/test_pallas.py and tests/test_fast_deconv.py run them."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from shallow_ntc_tpu.models import transforms as jax_transforms
from shallow_ntc_tpu.ops.pallas import rb_chain as jax_rb_chain
from shallow_ntc_tpu.ops.pallas import resblock as jax_resblock
from shallow_ntc_tpu_torch.models import transforms as T
from shallow_ntc_tpu_torch.ops import rb_chain
from shallow_ntc_tpu_torch.ops import resblock
from tests.torch_parity import to_numpy, to_torch


def _chain_params(n, c, seed):
  """As tests/test_pallas.py:TestFusedRBChain._params."""
  rng = np.random.default_rng(seed)
  ch = c // 2
  mk = lambda *shape: rng.normal(0, 0.3, shape).astype(np.float32)  # noqa: E731
  return tuple((mk(c, ch), mk(ch), mk(3, 3, ch, ch), mk(ch), mk(ch, c), mk(c))
               for _ in range(n))


def _torch_params(params, requires_grad=False):
  return [tuple(to_torch(a).requires_grad_(requires_grad) for a in block) for block in params]


@pytest.mark.parametrize("n_blocks", [1, 2, 3])
def test_chain_matches_jax(n_blocks):
  """atol 2e-5, as test_pallas.py:126-136 holds the Pallas chain to the dense one."""
  params = _chain_params(n_blocks, 16, seed=n_blocks)
  x = np.random.default_rng(7).normal(0, 1, (2, 32, 24, 16)).astype(np.float32)
  ref = jax_rb_chain.fused_rb_chain(jnp.asarray(x), params)
  with torch.no_grad():
    out = rb_chain.fused_rb_chain(to_torch(x), _torch_params(params))
  np.testing.assert_allclose(to_numpy(out), np.asarray(ref), rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("n_blocks", [1, 2, 3])
def test_chain_gradients_match_jax(n_blocks):
  """Gradients of x and all 6N weights and biases through both custom VJPs, atol 1e-4."""
  params = _chain_params(n_blocks, 8, seed=10 + n_blocks)
  x = np.random.default_rng(3).normal(0, 1, (1, 16, 12, 8)).astype(np.float32)
  cot = np.random.default_rng(4).normal(0, 1, x.shape).astype(np.float32)
  g_x, g_p = jax.grad(
      lambda xx, pp: jnp.sum(jax_rb_chain.fused_rb_chain(xx, pp) * cot), argnums=(0, 1))(
          jnp.asarray(x), params)
  x_t = to_torch(x).requires_grad_(True)
  p_t = _torch_params(params, requires_grad=True)
  (rb_chain.fused_rb_chain(x_t, p_t) * to_torch(cot)).sum().backward()
  np.testing.assert_allclose(to_numpy(x_t.grad), np.asarray(g_x), atol=1e-4)
  for block_t, block_j in zip(p_t, g_p):
    for t, j in zip(block_t, block_j):
      np.testing.assert_allclose(to_numpy(t.grad), np.asarray(j), atol=1e-4)


@pytest.mark.parametrize("h,w,c", [(16, 12, 8), (8, 6, 4)])
def test_resblock_matches_jax(h, w, c):
  """Value and input gradient, atol 1e-4, as test_fast_deconv.py:136-155."""
  rng = np.random.default_rng(8)
  x = rng.normal(0, 1, (2, h, w, c)).astype(np.float32)
  ws = [rng.normal(0, s, shape).astype(np.float32) for s, shape in (
      (0.2, (c, c // 2)), (0.1, (c // 2,)), (0.2, (3, 3, c // 2, c // 2)), (0.1, (c // 2,)),
      (0.2, (c // 2, c)), (0.1, (c,)))]
  ref = jax_resblock.fused_resblock(jnp.asarray(x), *ws)
  g_ref = jax.grad(lambda xx: jnp.sum(jax_resblock.fused_resblock(xx, *ws)))(jnp.asarray(x))
  x_t = to_torch(x).requires_grad_(True)
  out = resblock.fused_resblock(x_t, *map(to_torch, ws))
  out.sum().backward()
  np.testing.assert_allclose(to_numpy(out), np.asarray(ref), atol=1e-4)
  np.testing.assert_allclose(to_numpy(x_t.grad), np.asarray(g_ref), atol=1e-4)


def _bf16(a):
  """a rounded to bfloat16, as a float32 numpy array."""
  return np.asarray(jnp.asarray(a, jnp.bfloat16).astype(jnp.float32))


@pytest.mark.parametrize("case", [("chain", 1), ("chain", 2), ("chain", 3),
                                  ("block", (16, 12, 8)), ("block", (16, 6, 4))])
def test_bf16_plain_versions_match_jax(case):
  """bfloat16 x and float32 parameters: the port's plain chain and block
  against the Pallas kernels in interpret mode, which round the weights to
  bf16, keep the biases in f32, and round h1, h2 and each residual to bf16.
  Both sides round at the same points, so they differ only where a float32
  sum summed in another order lands across a bf16 rounding boundary:
  atol 2^-8 max|y|, half a bf16 ulp at the largest output. The block runs at
  H=16 since JAX's fused_resblock leaves the kernel for H < 16 (its dense
  fallback refuses bf16 x with f32 weights)."""
  kind, arg = case
  if kind == "chain":
    params = _chain_params(arg, 16, seed=arg)
    x = _bf16(np.random.default_rng(7).normal(0, 1, (2, 32, 24, 16)))
    ref = jax_rb_chain.fused_rb_chain(jnp.asarray(x, jnp.bfloat16), params)
    with torch.no_grad():
      out = rb_chain.fused_rb_chain(to_torch(x).bfloat16(), _torch_params(params))
  else:
    h, w, c = arg
    rng = np.random.default_rng(8)
    x = _bf16(rng.normal(0, 1, (2, h, w, c)))
    ws = [rng.normal(0, s, shape).astype(np.float32) for s, shape in (
        (0.2, (c, c // 2)), (0.1, (c // 2,)), (0.2, (3, 3, c // 2, c // 2)), (0.1, (c // 2,)),
        (0.2, (c // 2, c)), (0.1, (c,)))]
    ref = jax_resblock.fused_resblock(jnp.asarray(x, jnp.bfloat16), *ws)
    with torch.no_grad():
      out = resblock.fused_resblock(to_torch(x).bfloat16(), *map(to_torch, ws))
  assert out.dtype == torch.bfloat16 and ref.dtype == jnp.bfloat16
  ref = np.asarray(ref.astype(jnp.float32))
  np.testing.assert_allclose(to_numpy(out.float()), ref, rtol=0,
                             atol=2.0**-8 * np.abs(ref).max())


@pytest.mark.parametrize("switch", ["SNTC_FUSED_RB_CHAIN", "SNTC_FUSED_RESBLOCK"])
def test_elic_analysis_with_the_kernels_matches_jax(monkeypatch, switch):
  """ElicAnalysis (8, 10, 12, 14), 2 blocks per chain, 64x96, with the switch on
  in both packages, atol 2e-5 (test_pallas.py:160-176). On the CPU the port
  runs the plain versions and counts no launch."""
  cfg = dict(cls="ElicAnalysis", channels=(8, 10, 12, 14), num_residual_blocks=2)
  mod = jax_transforms.build_transform(dict(cfg))
  x = np.random.default_rng(1).normal(0, 0.3, (1, 64, 96, 3)).astype(np.float32)
  params = mod.init(jax.random.PRNGKey(0), jnp.asarray(x))["params"]
  monkeypatch.setenv(switch, "1")
  ref = mod.apply({"params": params}, jnp.asarray(x))
  port = T.build_transform(dict(cfg), 3)
  with torch.no_grad():
    for path, leaf in jax.tree_util.tree_leaves_with_path(params):
      port.get_parameter(".".join(str(k.key) for k in path)).copy_(to_torch(leaf))
  counts = (rb_chain.STATS.launches, resblock.STATS.launches)
  with torch.no_grad():
    out = port(to_torch(x))
  np.testing.assert_allclose(to_numpy(out), np.asarray(ref), rtol=2e-5, atol=2e-5)
  assert (rb_chain.STATS.launches, resblock.STATS.launches) == counts


def test_cuda_entries_refuse_a_cpu_tensor():
  (block,) = _torch_params(_chain_params(1, 8, seed=0))
  x = torch.zeros(1, 4, 4, 8)
  with pytest.raises(ValueError, match="CUDA tensor"):
    rb_chain.rb_chain_cuda(x, [block])
  with pytest.raises(ValueError, match="CUDA tensor"):
    resblock.fused_resblock_cuda(x, *block)
  with pytest.raises(ValueError, match="non-empty sequence"):
    rb_chain.fused_rb_chain(x, [])


def test_plain_chain_is_the_blocks_in_turn():
  """dense_rb_chain is dense_resblock applied block by block, and each block
  equals the port's unfused ResidualBlock module on the same weights."""
  from shallow_ntc_tpu_torch.models.elic import ResidualBlock

  params = _torch_params(_chain_params(2, 12, seed=5))
  x = to_torch(np.random.default_rng(2).normal(0, 1, (2, 5, 7, 12)))
  with torch.no_grad():
    y = rb_chain.dense_rb_chain(x, params)
    z = x
    for w1, b1, w2, b2, w3, b3 in params:
      block = ResidualBlock(12)
      block.Conv_0.kernel.copy_(w1[None, None])
      block.Conv_0.bias.copy_(b1)
      block.Conv_1.kernel.copy_(w2)
      block.Conv_1.bias.copy_(b2)
      block.Conv_2.kernel.copy_(w3[None, None])
      block.Conv_2.bias.copy_(b3)
      z = block(z)
  torch.testing.assert_close(y, z, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("c", [16, 20, 192, 320, 33])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_packed_weights_hold_the_dense_weights(c, dtype):
  """Read back through the kernel's addressing (csrc/rb_chain.cu): w1 (k, n)
  at row k; w2 (tap, k, n) at row s1 SLAB_K + tap ch8 + k; w3 (k, n) at row
  (s1 + s2 + pass s3) SLAB_K + k, column n - pass 32 RN. Every weight is
  found rounded to dtype, with 0 error, and every other entry is 0."""
  ch = c // 2
  rng = np.random.default_rng(c)
  w1, w2, w3 = (torch.from_numpy(rng.standard_normal(s).astype(np.float32))
                for s in ((c, ch), (3, 3, ch, ch), (ch, c)))
  packed = rb_chain.pack_weights(w1, w2, w3, dtype)
  ldn, s1, s2, passes, s3 = rb_chain.slab_layout(c, ch)
  width, ch8, k = ldn - 8, 8 * -(-ch // 8), rb_chain.SLAB_K
  assert ldn % 32 == 8 and width >= ch and packed.dtype == torch.float32
  assert packed.shape == ((s1 + s2 + passes * s3) * k, ldn)
  seen = torch.zeros_like(packed, dtype=torch.bool)

  def read(rows, cols, dense):
    got = packed[rows[:, None], cols[None, :]]
    seen[rows[:, None], cols[None, :]] = True
    torch.testing.assert_close(got, dense.to(dtype).float(), rtol=0, atol=0)

  read(torch.arange(c), torch.arange(ch), w1)
  for tap in range(9):
    read(s1 * k + tap * ch8 + torch.arange(ch), torch.arange(ch), w2.reshape(9, ch, ch)[tap])
  for p in range(passes):
    cols = torch.arange(p * width, min(c, (p + 1) * width))
    read((s1 + s2 + p * s3) * k + torch.arange(ch), cols - p * width, w3[:, cols])
  assert not packed[~seen].any()
