"""The port's profiling utilities (shallow_ntc_tpu_torch/utils/profiling.py)
on the CPU: model FLOPs counted from the shapes, with_timing and trace.

Each counted layer's FLOPs equal XLA's count (HloCostAnalysis, through
jax.jit(...).lower().compile().cost_analysis()) of the same single plain
JAX op, at two odd sizes, to rtol 1e-6: lax.conv_general_dilated with SAME
padding, and the transposed conv as lhs_dilation (as lax.conv_transpose
pads it). GDN counts its 1x1 conv of |x|^alpha with gamma, equal to XLA's
count of that einsum; XLA's count of the whole JAX GDN exceeds it by the
elementwise ops alone: between 0 and 4 FLOPs per element of x and 4 per
element of gamma and beta. The kernel wrappers declare the FLOPs of a call
from its shapes, equal to XLA's count of the plain op they compute. The
13 rows of results/flops_audit.csv (XLA's count at 512x768, the JAX
package's scripts/get_flops.py) come out with their params exact and
their FLOPs within 2% (measured: within 0.32%, the elementwise ops XLA
also counts). A model counts the same on every route.
"""

import importlib.util
import math
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F
import torch.utils.flop_counter
from jax import lax

from shallow_ntc_tpu.models import transforms as jax_transforms
from shallow_ntc_tpu_torch import configs, eval_lib
from shallow_ntc_tpu_torch.models import elic
from shallow_ntc_tpu_torch.models import transforms as T
from shallow_ntc_tpu_torch.ops import int8ops
from shallow_ntc_tpu_torch.ops import jpegl_decode
from shallow_ntc_tpu_torch.ops import rb_chain
from shallow_ntc_tpu_torch.ops import resblock
from shallow_ntc_tpu_torch.ops import twolayer_final
from shallow_ntc_tpu_torch.utils import profiling

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GATES = ("SNTC_INT8_DECODE", "SNTC_INT8_ENCODE", "SNTC_FUSED_RB_CHAIN", "SNTC_FUSED_RESBLOCK")
SIZES = ((7, 9), (11, 5))
DN = ("NHWC", "HWIO", "NHWC")


@pytest.fixture(autouse=True)
def _no_gates(monkeypatch):
  for name in GATES:
    monkeypatch.delenv(name, raising=False)


def _xla_flops(fn, *args) -> float:
  return float(jax.jit(fn).lower(*args).compile().cost_analysis()["flops"])


def _xla_conv(x, w, s):
  return lax.conv_general_dilated(x, w, (s, s), "SAME", dimension_numbers=DN)


def _xla_deconv(x, w, s):
  """The SAME transposed conv as a stride-1 conv of the s-dilated input,
  padded as lax.conv_transpose pads SAME."""
  k = w.shape[0]
  lo = k - 1 if s > k - 1 else math.ceil((k + s - 2) / 2)
  return lax.conv_general_dilated(x, w, (1, 1), [(lo, k + s - 2 - lo)] * 2,
                                  lhs_dilation=(s, s), dimension_numbers=DN)


def _zeros(shape):
  return torch.zeros(shape)


@pytest.mark.parametrize("hw", SIZES)
@pytest.mark.parametrize("k,s", [(1, 1), (3, 1), (5, 1), (5, 2), (9, 4)])
def test_conv_equals_xla(hw, k, s):
  shape, c_out = (2, *hw, 3), 4
  layer = T.Conv(3, c_out, k, s)
  xla = _xla_flops(lambda x, w: _xla_conv(x, w, s), jnp.zeros(shape), jnp.zeros((k, k, 3, c_out)))
  assert layer.flops(shape) == pytest.approx(xla, rel=1e-6)
  assert profiling.get_flops(layer, _zeros(shape)) == layer.flops(shape)


@pytest.mark.parametrize("hw", SIZES)
@pytest.mark.parametrize("k,s", [(3, 1), (5, 2), (6, 4), (9, 4), (13, 8), (16, 16), (18, 16)])
def test_transposed_conv_equals_xla(hw, k, s):
  shape, c_out = (2, *hw, 3), 4
  layer = T.FastConvTranspose(3, c_out, k, s)
  x, w = jnp.zeros(shape), jnp.zeros((k, k, 3, c_out))
  xla = _xla_flops(lambda x, w: _xla_deconv(x, w, s), x, w)
  assert xla == _xla_flops(
      lambda x, w: lax.conv_transpose(x, w, (s, s), "SAME", dimension_numbers=DN), x, w)
  assert layer.flops(shape) == pytest.approx(xla, rel=1e-6)
  assert profiling.get_flops(layer, _zeros(shape)) == layer.flops(shape)


@pytest.mark.parametrize("hw", SIZES)
@pytest.mark.parametrize("c,alpha,epsilon,inverse", [(12, 1.0, 1.0, True), (12, 2.0, 0.5, False),
                                                     (40, 1.0, 1.0, False)])
def test_gdn_counts_its_1x1_conv_as_xla(hw, c, alpha, epsilon, inverse):
  shape = (2, *hw, c)
  layer = T.GDN(c, inverse=inverse, alpha=alpha, epsilon=epsilon)
  counted = profiling.get_flops(layer, _zeros(shape))
  conv = _xla_flops(lambda p, g: jnp.einsum("...j,jc->...c", p, g), jnp.zeros(shape),
                    jnp.zeros((c, c)))
  assert counted == pytest.approx(conv, rel=1e-6)
  jax_gdn = jax_transforms.GDN(inverse=inverse, alpha=alpha, epsilon=epsilon)
  variables = jax_gdn.init(jax.random.PRNGKey(0), jnp.zeros(shape))
  whole = _xla_flops(lambda v, x: jax_gdn.apply(v, x), variables, jnp.zeros(shape))
  assert 0 <= whole - counted <= 4 * math.prod(shape) + 4 * (c * c + c)


@pytest.mark.parametrize("name", ["relu", "gelu", "prelu"])
def test_elementwise_activations_count_nothing(name):
  layer = T.make_activation(name, 5)
  assert profiling.get_flops(layer, _zeros((1, 4, 6, 5))) == 0


@pytest.mark.parametrize("hw", SIZES)
def test_final_deconv_flops_equal_xla(hw):
  """final_deconv_phase: the k5s2 transposed conv of the d2s(8) mid tensor."""
  b, c_in, c_out, k = 2, 12, 3, 5
  mid_shape, kernel_shape = (b, *hw, 64 * c_in), (k, k, c_in, c_out)
  xla = _xla_flops(lambda x, w: _xla_deconv(x, w, 2), jnp.zeros((b, 8 * hw[0], 8 * hw[1], c_in)),
                   jnp.zeros(kernel_shape))
  declared = twolayer_final.flops(mid_shape, kernel_shape)
  assert declared == pytest.approx(xla, rel=1e-6)
  call = profiling.get_flops(twolayer_final.final_deconv_phase, _zeros(mid_shape),
                             _zeros(kernel_shape), _zeros((c_out,)), c_in)
  assert call == declared


@pytest.mark.parametrize("hw", SIZES)
@pytest.mark.parametrize("n", [1, 3])
def test_rb_chain_flops_equal_xla(hw, n):
  """fused_rb_chain / fused_resblock: per block a 1x1, a 3x3 SAME and a 1x1 conv."""
  c, ch = 16, 8
  shape = (2, *hw, c)

  one = _xla_flops(lambda x, *w: _xla_conv(_xla_conv(_xla_conv(x, w[0], 1), w[1], 1), w[2], 1),
                   jnp.zeros(shape), jnp.zeros((1, 1, c, ch)), jnp.zeros((3, 3, ch, ch)),
                   jnp.zeros((1, 1, ch, c)))
  declared = rb_chain.flops(shape, ch, n)
  assert declared == pytest.approx(n * one, rel=1e-6)
  params = [(torch.zeros(c, ch), torch.zeros(ch), torch.zeros(3, 3, ch, ch), torch.zeros(ch),
             torch.zeros(ch, c), torch.zeros(c))] * n
  assert profiling.get_flops(rb_chain.fused_rb_chain, _zeros(shape), params) == declared
  assert profiling.get_flops(resblock.fused_resblock, _zeros(shape), *params[0]) == declared / n
  assert profiling.get_flops(elic.ResidualBlock(c), _zeros(shape)) == declared / n


@pytest.mark.parametrize("hw", SIZES)
def test_jpegl_flops_equal_xla(hw):
  """jpegl_synthesize: the k == s transposed conv."""
  shape, kernel_shape = (2, *hw, 33), (16, 16, 33, 3)
  xla = _xla_flops(lambda x, w: _xla_deconv(x, w, 16), jnp.zeros(shape), jnp.zeros(kernel_shape))
  declared = jpegl_decode.flops(shape, kernel_shape)
  assert declared == pytest.approx(xla, rel=1e-6)
  assert profiling.get_flops(jpegl_decode.jpegl_synthesize, _zeros(shape),
                             _zeros(kernel_shape), _zeros((3,))) == declared


def _load_script():
  spec = importlib.util.spec_from_file_location(
      "torch_get_flops", os.path.join(REPO, "scripts", "torch_get_flops.py"))
  mod = importlib.util.module_from_spec(spec)
  spec.loader.exec_module(mod)
  return mod


def _audit():
  """results/flops_audit.csv's rows: {name: (FLOPs per pixel, params)} (the
  names hold unquoted commas)."""
  with open(os.path.join(REPO, "results", "flops_audit.csv")) as f:
    rows = [line.strip().rsplit(",", 2) for line in f if line.strip()]
  assert rows[0] == ["transform", "flops_per_pixel", "params"]
  return {name: (float(fpp), int(params)) for name, fpp, params in rows[1:]}


AUDIT = _audit()


@pytest.mark.parametrize("name", list(AUDIT))
def test_flops_audit_row(name):
  """One row of results/flops_audit.csv at its 512x768: params exact, FLOPs
  per pixel within 2%."""
  ((row_name, fpp, n_params),) = _load_script().rows(512, 768, torch.device("cpu"), [name])
  assert row_name == name
  assert n_params == AUDIT[name][1]
  assert fpp == pytest.approx(AUDIT[name][0], rel=2e-2)


def test_get_flops_script_prints_the_table():
  proc = subprocess.run([sys.executable, os.path.join(REPO, "scripts", "torch_get_flops.py"),
                         "--device", "cpu", "--height", "64", "--width", "128"],
                        capture_output=True, text=True, timeout=300, cwd=REPO)
  assert proc.returncode == 0, proc.stderr
  lines = proc.stdout.strip().splitlines()
  assert lines[0] == "transform,flops_per_pixel,params"
  assert [ln.rsplit(",", 2)[0] for ln in lines[1:]] == list(AUDIT)
  assert all(float(ln.rsplit(",", 2)[1]) > 0 for ln in lines[1:])


def _eval_flops(name, dtype=torch.float32, hw=(64, 96)):
  cfg, _, family = configs.eval_config(name)
  model = eval_lib.build_model(cfg, init_seed=0, device="cpu", family=family).to(dtype)
  img = np.random.default_rng(0).uniform(-0.5, 0.5, (1, *hw, 3)).astype(np.float32)
  return model, profiling.get_flops(lambda: list(eval_lib.evaluate_images(model, img)))


def test_flagship_eval_counts_the_same_on_every_route(monkeypatch):
  """The flagship's eval: the residual blocks as cuDNN convs, the chain
  kernel's and the block kernel's plain versions, the int8 encode; the
  synthesis fused and unfused, int8; and a decode in bf16 as in float32."""
  model, base = _eval_flops("two_layer_syn_rd")
  assert base > 0
  img = np.zeros((1, 64, 96, 3), np.float32)

  def count():
    return profiling.get_flops(lambda: list(eval_lib.evaluate_images(model, img)))

  for gate in ("SNTC_FUSED_RB_CHAIN", "SNTC_FUSED_RESBLOCK", "SNTC_INT8_ENCODE"):
    with monkeypatch.context() as m:
      m.setenv(gate, "1")
      assert count() == base, gate
  with int8ops.decode_mode("all"):
    assert count() == base
  model._synthesis.fused = False
  assert count() == base
  model._synthesis.fused = True
  y = torch.zeros(2, 4, 6, 320)
  syn = profiling.get_flops(model.synthesize, y)
  assert syn == profiling.get_flops(model.to(torch.bfloat16).synthesize, y.bfloat16())
  assert syn == model._synthesis.flops(tuple(y.shape))


@pytest.mark.parametrize("name", configs.EVAL_CONFIG_NAMES)
def test_decode_counts_the_same_in_bf16_and_chain_on(name, monkeypatch):
  """Each eval config's decode (hyper-synthesis and synthesis; the
  factorized family's synthesis) counts the same in float32 and bfloat16,
  and its eval the same with the chain on and off."""
  model, off = _eval_flops(name)
  monkeypatch.setenv("SNTC_FUSED_RB_CHAIN", "1")
  assert _eval_flops(name)[1] == off
  img = torch.zeros(1, 64, 96, 3)
  with torch.no_grad():
    latents = [torch.round(rv.loc) for rv in model.infer_latent_rvs(img).uq]

  def decode(m, *lat):
    if len(lat) == 1:
      return m.synthesize(lat[0])
    return m.hyper_synthesize(lat[0]), m.synthesize(lat[1])

  f32 = profiling.get_flops(decode, model, *latents)
  bf16 = profiling.get_flops(decode, model.to(torch.bfloat16), *(t.bfloat16() for t in latents))
  assert f32 == bf16 > 0


def test_elic_analysis_chain_on_and_off(monkeypatch):
  layer = T.build_transform(dict(cls="ElicAnalysis", channels=(16, 16, 16, 24)), 3)
  x = torch.zeros(1, 48, 80, 3)
  off = profiling.get_flops(layer, x)
  monkeypatch.setenv("SNTC_FUSED_RB_CHAIN", "1")
  assert profiling.get_flops(layer, x) == off
  monkeypatch.setenv("SNTC_FUSED_RB_CHAIN", "0")
  monkeypatch.setenv("SNTC_FUSED_RESBLOCK", "1")
  assert profiling.get_flops(layer, x) == off


@pytest.mark.parametrize("cfg", [dict(cls="TwoLayerResSynthesis", channels=(12, 3)),
                                 dict(cls="TwoLayerResSynthesis", channels=(12, 3), fused=False),
                                 dict(cls="TwoLayerResSynthesis", channels=(12, 3),
                                      res_type="d2s"),
                                 dict(cls="TwoLayerSynthesis", channels=(24, 3), fused=False),
                                 dict(cls="TwoLayerSynthesis", channels=(8, 3),
                                      activation_type="prelu")])
def test_two_layer_flops_are_their_layers_at_the_shapes_they_see(cfg):
  """A two-layer synthesis declares the sum of its layers' FLOPs at the
  shapes its unfused forward gives them (the d2s residual's too)."""
  layer = T.build_transform(dict(cfg, fused=False), 64)
  z = torch.zeros(1, 3, 5, 64)
  seen = []
  hooks = [m.register_forward_pre_hook(lambda mod, args: seen.append(
      mod.flops(tuple(args[0].shape)))) for m in layer.children() if hasattr(m, "flops")]
  with torch.no_grad():
    layer(z)
  for h in hooks:
    h.remove()
  fused = T.build_transform(cfg, 64)
  assert sum(seen) == layer.flops(tuple(z.shape)) == profiling.get_flops(fused, z) > 0


def test_jpegl_k16_kernel_route_counts_as_the_conv():
  layer = T.JPEGLikeSynthesis(320, kernel_size=16, strides=16, use_pallas=True)
  z = torch.zeros(1, 4, 6, 320)
  assert layer.kernel_route
  routed = profiling.get_flops(layer, z)
  layer.kernel_route = False
  assert profiling.get_flops(layer, z) == routed == layer.conv.flops(tuple(z.shape))


def test_aten_ops_outside_layers_count_as_flop_counter_mode():
  """2 m k n for a matmul (tests/test_lpips_profiling.py's JAX test), and
  mm / bmm / addmm / convolution as torch.utils.flop_counter counts them."""
  a, b = torch.zeros(64, 128), torch.zeros(128, 32)
  assert profiling.get_flops(lambda x, y: x @ y, a, b) == 2 * 64 * 128 * 32

  def fn(x, w, v, t, u):
    h = F.conv2d(x, w, padding=1)
    h = F.conv_transpose2d(h, t, stride=2)
    return torch.bmm(v, v.transpose(1, 2)).sum() + F.linear(u, u).sum() + h.sum()

  args = (torch.zeros(2, 3, 9, 7), torch.zeros(5, 3, 3, 3), torch.zeros(4, 6, 8),
          torch.zeros(5, 2, 4, 4), torch.zeros(3, 10))
  with torch.utils.flop_counter.FlopCounterMode(display=False) as mode:
    fn(*args)
  assert profiling.get_flops(fn, *args) == mode.get_total_flops() > 0


def test_get_flops_leaves_no_hooks_and_does_not_nest():
  layer = T.Conv(3, 4, 3, 1)
  x = torch.zeros(1, 5, 5, 3)

  def fails():
    layer(x)
    raise RuntimeError("boom")

  with pytest.raises(RuntimeError, match="boom"):
    profiling.get_flops(fails)
  with pytest.raises(RuntimeError, match="already counting"):
    profiling.get_flops(lambda: profiling.get_flops(layer, x))
  assert profiling.get_flops(layer, x) == layer.flops(x.shape)


def test_with_timing():
  out, seconds = profiling.with_timing(lambda x: x * 2)(torch.ones(8, 8))
  assert seconds > 0 and out.shape == (8, 8) and bool((out == 2).all())


def test_trace_writes_a_json_trace(tmp_path):
  layer = T.Conv(3, 4, 3, 1)
  with profiling.trace(str(tmp_path)):
    layer(torch.ones(1, 8, 8, 3))
  traces = [f for f in os.listdir(tmp_path) if f.endswith(".json")]
  assert traces
  with open(tmp_path / traces[0]) as f:
    assert "aten::conv" in f.read()
