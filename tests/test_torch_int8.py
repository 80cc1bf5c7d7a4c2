"""The port's int8 inference path (ops/int8ops.py and its hooks) against the
JAX package's on the CPU.

The JAX side runs under jit, as every JAX path that quantizes does (eval,
codec, bench), so its scales are absmax times float32(1/127), XLA's rewrite
of the division by 127 (ops/int8ops.py). The quantizers, conv_s1_int8 and
the phase convs without a bias are held bit for bit (atol 0, in float32 and
bfloat16). With a bias, XLA fuses the float32 rescale and the bias add into
one rounding, where the port rounds twice: those outputs are held within
2**-22 * max|out| (one float32 ulp of the largest output). Model evals are
held as the float ones are, at rtol 1e-4 on bpp and PSNR.
"""

import copy
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from shallow_ntc_tpu.ops import fast_deconv as jax_fd
from shallow_ntc_tpu.ops import int8ops as jax_int8
from shallow_ntc_tpu_torch import compress as compress_cli
from shallow_ntc_tpu_torch import eval as eval_cli
from shallow_ntc_tpu_torch import eval_lib
from shallow_ntc_tpu_torch import itinf as itinf_cli
from shallow_ntc_tpu_torch import params as params_lib
from shallow_ntc_tpu_torch import train as train_cli
from shallow_ntc_tpu_torch.codec import api
from shallow_ntc_tpu_torch.models import transforms as T
from shallow_ntc_tpu_torch.ops import fast_deconv as fd
from shallow_ntc_tpu_torch.ops import int8ops
from tests.test_torch_factorized import SMALL as SMALL_FACTORIZED
from tests.torch_parity import SMALL_CONFIG, images, jax_eval, models, rand, to_torch

# The narrow flagship with a 32-channel last ELIC stage, so that the encode
# gate (C_in >= 32) reaches an attention's residual blocks and 1x1, and the
# hyper-analysis's stride-1 conv.
INT8_CONFIG = copy.deepcopy(SMALL_CONFIG)
INT8_CONFIG["transform_config"]["analysis"]["channels"] = (8, 8, 8, 32)
GATES = ("SNTC_INT8_DECODE", "SNTC_INT8_ENCODE", "SNTC_FUSED_RB_CHAIN", "SNTC_FUSED_RESBLOCK")


@pytest.fixture(autouse=True)
def _no_gates(monkeypatch):
  """Every test starts with the gates off, whatever the environment says."""
  for name in GATES:
    monkeypatch.delenv(name, raising=False)


def _np(x) -> np.ndarray:
  return np.asarray(x.float() if isinstance(x, torch.Tensor) else x.astype(jnp.float32))


DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _both(a: np.ndarray, dtype: str):
  jd, td = DTYPES[dtype]
  return jnp.asarray(a).astype(jd), torch.from_numpy(a).to(td)


# --- the quantizers and the product ----------------------------------------------
@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("name", ["quantize_act_per_channel", "quantize_act_per_tensor",
                                  "quantize_weight_per_cout"])
def test_quantizers_equal_jax_bit_for_bit(name, dtype):
  """Per-channel ranges over three decades, an all-zero channel (the 1e-12
  floor) and values on the .5 rounding boundary (half to even)."""
  rng = np.random.default_rng(len(name))
  x = rand(rng, (2, 5, 7, 24)) * np.logspace(-2, 1, 24, dtype=np.float32)
  x[..., 3] = 0.0
  x[0, 0, 0, :] = 127.0 * np.abs(x).max(axis=(0, 1, 2))  # pins the scales
  x[0, 0, 1, :] = 2.5 * np.abs(x).max(axis=(0, 1, 2)) / 127.0
  jx, tx = _both(x, dtype)
  q_j, s_j = jax.jit(getattr(jax_int8, name))(jx)
  q_t, s_t = getattr(int8ops, name)(tx)
  assert q_t.dtype == torch.int8 and s_t.dtype == torch.float32
  np.testing.assert_array_equal(q_t.numpy(), np.asarray(q_j))
  np.testing.assert_array_equal(s_t.numpy(), np.asarray(s_j))


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("k,pads,c_in,c_out", [(1, (0, 0), 40, 24), (3, (1, 1), 24, 40),
                                              (3, (0, 2), 5, 3), (5, (2, 2), 13, 17)])
def test_conv_s1_int8_equals_jax(k, pads, c_in, c_out, dtype):
  """Kernels and pads of the phase convs and the encode gate, channel counts
  that are no multiple of 8 (the GEMM's zero padding) and a product of 9
  rows (M < 17)."""
  rng = np.random.default_rng(k * 100 + c_in)
  x = rand(rng, (1, 3, 3, c_in)) * np.linspace(0.1, 3.0, c_in, dtype=np.float32)
  w = rand(rng, (k, k, c_in, c_out), 0.1)
  jx, tx = _both(x, dtype)
  jw, tw = _both(w, dtype)
  ref = jax.jit(lambda a, b: jax_int8.conv_s1_int8(
      a, b, [pads, pads], ("NHWC", "HWIO", "NHWC"), a.dtype))(jx, jw)
  out = int8ops.conv_s1_int8(tx, tw, pads[0], pads[1], tx.dtype)
  assert out.dtype == tx.dtype and out.shape == ref.shape
  np.testing.assert_array_equal(_np(out), _np(ref))


def test_int8_matmul_is_exact_at_padded_shapes():
  """int32 products against int64 at shapes that break _int_mm's CUDA rules."""
  rng = np.random.default_rng(0)
  for m, k, n in ((1, 3, 5), (16, 8, 8), (17, 20, 12), (40, 64, 16)):
    a = torch.from_numpy(rng.integers(-127, 128, (m, k)).astype(np.int8))
    b = torch.from_numpy(rng.integers(-127, 128, (n, k)).astype(np.int8))
    out = int8ops.int8_matmul(a, b)
    assert out.dtype == torch.int32 and out.shape == (m, n)
    np.testing.assert_array_equal(out.numpy(), a.numpy().astype(np.int64) @ b.numpy().T)


# --- the funnel --------------------------------------------------------------------
# (k, s, B, C_in, C_out): the flagship's k13s8 at B=1 and B=4 (JAX's grouped
# pieces at B >= 4), k5s2 (exact grouped pieces in JAX's fast_conv_transpose),
# the hyper-decoder's k3s1, jpegl_rd's k18s16, the JPEG-like hyper k6s4.
DECONVS = [(13, 8, 1, 16, 12), (13, 8, 4, 16, 12), (5, 2, 2, 24, 8), (3, 1, 2, 40, 16),
           (18, 16, 2, 17, 3), (6, 4, 1, 8, 16)]


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("k,s,b,c_in,c_out", DECONVS)
def test_fast_conv_transpose_int8_equals_jax(k, s, b, c_in, c_out, dtype):
  """fast_conv_transpose with the gate on: JAX's phase kernel quantized per
  (phase, c_out), whether JAX takes the dense phase conv or the grouped
  pieces; and the phase conv itself against JAX's dense and grouped ones.
  Bit for bit without a bias; with one, within a float32 ulp (see above)."""
  rng = np.random.default_rng(k * 10 + b)
  jz, tz = _both(rand(rng, (b, 3, 5, c_in)), dtype)
  jw, tw = _both(rand(rng, (k, k, c_in, c_out), 0.1), dtype)
  bias = rand(rng, (c_out,), 0.1)

  @jax.jit
  def ref_fn(z, w, bias):
    with jax_int8.force(True):
      return (jax_fd.fast_conv_transpose(z, w, bias, s), jax_fd.phase_conv(z, w, bias, s),
              jax_fd.grouped_phase_conv(z, w, bias, s))

  for b_j, b_t in ((None, None), (jnp.asarray(bias), torch.from_numpy(bias))):
    refs = [_np(r) for r in ref_fn(jz, jw, b_j)]
    with int8ops.force(True):
      out = _np(fd.fast_conv_transpose(tz, tw, b_t, s))
      out_p = _np(fd.phase_conv(tz, tw, b_t, s))
    atol = 0 if b_j is None or dtype == "bfloat16" else 2**-22 * np.abs(refs[0]).max()
    for got, ref in ((out, refs[0]), (out_p, refs[1]), (out_p, refs[2])):
      np.testing.assert_allclose(got, ref, rtol=0, atol=atol)
  # The gate did quantize: within ~1% of the float result, not equal to it.
  flt = fd.fast_conv_transpose(tz.float(), tw.float(), torch.from_numpy(bias), s)
  err = np.abs(out - _np(flt)).max() / np.abs(_np(flt)).max()
  assert 0 < err < 0.03


def test_packed_conv_and_final_stage_stay_float(monkeypatch):
  """packed_conv_transpose and final_deconv_phase are outside the funnel in
  both packages: no int8 product under the gate."""
  calls = []
  monkeypatch.setattr(int8ops, "conv_s1_int8", lambda *a: calls.append(a) or 1 / 0)
  rng = np.random.default_rng(0)
  x_p = to_torch(rand(rng, (1, 2, 3, 4 * 12)))
  kern, bias = to_torch(rand(rng, (5, 5, 12, 3))), to_torch(rand(rng, (3,)))
  ref = fd.packed_conv_transpose(x_p, kern, bias, 2, 2)
  mid = to_torch(rand(rng, (1, 2, 3, 64 * 12)))
  k2 = to_torch(rand(rng, (5, 5, 12, 3)))
  ref_f = T.final_deconv_phase(mid, k2, bias, 12)
  with int8ops.force(True):
    torch.testing.assert_close(fd.packed_conv_transpose(x_p, kern, bias, 2, 2), ref,
                               rtol=0, atol=0)
    torch.testing.assert_close(T.final_deconv_phase(mid, k2, bias, 12), ref_f, rtol=0, atol=0)
  assert not calls


# --- the models ----------------------------------------------------------------------
@pytest.fixture(scope="module")
def int8_models():
  return models(INT8_CONFIG, seed=3)


ARMS = {"f32": {}, "syn": {"SNTC_INT8_DECODE": "syn"}, "all": {"SNTC_INT8_DECODE": "all"},
        "enc": {"SNTC_INT8_ENCODE": "1"}}


def _port_eval(port, x):
  with torch.no_grad():
    _, m, rec = port.end_to_end_frame_loss(to_torch(x), training=False)
  return {k: float(v) for k, v in m.items()}, rec.numpy()


@pytest.mark.parametrize("arm", sorted(ARMS))
def test_flagship_int8_arms_match_jax(int8_models, arm, monkeypatch):
  """The narrow flagship in each arm of scripts/int8_quality.py, gates set
  through the environment both packages read: bpp and PSNR within rtol 1e-4
  of JAX's; 'syn' keeps the float rate bit for bit and moves the
  reconstruction, 'all' and 'enc' move the rate."""
  jax_model, params, port = int8_models
  x = images(7, (64, 128))
  f32, rec_f32 = _port_eval(port, x)
  for name, value in ARMS[arm].items():
    monkeypatch.setenv(name, value)
  ours, rec = _port_eval(port, x)
  _, m_j, _ = jax_eval(jax_model, params, x)
  for key in ("bpp", "latent_bpp", "hyper_latent_bpp", "psnr", "rd_loss"):
    np.testing.assert_allclose(ours[key], float(m_j[key]), rtol=1e-4, err_msg=key)
  if arm == "f32":
    return
  assert not np.array_equal(rec, rec_f32)
  if arm == "syn":
    assert ours["bpp"] == f32["bpp"] and ours["latent_bpp"] == f32["latent_bpp"]
  else:
    assert ours["latent_bpp"] != f32["latent_bpp"]


def test_syn_mode_keeps_the_hyper_decoder_float(int8_models, monkeypatch):
  """mu and the scale indexes: bit-equal to float in 'syn', moved in 'all'."""
  _, _, port = int8_models
  z_hat = to_torch(np.round(rand(np.random.default_rng(1), (2, 1, 2, 32), 3.0)))
  with torch.no_grad():
    ref = port.hyper_synthesize(z_hat)
    with int8ops.decode_mode("syn"):
      syn = port.hyper_synthesize(z_hat)
    with int8ops.decode_mode("all"):
      all_ = port.hyper_synthesize(z_hat)
  for a, b in zip(syn, ref):
    torch.testing.assert_close(a, b, rtol=0, atol=0)
  assert not torch.equal(all_[0], ref[0])


def test_factorized_synthesis_goes_int8_in_syn_mode(monkeypatch):
  """The factorized family has no hyper-decoder: 'syn' quantizes its whole
  synthesis, as in JAX; the rate (y's prior alone) does not move."""
  jax_model, params, port = models(SMALL_FACTORIZED, seed=2, family="factorized")
  x = images(4, (48, 80))
  f32, rec_f32 = _port_eval(port, x)
  monkeypatch.setenv("SNTC_INT8_DECODE", "syn")
  ours, rec = _port_eval(port, x)
  _, m_j, _ = jax_eval(jax_model, params, x)
  for key in ("bpp", "psnr", "rd_loss"):
    np.testing.assert_allclose(ours[key], float(m_j[key]), rtol=1e-4, err_msg=key)
  assert ours["bpp"] == f32["bpp"] and not np.array_equal(rec, rec_f32)


@pytest.mark.parametrize("route,int8_convs", [(None, 8), ("SNTC_FUSED_RB_CHAIN", 2),
                                             ("SNTC_FUSED_RESBLOCK", 2)])
def test_residual_block_kernels_take_precedence_over_the_encode_gate(
    int8_models, route, int8_convs, monkeypatch):
  """With SNTC_INT8_ENCODE=1 the int8 convs of an analysis are the 32-channel
  stage's: 6 residual blocks' first 1x1, the attention's 1x1 and the
  hyper-analysis's k3s1. A residual-block kernel takes its blocks away from
  the gate (elic.py:78-155), leaving 2."""
  _, _, port = int8_models
  monkeypatch.setenv("SNTC_INT8_ENCODE", "1")
  if route:
    monkeypatch.setenv(route, "1")
  calls = []
  conv = int8ops.conv_s1_int8
  monkeypatch.setattr(int8ops, "conv_s1_int8", lambda *a: calls.append(a[0].shape) or conv(*a))
  with torch.no_grad():
    port.infer_latent_rvs(to_torch(images(2, (64, 64))))
  assert len(calls) == int8_convs, calls
  assert all(shape[-1] >= 32 for shape in calls)


# --- the gates and the entry points -------------------------------------------------
@pytest.mark.parametrize("env,raises", [({}, False), ({"SNTC_INT8_DECODE": "0"}, False),
                                        ({"SNTC_INT8_DECODE": "1"}, True),
                                        ({"SNTC_INT8_DECODE": "syn"}, True),
                                        ({"SNTC_INT8_DECODE": "all"}, True),
                                        ({"SNTC_INT8_ENCODE": "1"}, True),
                                        ({"SNTC_INT8_ENCODE": "0"}, False)])
def test_assert_training_safe_as_jax(env, raises, monkeypatch):
  for name, value in env.items():
    monkeypatch.setenv(name, value)
  for lib in (jax_int8, int8ops):
    if raises:
      with pytest.raises(RuntimeError, match="inference-only"):
        lib.assert_training_safe()
    else:
      lib.assert_training_safe()
  assert int8ops.mode() == jax_int8.mode() and int8ops.enabled() == jax_int8.enabled()


def test_decode_mode_overrides_and_restores(monkeypatch):
  monkeypatch.setenv("SNTC_INT8_DECODE", "all")
  with int8ops.decode_mode("syn"):
    assert int8ops.mode() == "syn" and int8ops.hyper_exempt()
    with int8ops.decode_mode(None), int8ops.force(False):
      assert int8ops.mode() == "syn" and not int8ops.enabled()
    with int8ops.decode_mode(""):
      assert not int8ops.enabled()
      int8ops.assert_training_safe()
  assert int8ops.mode() == "all" and os.environ["SNTC_INT8_DECODE"] == "all"
  with pytest.raises(ValueError, match="none of"):
    with int8ops.decode_mode("int8"):
      pass


@pytest.mark.parametrize("cli", ["train", "itinf"])
@pytest.mark.parametrize("gate", ["env", "decode_mode"])
def test_train_and_itinf_clis_refuse_a_leaked_gate(cli, gate, tmp_path, monkeypatch):
  """Both raise before they build a model or write anything."""
  if gate == "env":
    monkeypatch.setenv("SNTC_INT8_ENCODE", "1")
  argv = (["--config", "smoke", "--workdir", str(tmp_path / "w"), "--num_steps", "1"]
          if cli == "train" else
          ["--init_seed", "0", "--dataset", "synthetic", "--out", str(tmp_path / "w")])
  main = train_cli.main if cli == "train" else itinf_cli.main
  with int8ops.decode_mode("syn" if gate == "decode_mode" else None):
    with pytest.raises(RuntimeError, match="inference-only"):
      main(argv + ["--device", "cpu"])
  assert not (tmp_path / "w").exists()


def _spy_int8(monkeypatch):
  modes = []
  conv = int8ops.conv_s1_int8
  monkeypatch.setattr(int8ops, "conv_s1_int8",
                      lambda *a: modes.append(int8ops.mode()) or conv(*a))
  return modes


def test_eval_cli_decode_dtype_leaves_the_process_as_it_found_it(tmp_path, monkeypatch):
  """--decode_dtype int8_syn keeps the float bpp and moves PSNR; int8_all
  moves the bpp; neither writes os.environ nor leaves a mode set."""
  monkeypatch.setattr(eval_lib.configs, "TWO_LAYER_SYN_RD", INT8_CONFIG)
  np.save(tmp_path / "img.npy", (images(5, (64, 64))[0] * 255 + 127.5).astype(np.uint8))
  env = dict(os.environ)
  modes = _spy_int8(monkeypatch)
  records = {}
  for dtype in ("float", "int8_syn", "int8_all"):
    path = eval_cli.main(["--init_seed", "0", "--images", str(tmp_path / "img.npy"),
                          "--device", "cpu", "--results_dir", str(tmp_path / dtype),
                          "--decode_dtype", dtype])
    with open(path) as f:
      (records[dtype],) = json.load(f)
    assert dict(os.environ) == env and int8ops.mode() == "" and not int8ops.enabled()
  assert set(modes) == {"syn", "all"}
  assert records["int8_syn"]["bpp"] == records["float"]["bpp"]
  assert records["int8_syn"]["psnr"] != records["float"]["psnr"]
  assert records["int8_all"]["bpp"] != records["float"]["bpp"]


def test_compress_cli_int8_syn_roundtrips_and_reads_float_bitstreams(tmp_path, monkeypatch):
  """roundtrip --decode_dtype int8_syn is bit-exact; a float encoder's
  bitstream decodes under int8_syn to the same latent, and to the int8
  synthesis of it; os.environ and the mode stay as they were."""
  monkeypatch.setattr(eval_lib.configs, "TWO_LAYER_SYN_RD", INT8_CONFIG)
  img = (images(6, (40, 56))[0] * 255 + 127.5).astype(np.uint8)
  np.save(tmp_path / "img.npy", img)
  env = dict(os.environ)
  common = ["--init_seed", "0", "--device", "cpu"]
  modes = _spy_int8(monkeypatch)
  line = compress_cli.main(["roundtrip", "--input", str(tmp_path / "img.npy"),
                            "--decode_dtype", "int8_syn"] + common)
  assert line.endswith("bit_exact=True") and set(modes) == {"syn"}
  compress_cli.main(["compress", "--input", str(tmp_path / "img.npy"),
                     "--output", str(tmp_path / "img.sntc")] + common)
  compress_cli.main(["decompress", "--input", str(tmp_path / "img.sntc"), "--output",
                     str(tmp_path / "rec.npy"), "--decode_dtype", "int8_syn"] + common)
  assert dict(os.environ) == env and int8ops.mode() == ""
  codec = api.make_codec(eval_lib.build_model(INT8_CONFIG, init_seed=0, device="cpu"))
  blob = (tmp_path / "img.sntc").read_bytes()
  float_rec = codec.decompress(blob)
  with int8ops.decode_mode("syn"):
    _, _, y_syn = codec.decode_latent(blob)
    syn_rec = codec.decompress(blob)
  np.testing.assert_array_equal(y_syn, codec.decode_latent(blob)[2])
  np.testing.assert_array_equal(np.load(tmp_path / "rec.npy"), syn_rec)
  assert not np.array_equal(syn_rec, float_rec)


def test_flagship_init_params_cover_the_d2s_and_elic_synthesis():
  """params.init_params gives both new transforms a seeded init that loads."""
  for cfg in (dict(cls="ElicSynthesis", channels=(16, 16, 3), kernel_sizes=(5, 5, 5),
                   strides=(2, 2, 2), num_residual_blocks=1),
              dict(cls="TwoLayerResSynthesis", channels=(12, 3), res_type="d2s")):
    module = T.build_transform(cfg, 16)
    flat = params_lib.init_params(module, 0)
    params_lib.load_params(module, flat)
    assert set(flat) == {k.replace(".", "/") for k in module.state_dict()}
    with torch.no_grad():
      out = module(to_torch(rand(np.random.default_rng(0), (1, 2, 3, 16))))
    assert torch.isfinite(out).all()
