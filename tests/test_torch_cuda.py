"""The port's CUDA kernels on the card, against their plain versions
(final_deconv_phase; fused_rb_chain and fused_resblock; jpegl_synthesize),
and the eval CLI on the card against the CPU.

Tests marked gpu skip without an NVIDIA GPU. This file imports no JAX, so on
a machine with a GPU it runs as
  python -m pytest --noconftest -p no:cacheprovider -m gpu tests/test_torch_cuda.py
(--noconftest: tests/conftest.py imports JAX, which a GPU machine need not have).
"""

import json

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from shallow_ntc_tpu_torch.ops import cuda_build
from shallow_ntc_tpu_torch.ops import jpegl_decode
from shallow_ntc_tpu_torch.ops import rb_chain
from shallow_ntc_tpu_torch.ops import resblock
from shallow_ntc_tpu_torch.ops import twolayer_final as tl


def _inputs(seed, b, h, w, device, dtype, k=5, c_in=12, c_out=3):
  rng = np.random.default_rng(seed)
  mid = torch.from_numpy(rng.standard_normal((b, h, w, 64 * c_in), np.float32))
  kernel = torch.from_numpy(rng.standard_normal((k, k, c_in, c_out), np.float32) * 0.1)
  bias = torch.from_numpy(rng.standard_normal((c_out,), np.float32) * 0.1)
  return mid.to(device, dtype), kernel.to(device, dtype), bias.to(device)


@pytest.fixture
def cuda_device():
  if not torch.cuda.is_available():
    pytest.skip("needs an NVIDIA GPU (the CUDA kernel has no CPU mode)")
  torch.backends.cudnn.allow_tf32 = False
  torch.backends.cuda.matmul.allow_tf32 = False
  return torch.device("cuda")


def test_build_names_the_missing_compiler(monkeypatch, tmp_path):
  monkeypatch.setenv("PATH", str(tmp_path))
  monkeypatch.setenv("CUDA_HOME", str(tmp_path))
  with pytest.raises(RuntimeError, match="nvcc not found"):
    cuda_build.find_nvcc()
  assert cuda_build.library_path(tl.SOURCE).startswith(cuda_build.BUILD_DIR)


@pytest.mark.gpu
@pytest.mark.parametrize("b,h,w,dtype,k,c_in,c_out", [
    (1, 32, 48, torch.float32, 5, 12, 3), (8, 32, 48, torch.bfloat16, 5, 12, 3),
    (3, 5, 7, torch.float32, 5, 12, 3), (2, 3, 4, torch.float32, 7, 12, 3),
    (1, 1, 1, torch.bfloat16, 5, 12, 3), (2, 3, 9, torch.bfloat16, 7, 12, 3),
    (1, 2, 11, torch.float32, 3, 12, 3), (2, 3, 5, torch.float32, 5, 5, 5),
    (2, 3, 5, torch.bfloat16, 5, 5, 5), (1, 2, 10, torch.bfloat16, 3, 16, 8),
    (3, 1, 17, torch.float32, 7, 16, 3), (2, 2, 9, torch.bfloat16, 5, 6, 4),
    (1, 2, 9, torch.float32, 5, 6, 4), (8, 16, 16, torch.float32, 5, 12, 3)])
def test_final_deconv_kernel_matches_plain(cuda_device, b, h, w, dtype, k, c_in, c_out):
  """f32 within 1e-4; bf16 within 2e-2 of max|y| (both round the output to bf16).
  The kernel's tiles are 8 phase columns of one phase row: W no multiple of
  8 and W = 1, H = 1, B = 1; k = 3, 5 and 7 (7 reads two halo rows above and
  two halo columns to the left); c_in 12, 5 (bf16 staged in 2-byte pieces),
  6 and 16; c_out 3, 4, 5 and 8 (5 and 8 take two GEMM passes)."""
  mid, kernel, bias = _inputs(b + h, b, h, w, cuda_device, dtype, k=k, c_in=c_in, c_out=c_out)
  launches = tl.STATS.launches
  out = tl.final_deconv_cuda(mid, kernel, bias, c_in)
  torch.cuda.synchronize()
  assert tl.STATS.launches == launches + 1
  ref = tl.final_deconv_plain(mid, kernel, bias, c_in)
  err = (out.float() - ref.float()).abs().max().item()
  scale = ref.float().abs().max().item()
  assert err <= (1e-4 if dtype == torch.float32 else 2e-2 * scale), (err, scale)


@pytest.mark.gpu
@pytest.mark.parametrize("b,h,w", [(8, 32, 48), (2, 3, 9)])
def test_final_deconv_kernel_adds_a_float32_bias_to_bfloat16_mid(cuda_device, b, h, w):
  """bfloat16 mid with float32 weights and bias: the kernel and the plain
  version both add the bias in float32 before the one rounding, so they agree
  at >= 99% of the outputs and within one bfloat16 ulp elsewhere. The biases
  lie off the bfloat16 grid, where rounding them first moves ~30% of the
  outputs by an ulp. mid is scaled by 0.05, so every output lies near its
  bias, away from 0, where one ulp is no bound on a sum's rounding."""
  mid, kernel, _ = _inputs(b * h + w, b, h, w, cuda_device, torch.bfloat16)
  mid, kernel = (mid.float() * 0.05).bfloat16(), kernel.float()
  bias = torch.tensor([1 + 3 * 2**-10, -2 + 5 * 2**-9, 0.5 + 2**-11], device=cuda_device)
  out = tl.final_deconv_cuda(mid, kernel, bias, 12).float()
  ref = tl.final_deconv_plain(mid, kernel, bias, 12).float()
  ulp = torch.exp2(torch.floor(torch.log2(ref.abs())) - 7)
  assert (out == ref).float().mean().item() >= 0.99
  assert ((out - ref).abs() <= ulp).all().item()


@pytest.mark.gpu
def test_final_deconv_kernel_gradients_match_plain(cuda_device):
  mid, kernel, bias = _inputs(5, 2, 3, 4, cuda_device, torch.float32)
  cot = torch.randn(2, 48, 64, 3, device=cuda_device)
  grads = []
  for fn in (tl.final_deconv_phase, tl.final_deconv_plain):
    leaves = [t.clone().requires_grad_(True) for t in (mid, kernel, bias)]
    fn(*leaves, 12).backward(cot)
    grads.append([leaf.grad for leaf in leaves])
  for a, b_ in zip(*grads):
    torch.testing.assert_close(a, b_, atol=1e-4, rtol=1e-5)


@pytest.mark.gpu
def test_final_deconv_kernel_refuses_what_it_does_not_take(cuda_device):
  mid, kernel, bias = _inputs(0, 1, 2, 2, cuda_device, torch.float32)
  with pytest.raises(TypeError):
    tl.final_deconv_cuda(mid.half(), kernel, bias, 12)
  with pytest.raises(ValueError, match="contiguous"):
    tl.final_deconv_cuda(mid.transpose(1, 2), kernel, bias, 12)
  with pytest.raises(ValueError, match="kernel"):
    tl.final_deconv_cuda(mid, kernel[:, :, :6], bias, 12)
  wide = torch.zeros(9, 9, 12, 3, device=cuda_device)
  with pytest.raises(ValueError, match="k <= 7"):
    tl.final_deconv_cuda(mid, wide, bias, 12)


def _rb_params(seed, n, c, device):
  rng = np.random.default_rng(seed)
  ch = c // 2
  mk = lambda *shape: torch.from_numpy(  # noqa: E731
      (rng.standard_normal(shape) * 0.3 / np.sqrt(shape[-2] if len(shape) > 1 else 1))
      .astype(np.float32)).to(device)
  return [(mk(c, ch), mk(ch), mk(3, 3, ch, ch), mk(ch), mk(ch, c), mk(c)) for _ in range(n)]


@pytest.mark.gpu
@pytest.mark.parametrize("b,h,w,c,n,dtype", [
    (2, 32, 32, 192, 3, torch.float32), (2, 32, 32, 192, 3, torch.bfloat16),
    (2, 8, 8, 320, 3, torch.float32), (2, 8, 8, 320, 3, torch.bfloat16),
    (3, 7, 5, 16, 2, torch.float32), (2, 9, 17, 10, 1, torch.float32),
    (2, 17, 9, 192, 2, torch.float32), (2, 17, 9, 192, 2, torch.bfloat16),
    (3, 7, 5, 20, 2, torch.float32), (3, 7, 5, 20, 2, torch.bfloat16),
    (2, 17, 9, 320, 1, torch.float32), (2, 17, 9, 320, 1, torch.bfloat16),
    (1, 7, 5, 62, 1, torch.float32), (1, 7, 5, 62, 1, torch.bfloat16)])
def test_rb_chain_kernel_matches_plain(cuda_device, b, h, w, c, n, dtype):
  """f32 within 1e-4 of max|y|; bf16 within 2e-2 of max|y| (both round h1, h2
  and h3 to bf16; a float32 sum summed in another order can round across).
  H and W not multiples of the 8x8 tile, C/2 not a multiple of 8 (C=20, 62),
  and C=62, whose x rows are no multiple of 16 bytes in either dtype, so the
  kernel stages x by plain loads."""
  params = _rb_params(c + n, n, c, cuda_device)
  x = torch.randn(b, h, w, c, device=cuda_device).to(dtype)
  launches = rb_chain.STATS.launches
  out = rb_chain.rb_chain_cuda(x, params)
  torch.cuda.synchronize()
  assert rb_chain.STATS.launches == launches + 1
  ref = rb_chain.dense_rb_chain(x, params)
  err = (out.float() - ref.float()).abs().max().item()
  scale = ref.float().abs().max().item()
  assert err <= (1e-4 if dtype == torch.float32 else 2e-2) * scale, (err, scale)


@pytest.mark.gpu
@pytest.mark.parametrize("n", [1, 3])
def test_rb_chain_kernel_gradients_match_plain(cuda_device, n):
  params = _rb_params(n, n, 32, cuda_device)
  x = torch.randn(2, 9, 11, 32, device=cuda_device)
  cot = torch.randn_like(x)
  grads = []
  for fn in (rb_chain.fused_rb_chain, rb_chain.dense_rb_chain):
    x_l = x.clone().requires_grad_(True)
    p_l = [tuple(t.clone().requires_grad_(True) for t in block) for block in params]
    (fn(x_l, p_l) * cot).sum().backward()
    grads.append([x_l.grad] + [t.grad for block in p_l for t in block])
  for a, b_ in zip(*grads):
    torch.testing.assert_close(a, b_, atol=1e-5, rtol=1e-5)


@pytest.mark.gpu
def test_resblock_kernel_matches_plain_and_counts(cuda_device):
  (block,) = _rb_params(1, 1, 192, cuda_device)
  x = torch.randn(1, 20, 12, 192, device=cuda_device)
  chain, single = rb_chain.STATS.launches, resblock.STATS.launches
  out = resblock.fused_resblock(x, *block)
  torch.cuda.synchronize()
  assert (rb_chain.STATS.launches, resblock.STATS.launches) == (chain, single + 1)
  ref = rb_chain.dense_resblock(x, *block)
  assert (out - ref).abs().max().item() <= 1e-4 * ref.abs().max().item()
  (block,) = _rb_params(2, 1, 20, cuda_device)
  x = torch.randn(3, 7, 5, 20, device=cuda_device)
  out = resblock.fused_resblock_cuda(x, *block)
  ref = rb_chain.dense_resblock(x, *block)
  assert resblock.STATS.launches == single + 2
  assert (out - ref).abs().max().item() <= 1e-4 * ref.abs().max().item()


@pytest.mark.gpu
def test_rb_chain_kernel_refuses_what_it_does_not_take(cuda_device):
  (block,) = _rb_params(0, 1, 16, cuda_device)
  x = torch.randn(1, 4, 4, 16, device=cuda_device)
  with pytest.raises(TypeError):
    rb_chain.block_cuda(x.half(), *block)
  with pytest.raises(ValueError, match="contiguous"):
    rb_chain.block_cuda(x.transpose(1, 2), *block)
  with pytest.raises(ValueError, match="expected"):
    rb_chain.block_cuda(x, block[0][:, :4], *block[1:])
  (wide,) = _rb_params(0, 1, 2 * (rb_chain.MAX_HIDDEN + 1), cuda_device)
  with pytest.raises(ValueError, match="C/2"):
    rb_chain.block_cuda(torch.zeros(1, 2, 2, 2 * (rb_chain.MAX_HIDDEN + 1),
                                    device=cuda_device), *wide)


def _jpegl_inputs(seed, b, hl, wl, c_in, k, device, dtype, use_bias=True,
                  params=torch.float32):
  rng = np.random.default_rng(seed)
  z = torch.from_numpy(rng.normal(0, 3, (b, hl, wl, c_in)).astype(np.float32))
  kernel = torch.from_numpy(rng.normal(0, 0.1 / np.sqrt(c_in / 32), (k, k, c_in, 3))
                            .astype(np.float32))
  bias = torch.from_numpy(rng.normal(0, 0.1, (3,)).astype(np.float32)) if use_bias else None
  return (z.to(device, dtype), kernel.to(device, params),
          None if bias is None else bias.to(device, params))


BF16, F32 = torch.bfloat16, torch.float32


@pytest.mark.gpu
@pytest.mark.parametrize("b,hl,wl,c_in,k,dtype,use_bias,params", [
    (8, 32, 48, 320, 16, BF16, True, BF16), (1, 32, 48, 320, 16, F32, True, F32),
    (8, 32, 48, 320, 16, BF16, True, F32), (1, 3, 5, 320, 16, BF16, True, BF16),
    (1, 3, 5, 320, 16, F32, True, F32), (3, 5, 7, 320, 16, BF16, False, BF16),
    (3, 5, 7, 320, 16, F32, False, F32), (2, 3, 48, 320, 16, BF16, True, BF16),
    (2, 3, 48, 320, 16, F32, True, F32), (3, 5, 7, 321, 16, F32, False, F32),
    (1, 3, 5, 16, 8, F32, True, F32), (1, 3, 5, 16, 8, BF16, True, BF16),
    (3, 5, 7, 321, 16, BF16, False, F32), (2, 3, 5, 40, 5, BF16, True, F32),
    (2, 3, 5, 40, 5, F32, True, F32), (2, 3, 5, 40, 16, BF16, True, BF16)])
def test_jpegl_kernel_matches_plain(cuda_device, b, hl, wl, c_in, k, dtype, use_bias, params):
  """f32 within 1e-4 max(1, max|y|); bf16 within 1e-2 max|y| (both round an
  f32 sum once). The decode and eval shapes with the parameters in z's dtype
  (the bf16 decode is the K16 kernel) and in float32; M no multiple of the
  64-latent tile (B=1 3x5: fewer tiles than the K16 kernel's walkers; B=3
  5x7), tiles that cross latent rows (W_l = 48, 5, 7), with and without
  bias; the offset channel (C odd: 4-byte or 2-byte pieces) with no bias;
  k=8 (C=16, one partial channel chunk) and k=5 (N = 75: a partial column
  tile and single stores; C=40 ends in a partial chunk)."""
  z, kernel, bias = _jpegl_inputs(b + c_in, b, hl, wl, c_in, k, cuda_device, dtype, use_bias,
                                  params)
  launches = jpegl_decode.STATS.launches
  out = jpegl_decode.jpegl_synthesize(z, kernel, bias)
  torch.cuda.synchronize()
  assert jpegl_decode.STATS.launches == launches + 1
  ref = jpegl_decode.jpegl_synthesize_plain(z, kernel, bias)
  assert out.shape == ref.shape == (b, hl * k, wl * k, 3) and out.dtype == dtype
  err = (out.float() - ref.float()).abs().max().item()
  scale = ref.float().abs().max().item()
  assert err <= (1e-4 * max(1.0, scale) if dtype == torch.float32 else 1e-2 * scale), (err, scale)


@pytest.mark.gpu
def test_jpegl_kernel_at_k16_takes_an_unaligned_kernel(cuda_device):
  """A bf16 K16 kernel 2 bytes off 16-byte alignment takes the tiled route
  (its whole-patch-row stores included) and agrees as the aligned one does."""
  z, kernel, bias = _jpegl_inputs(7, 2, 3, 48, 320, 16, cuda_device, BF16, params=BF16)
  buf = torch.empty(kernel.numel() + 1, dtype=BF16, device=cuda_device)
  buf[1:] = kernel.flatten()
  shifted = buf[1:].view(kernel.shape)
  out = jpegl_decode.jpegl_synthesize(z, shifted, bias)
  aligned = jpegl_decode.jpegl_synthesize(z, kernel, bias)
  ref = jpegl_decode.jpegl_synthesize_plain(z, kernel, bias).float()
  scale = ref.abs().max().item()
  for o in (out, aligned):
    assert (o.float() - ref).abs().max().item() <= 1e-2 * scale


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [BF16, F32])
def test_jpegl_call_launches_the_kernel_alone(cuda_device, dtype):
  """With weights and bias in z's dtype, as the model's, a call launches one
  CUDA kernel and nothing else (torch.profiler)."""
  z, kernel, bias = _jpegl_inputs(3, 1, 4, 6, 320, 16, cuda_device, dtype, params=dtype)
  jpegl_decode.jpegl_synthesize(z, kernel, bias)
  torch.cuda.synchronize()
  with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
    jpegl_decode.jpegl_synthesize(z, kernel, bias)
    torch.cuda.synchronize()
  names = [e.key for e in prof.key_averages() if e.device_type.name == "CUDA"]
  assert len(names) == 1 and "jpegl" in names[0], names


@pytest.mark.gpu
def test_jpegl_kernel_refuses_what_it_does_not_take(cuda_device):
  z, kernel, bias = _jpegl_inputs(0, 1, 2, 3, 16, 16, cuda_device, torch.float32)
  with pytest.raises(ValueError, match="CUDA tensor"):
    jpegl_decode.jpegl_synthesize_cuda(z.cpu(), kernel, bias)
  with pytest.raises(TypeError):
    jpegl_decode.jpegl_synthesize_cuda(z.half(), kernel, bias)
  with pytest.raises(ValueError, match="contiguous"):
    jpegl_decode.jpegl_synthesize_cuda(z.transpose(1, 2), kernel, bias)
  with pytest.raises(ValueError, match="kernel_size == strides"):
    jpegl_decode.jpegl_synthesize_cuda(z, kernel, bias, strides=8)


@pytest.mark.gpu
@pytest.mark.parametrize("config", ["two_layer_syn_rd", "jpegl_rd"])
def test_eval_cli_on_the_card_matches_the_cpu(cuda_device, tmp_path, monkeypatch, config):
  """The eval CLI at its default precision on one synthetic 256x256 image,
  with TF32 on beforehand (PyTorch's default for cuDNN): on the card and on
  the CPU with the same seeded weights, the latent rate and PSNR within
  rtol 1e-3 (PERF.md section 2), and the CLI leaves TF32 off. The total bpp
  is not held: it includes the hyper-latent rate, where elements on the
  reference prior's sign-trick degeneracy take the 1e-9 floor or not by the
  last bit of each device's arithmetic (ROADMAP.md queue 3; chip_smoke.py
  measured 1.1e-2 on a 192x256 crop); it is printed."""
  from shallow_ntc_tpu_torch import data
  from shallow_ntc_tpu_torch import eval as eval_cli

  monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", True)
  monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", True)
  image = next(iter(data.SyntheticDataset(1, 256, num_batches=1, raw_uint8=True)))[0]
  np.save(tmp_path / "img.npy", image)
  records = {}
  for device in ("cuda", "cpu"):
    path = eval_cli.main(["--config", config, "--init_seed", "0", "--images",
                          str(tmp_path / "img.npy"), "--device", device,
                          "--results_dir", str(tmp_path / device)])
    with open(path) as f:
      (records[device],) = json.load(f)
  assert not torch.backends.cudnn.allow_tf32 and not torch.backends.cuda.matmul.allow_tf32
  print({k: (records["cuda"][k], records["cpu"][k]) for k in ("bpp", "hyper_latent_bpp")})
  for key in ("latent_bpp", "psnr"):
    np.testing.assert_allclose(records["cuda"][key], records["cpu"][key], rtol=1e-3,
                               err_msg=key)


def _small_codec(device):
  """The codec of the flagship at narrow ELIC widths (the smoke config), seeded."""
  from shallow_ntc_tpu_torch import configs, eval_lib
  from shallow_ntc_tpu_torch.codec import api as codec_api

  model = eval_lib.build_model(configs.TRAIN_CONFIGS["smoke"]["model_config"], init_seed=0,
                               device=device)
  return codec_api.make_codec(model)


def _codec_image(seed, h, w):
  rng = np.random.default_rng(seed)
  return (rng.integers(0, 256, (h, w, 3)) / 255.0 - 0.5).astype(np.float32)


@pytest.mark.gpu
def test_codec_roundtrip_on_the_card_is_bit_exact(cuda_device):
  """GPU encode -> GPU decode: the decoder's image is the encoder's, bit for
  bit, at a size that pads (100x140) and one that does not; the synthesis
  launches final_deconv_phase."""
  codec = _small_codec(cuda_device)
  launches = tl.STATS.launches
  for seed, (h, w) in ((0, (100, 140)), (1, (128, 192))):
    result = codec.compress(_codec_image(seed, h, w))
    rec = codec.decompress(result.bitstring)
    assert rec.dtype == np.uint8 and rec.shape == (h, w, 3)
    np.testing.assert_array_equal(rec, result.reconstruction)
  torch.cuda.synchronize()
  assert tl.STATS.launches >= launches + 4


@pytest.mark.gpu
def test_codec_batch_paths_on_the_card_match_the_per_image_path(cuda_device):
  """Byte-identical bitstreams and decoded latents; reconstructions equal
  under strict=True and within +-1 otherwise (a batched synthesis may round
  a pixel the other way)."""
  codec = _small_codec(cuda_device)
  xs = [_codec_image(i, 128, 192) for i in range(3)] + [_codec_image(3, 100, 140)]
  singles = [codec.compress(x) for x in xs]
  batch = codec.compress_batch(xs, reconstruct=True, chunk_size=2)
  assert [b.bitstring for b in batch] == [s.bitstring for s in singles]
  for b, s in zip(batch, singles):
    assert np.abs(b.reconstruction.astype(int) - s.reconstruction).max() <= 1
  blobs = [s.bitstring for s in singles]
  for rec, s in zip(codec.decompress_batch(blobs, chunk_size=2, strict=True), singles):
    np.testing.assert_array_equal(rec, s.reconstruction)
  for rec, s in zip(codec.decompress_batch(blobs, chunk_size=2), singles):
    assert np.abs(rec.astype(int) - s.reconstruction).max() <= 1


def _small_itinf(device):
  """configs.ITINF's model at narrow ELIC widths (the smoke config), seeded,
  float32 transforms, and its SGA functions."""
  from shallow_ntc_tpu_torch import configs, eval_lib, itinf_lib

  cfg = dict(configs.ITINF["model_config"],
             transform_config=configs.TRAIN_CONFIGS["smoke"]["model_config"]["transform_config"])
  model = eval_lib.build_model(cfg, init_seed=0, device=device)
  return model, itinf_lib.make_itinf_functions(model, cfg["optimizer_config"], 3000)


@pytest.mark.gpu
def test_sga_steps_on_the_card_match_the_cpu(cuda_device):
  """3 SGA steps of a 128x192 image on the card and on the CPU from the same
  latents with the same logistic draws: rd_loss, bpp and PSNR rtol 1e-4; the
  latents within 0.05 * the summed lr elementwise, or else the difference's
  L2 within 1e-2 of the L2 of the latents' movement (Adam moves an element
  whose gradient is within rounding of 0 by lr either way; chip_smoke.py
  phase 12 holds the full width so). Each step launches final_deconv_phase
  once."""
  x = _codec_image(5, 128, 192)[None]
  runs = {d: _small_itinf(d) for d in ("cpu", "cuda")}
  state = {d: fns.init(torch.from_numpy(x).to(d)) for d, (_, fns) in runs.items()}
  with torch.no_grad():
    for a, b in zip(state["cuda"][0].uq, state["cpu"][0].uq):
      a.loc.copy_(b.loc)
  init = [rv.loc.detach().clone() for rv in state["cpu"][0].uq]
  rng = np.random.default_rng(1)
  lr_sum = 0.0
  for step in range(3):
    draws = [rng.logistic(size=tuple(v.shape)).astype(np.float32) for v in init]
    metrics = {}
    for d, (_, fns) in runs.items():
      launches = tl.STATS.launches
      metrics[d] = fns.step(torch.from_numpy(x).to(d), *state[d], step, None,
                            noise=tuple(torch.from_numpy(n).to(d) for n in draws))
      if d == "cuda":
        torch.cuda.synchronize()
        assert tl.STATS.launches == launches + 1
    lr_sum += float(metrics["cpu"]["scheduled_lr"])
    for key in ("rd_loss", "bpp", "psnr"):
      np.testing.assert_allclose(float(metrics["cuda"][key]), float(metrics["cpu"][key]),
                                 rtol=1e-4, err_msg=f"step {step} {key}")
    for a, b, b0 in zip(state["cuda"][0].uq, state["cpu"][0].uq, init):
      diff = (a.loc.detach().cpu() - b.loc.detach()).abs()
      if diff.max() > 0.05 * lr_sum:
        assert diff.norm() <= 1e-2 * (b.loc.detach() - b0).norm(), step


@pytest.mark.gpu
def test_sga_run_launches_final_deconv_once_per_step_and_val_pass(cuda_device):
  """itinf_on_data_batch with 4 steps and a val pass every 2: 4 + 2 launches;
  the latents come back float32."""
  from shallow_ntc_tpu_torch import itinf_lib

  model, fns = _small_itinf(cuda_device)
  launches = tl.STATS.launches
  _, val, itinf_vars = itinf_lib.itinf_on_data_batch(
      model, _codec_image(6, 128, 192)[None],
      dict(num_steps=4, log_metrics_every_steps=2, eval_every_steps=2), {}, fns=fns)
  torch.cuda.synchronize()
  assert tl.STATS.launches == launches + 6
  assert all(v.dtype == np.float32 for v in itinf_vars.values()) and np.isfinite(val["rd_loss"])


def _small_factorized(device):
  """bls2017_rd at 16 filters, seeded, on `device`."""
  import copy

  from shallow_ntc_tpu_torch import configs, eval_lib

  cfg = copy.deepcopy(configs.BLS2017_RD)
  for part in ("analysis", "synthesis"):
    cfg["transform_config"][part]["num_filters"] = 16
  return cfg, eval_lib.build_model(cfg, init_seed=0, device=device, family="factorized")


@pytest.mark.gpu
def test_factorized_eval_and_train_step_on_the_card_match_the_cpu(cuda_device):
  """The factorized eval of a 128x192 image: y within 1e-4 * max(1, max|y|)
  and PSNR rtol 1e-3 (the total rate, the prior's alone, is printed: the
  sign trick's floor depends on each device's last bit); then one train
  step from the same params with the same uniform draw: rd_loss rtol 1e-4
  and every gradient within 1e-3 * max|g| + 1e-6 elementwise, or its L2
  within 1e-2 (a relu-free model: GDN only, so no flip is expected)."""
  from shallow_ntc_tpu_torch import eval_lib, train_lib

  x = _codec_image(7, 128, 192)[None]
  runs = {d: _small_factorized(d) for d in ("cpu", "cuda")}
  metrics, ys = {}, {}
  for d, (_, model) in runs.items():
    (metrics[d],) = list(eval_lib.evaluate_images(model, x))
    with torch.no_grad():
      ys[d] = model.infer_latent_rvs(torch.from_numpy(x).to(d)).uq[0].loc.cpu()
  print({k: (metrics["cuda"][k], metrics["cpu"][k]) for k in ("bpp", "psnr")})
  torch.testing.assert_close(ys["cuda"], ys["cpu"], rtol=0,
                             atol=1e-4 * max(1.0, ys["cpu"].abs().max().item()))
  np.testing.assert_allclose(metrics["cuda"]["psnr"], metrics["cpu"]["psnr"], rtol=1e-3)
  batch = _codec_image(8, 64, 64)[None].repeat(2, 0)
  noise = np.random.default_rng(2).uniform(-0.5, 0.5, (2, 4, 4, 16)).astype(np.float32)
  step_metrics, grads = {}, {}
  for d, (cfg, model) in runs.items():
    model.train()
    state, lr_fn = train_lib.create_train_state(model, {"learning_rate": 1e-4})
    step_metrics[d] = train_lib.make_train_step(model, state.optimizer, lr_fn)(
        state, torch.from_numpy(batch).to(d), noise=(torch.from_numpy(noise).to(d),))
    grads[d] = [p.grad.cpu() for p in model.parameters()]
  np.testing.assert_allclose(float(step_metrics["cuda"]["rd_loss"]),
                             float(step_metrics["cpu"]["rd_loss"]), rtol=1e-4)
  for g_gpu, g_cpu in zip(grads["cuda"], grads["cpu"]):
    diff = (g_gpu - g_cpu).abs()
    if diff.max() > 1e-3 * g_cpu.abs().max() + 1e-6:
      assert diff.norm() <= 1e-2 * g_cpu.norm()


@pytest.mark.gpu
def test_factorized_codec_roundtrip_on_the_card_is_bit_exact(cuda_device):
  """GPU encode -> GPU decode of the factorized codec, at a size that pads
  (100x140) and one that does not; no kernel of the port launches."""
  from shallow_ntc_tpu_torch.codec import api as codec_api

  _, model = _small_factorized(cuda_device)
  codec = codec_api.make_codec(model)
  assert isinstance(codec, codec_api.FactorizedCodec)
  launches = tl.STATS.launches
  for seed, (h, w) in ((0, (100, 140)), (1, (128, 192))):
    result = codec.compress(_codec_image(seed, h, w))
    rec = codec.decompress(result.bitstring)
    assert rec.dtype == np.uint8 and rec.shape == (h, w, 3)
    np.testing.assert_array_equal(rec, result.reconstruction)
  torch.cuda.synchronize()
  assert tl.STATS.launches == launches


@pytest.mark.gpu
def test_two_layer_syn2_forward_launches_final_deconv_once(cuda_device):
  """two_layer_syn2's TwoLayerSynthesis (k13s8 + k5s2, 12 mid channels) takes
  the fused route: one final_deconv_phase launch a forward, in eval and in a
  mixedq training forward, and its output equals the unfused route's."""
  import copy

  from shallow_ntc_tpu_torch import configs, eval_lib

  cfg = copy.deepcopy(configs.TWO_LAYER_SYN2)
  cfg["transform_config"]["analysis"].update(channels_base=16, output_channels=32)
  model = eval_lib.build_model(cfg, init_seed=0, device=cuda_device)
  x = torch.from_numpy(_codec_image(9, 128, 192)[None]).to(cuda_device)
  for training in (False, True):
    launches = tl.STATS.launches
    loss, _, _ = model.end_to_end_frame_loss(x, training=training)
    if training:
      loss.backward()
    torch.cuda.synchronize()
    assert tl.STATS.launches == launches + 1
  y = torch.randn(1, 8, 12, 32, device=cuda_device)
  with torch.no_grad():
    fused = model.synthesize(y)
    model._synthesis.fused = False
    unfused = model.synthesize(y)
  torch.testing.assert_close(fused, unfused, rtol=0,
                             atol=1e-4 * max(1.0, unfused.abs().max().item()))


@pytest.mark.gpu
@pytest.mark.parametrize("m,k,n", [(12288, 2880, 1536), (17, 16, 16), (6, 20, 12),
                                   (1536, 2880, 1536)])
def test_int8_gemm_on_the_card_is_exact(cuda_device, m, k, n):
  """int8ops.int8_matmul (torch._int_mm, int32 accumulation) against a
  float64 product of the same int8 operands: exact, |sum| <= K 127^2 < 2^53;
  the k13s8 phase GEMM at B=8 and B=1, and shapes that need the padding."""
  from shallow_ntc_tpu_torch.ops import int8ops

  gen = torch.Generator(device=cuda_device).manual_seed(m + k + n)
  a = torch.randint(-127, 128, (m, k), device=cuda_device, generator=gen, dtype=torch.int8)
  b = torch.randint(-127, 128, (n, k), device=cuda_device, generator=gen, dtype=torch.int8)
  out = int8ops.int8_matmul(a, b)
  assert out.dtype == torch.int32 and out.shape == (m, n)
  torch.testing.assert_close(out.double(), a.double() @ b.double().t(), rtol=0, atol=0)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_conv_s1_int8_on_the_card_equals_the_cpu(cuda_device, dtype):
  """The flagship's k13s8 phase conv (T=3, 320 -> 2*768 channels) on int8
  operands: the card's output equals the CPU's bit for bit."""
  from shallow_ntc_tpu_torch.ops import int8ops

  rng = np.random.default_rng(3)
  x = torch.from_numpy(rng.standard_normal((2, 8, 12, 320), np.float32)).to(dtype)
  w = torch.from_numpy(rng.standard_normal((3, 3, 320, 1536), np.float32) * 0.05).to(dtype)
  cpu = int8ops.conv_s1_int8(x, w, 1, 1, dtype)
  gpu = int8ops.conv_s1_int8(x.to(cuda_device), w.to(cuda_device), 1, 1, dtype)
  torch.testing.assert_close(gpu.cpu(), cpu, rtol=0, atol=0)


@pytest.mark.gpu
@pytest.mark.parametrize("chain", [False, True])
def test_elic_synthesis_on_the_card_matches_the_cpu(cuda_device, monkeypatch, chain):
  """ElicSynthesis at its default channels (192, 160, 128, 3) on a 4x6x320
  latent, float32, TF32 off: the card (cuDNN, or fused_rb_chain once for
  each of its 7 chains with SNTC_FUSED_RB_CHAIN=1) against the CPU, within
  1e-4 * max|y|."""
  from shallow_ntc_tpu_torch import params as params_lib
  from shallow_ntc_tpu_torch.models import transforms as T

  if chain:
    monkeypatch.setenv("SNTC_FUSED_RB_CHAIN", "1")
  module = T.build_transform(dict(cls="ElicSynthesis"), 320)
  params_lib.load_params(module, params_lib.init_params(module, 0))
  z = torch.from_numpy(np.random.default_rng(4).standard_normal((1, 4, 6, 320), np.float32))
  with torch.no_grad():
    ref = module(z)
    launches = rb_chain.STATS.launches
    out = module.to(cuda_device)(z.to(cuda_device)).cpu()
  assert rb_chain.STATS.launches - launches == (7 if chain else 0)
  assert out.shape == (1, 64, 96, 3)
  torch.testing.assert_close(out, ref, rtol=0, atol=1e-4 * max(1.0, ref.abs().max().item()))


@pytest.mark.gpu
def test_d2s_residual_synthesis_on_the_card_matches_the_cpu(cuda_device):
  """TwoLayerResSynthesis(res_type="d2s") at the flagship's width (z of 320,
  channels (12, 3)), float32, TF32 off, against the CPU within 1e-4 * max|y|."""
  from shallow_ntc_tpu_torch import params as params_lib
  from shallow_ntc_tpu_torch.models import transforms as T

  module = T.build_transform(dict(cls="TwoLayerResSynthesis", channels=(12, 3),
                                  res_type="d2s"), 320)
  params_lib.load_params(module, params_lib.init_params(module, 0))
  z = torch.from_numpy(np.random.default_rng(5).standard_normal((1, 4, 6, 320), np.float32))
  with torch.no_grad():
    ref = module(z)
    out = module.to(cuda_device)(z.to(cuda_device)).cpu()
  torch.testing.assert_close(out, ref, rtol=0, atol=1e-4 * max(1.0, ref.abs().max().item()))
