#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (shallow_ntc_tpu_torch) on one NVIDIA GPU.

  python3 chip_smoke.py

Phases, one flushed line each with its seconds (TF32 off throughout):
  1. build     nvcc builds every CUDA kernel of the main paths (csrc/*.cu),
               one process per source, and g++ the codec's rANS coder
               (codec/rans.cc), all started together.
  2. device    the card's name, and its name and power limit from nvidia-smi.
  3. kernels   each kernel against its plain PyTorch version on the card, at
               the main paths' shapes plus odd ones, f32 and bf16, and its
               gradients through its autograd.Function (jpegl_synthesize has
               none: its backward must raise); fails on a miss.
  4. eval      per-image eval of the flagship mshyper model at full width
               (ELIC 192/192/192/320, synthesis (12, 3)), seeded random
               weights, three 512x768 images, f32; one batch decode at B=8 in
               bf16; then image 0 three ways: cuDNN residual blocks,
               SNTC_FUSED_RB_CHAIN=1 and SNTC_FUSED_RESBLOCK=1, each held to
               the cuDNN way on its latents z and y, latent rate and PSNR.
               Launch counts are zeroed before each run and read after it.
  5. reference the GPU eval against the port's CPU eval (plain versions) on a
               192x256 crop with the same weights: latents and prior logits
               to float tolerance, then the rest of the path from the same
               latents (latent rate, PSNR, reconstruction).
  6. codec     real bitstreams (shallow_ntc_tpu_torch.codec) of the flagship,
               float32, the seeded weights of phase 4: compress -> decompress
               of two 512x768 images and a 500x740 one, bit-exact, the decoded
               latent equal to the eval path's; compress and decompress in two
               processes through the CLI; the batch paths against the
               per-image path; one compress with SNTC_FUSED_RB_CHAIN=1; GPU
               encode -> CPU decode (reported); times of compress and
               decompress split into device legs and host rANS; then a
               JPEGL_K16 round trip (jpegl_synthesize). Launch counts are
               zeroed before each call and read after it.
  7. train     the train entry point (train_lib.train_and_eval, as the CLI
               calls it) on the flagship config: B=8 256x256 f32, synthetic
               crops, SNTC_FUSED_RB_CHAIN=1, a few steps and the final eval;
               losses finite, params moved, the chain kernel 7 times per
               forward, a checkpoint restored equal to the live state.
  8. train-reference  one full-width train step on the card (kernels)
               against the port's CPU step (plain versions), B=2 64x64, same
               params, batch and noise: loss, metrics and every gradient.
  9. eval-jpegl  the JPEG-like model at full width (ELIC 192/192/192/320),
               seeded weights, three 512x768 f32 images each: jpegl_rd (k18,
               the paper's decoder, a cuDNN transposed conv) and JPEGL_K16
               (k16, through jpegl_synthesize); then K16 on the card against
               the port's CPU eval on a 192x256 crop, as in phase 5.
 10. train-jpegl  2 steps of jpegl_rd through train_lib.train_and_eval at
               B=8 256x256 f32 with SNTC_FUSED_RB_CHAIN=1: losses finite,
               params moved, no jpegl_synthesize launch (k18).
 11. timing    the train step with the chain kernel on and off; the chain at
               each train stage; the B=8 bf16
               decode in Mpx/s of the flagship, jpegl_rd and JPEGL_K16; each
               kernel, its plain version and (where one exists) one PyTorch
               library call computing the same function, by CUDA events,
               beside its bound (final_deconv_phase at the decode, eval and
               train shapes, and at B=1 bf16, the SGA step's with bf16
               transforms).
 12. itinf     SGA iterative inference of the flagship (configs.ITINF) on one
               512x768 image at full width, seeded weights: 3 SGA steps on
               the card against the port's CPU step (plain versions), float32,
               TF32 off, the same logistic draws, from the same latents
               (latents, rd_loss, bpp, PSNR); ms per SGA step by CUDA events
               (float32 and bf16 transforms, TF32 off and on) beside the
               device time of its kernels (torch.profiler); the config's run through
               itinf_lib.itinf_on_data_batch (3000 steps, or 1000 if a step
               takes over 10 ms) with float32 transforms and
               SNTC_FUSED_RB_CHAIN=1: its val rd_loss at or below the
               amortized eval's, final_deconv_phase launched once per step
               and once per val pass, the chain 7 times (the init's
               analysis); 300 steps with bf16 transforms (val rd_loss within
               1.05x the amortized); an init with the chain against the cuDNN
               init (z and y).
 13. factorized  the factorized family (bls2017_rd, 192 filters) at full
               width, seeded weights: eval of three 512x768 f32 images, a B=8
               bf16 decode, GPU against CPU on a 192x256 crop (y and the
               prior's CDF logits to 1e-4, PSNR rtol 1e-3; the bpp and the
               count of elements where the prior's lo + up == 0 reported), 2
               train steps through train_lib.train_and_eval at B=8 256x256 and
               the train step's time, codec round trips of the three images
               bit-exact GPU to GPU, also across two processes through the
               CLI, the batch paths, the codec's times, and ITINF_FACTORIZED's
               SGA run (3000 steps, or 1000 if a step takes over 10 ms; f32
               transforms) with its val rd_loss at or below the amortized
               eval's. The family runs no Pallas kernel in JAX: none launches.
 14. families  two_layer_syn2 (CNN analysis 256 -> 320, TwoLayerSynthesis,
               mixedq) and mbt2018 at full width, seeded weights: eval of three
               images, a codec round trip, GPU against CPU on the 192x256 crop;
               two_layer_syn2's B=8 bf16 decode and 2 mixedq train steps.
               final_deconv_phase's count, zeroed and read around each path,
               equals two_layer_syn2's forwards; mbt2018 launches no kernel.
 15. int8      the int8 inference paths (ops/int8ops.py), seeded weights: the
               flagship's B=8 512x768 bf16 decode in float, int8_syn and
               int8_all (time by CUDA events, kernels' device time and count,
               final_deconv_phase's launches, the reconstruction against the
               float one; int8_syn's mu equal to float's); the k13s8 phase
               GEMM (torch._int_mm) exact against a float64 product of the
               same int8 operands, its conv equal to the CPU's bit for bit,
               its time beside its bound at 1979 TOPS and the bf16 phase
               conv's; a jpegl_rd (k18s16) int8 decode with the same check;
               the eval of the 3 images in the arms of scripts/int8_quality.py
               (f32, syn, all, enc, enc_syn; syn's bpp equal to f32's); the
               chain's precedence over SNTC_INT8_ENCODE; the codec: a float
               bitstream under an int8_syn decoder gives the same latent, ms
               per call, and the CLI's roundtrip --decode_dtype int8_syn.
 16. inference-extras  LPIPS (random weights) of the 3 images on the card
               against the CPU and its ms an image; ElicSynthesis at its
               default width on a 32x48x320 latent, chain off and on
               (fused_rb_chain launches counted), and TwoLayerResSynthesis
               (res_type="d2s") at the flagship's width, each on the card
               against the CPU.
Phase 11 also times the B=8 bf16 decodes of bls2017_rd, two_layer_syn2 and
mbt2018.
Then one JSON line of kernels, the nvidia-smi line, and the last line
{"ok": true, "device": {...}}. Any failed phase exits non-zero before that
line. Without CUDA, or without the port beside this script, it exits 1.
"""

import concurrent.futures
import contextlib
import copy
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

T0 = time.time()
H100_BYTES_PER_S = 3.35e12  # HBM3, NVIDIA data sheet (SXM)
# Dense peaks. A float32-accurate product runs faster on the tensor cores as
# 3xTF32 (three TF32 products, 495 TFLOP/s / 3) than on the CUDA cores (67
# TFLOP/s), so that is the least time the card needs for float32 work.
H100_PEAK_FLOPS = {"bfloat16": 989e12, "float32": 495e12 / 3}
H100_INT8_OPS = 1979e12  # dense int8 tensor-core peak (NVIDIA data sheet, SXM)
EVAL_HW = (512, 768)
DECODE_BATCH = 8
TRAIN_BATCH, TRAIN_HW, TRAIN_STEPS = 8, 256, 4
# The residual-block chains the flagship runs per forward, and their blocks.
CHAINS_PER_FORWARD, BLOCKS_PER_FORWARD = 7, 21
# ElicSynthesis's chains per forward: 2 attentions x 2, and 3 between deconvs.
ELIC_SYNTHESIS_CHAINS = 7
JPEGL_TRAIN_STEPS = 2


def log(phase, msg):
  print(f"[{phase} {time.time() - T0:7.1f}s] {msg}", flush=True)


def check(ok, msg):
  if not ok:
    raise RuntimeError(msg)


def cuda_ms(torch, fn, iters=50, warmup=5, host_ahead=False):
  """Mean time of fn() over `iters` back-to-back calls, by CUDA events.

  As called, the events measure what a caller waits per call: where the
  host takes longer to dispatch a call than the device to run it, that is
  the host's time. With host_ahead, the device is first held busy
  (torch.cuda._sleep) for longer than the host takes to enqueue all the
  calls, so they run back to back: the device time of the calls' kernels.
  """
  for _ in range(warmup):
    fn()
  torch.cuda.synchronize()
  start = torch.cuda.Event(enable_timing=True)
  end = torch.cuda.Event(enable_timing=True)
  if host_ahead:
    t = time.time()
    fn()
    torch.cuda.synchronize()
    # One synchronized call bounds its dispatch time; 2e9 cycles/s bounds the SM clock.
    torch.cuda._sleep(int(((time.time() - t) * iters * 1.5 + 2e-3) * 2e9))
  start.record()
  for _ in range(iters):
    fn()
  end.record()
  end.synchronize()
  return start.elapsed_time(end) / iters


def kernels_ms(torch, fn, iters=5):
  """(device time of fn()'s kernels in ms, device activities per call: kernels,
  copies and fills), both summed by torch.profiler over `iters` calls."""
  from torch.profiler import ProfilerActivity, profile

  with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
    for _ in range(iters):
      fn()
    torch.cuda.synchronize()
  events = [e for e in prof.key_averages() if e.device_type.name == "CUDA"]
  return (sum(e.self_device_time_total for e in events) / 1e3 / iters,
          sum(e.count for e in events) / iters)


def int8_gemm_bound_ms(m, k, n):
  """Least time for an int8 [M, K] x [K, N] -> int32 product: bytes (the two
  int8 operands read once, the int32 output written once) or operations
  (2 M K N at the int8 peak)."""
  t_bytes = (m * k + k * n + 4 * m * n) / H100_BYTES_PER_S * 1e3
  t_ops = 2 * m * k * n / H100_INT8_OPS * 1e3
  return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def final_deconv_bound_ms(mid_p, out, kernel, dtype_name):
  """Least time for final_deconv_phase on these inputs: bytes or operations.

  Bytes: mid read once, output written once, weights and bias once (in
  mid's type, as the kernel reads them).
  Operations: 2 * c_in * c_out per valid (output pixel, tap) pair, the valid
  taps counted exactly for this geometry (rows outside the image read none).
  """
  b, h, w, _ = mid_p.shape
  k, _, c_in, c_out = kernel.shape

  def taps(n_mid):  # valid taps summed over the 2*n_mid output positions of one axis
    p0 = k - 1 - max(k - 2, 0) // 2
    return sum(1 for o in range(2 * n_mid) for t in range(k)
               if (t - p0 + o % 2) % 2 == 0 and 0 <= o // 2 + (t - p0 + o % 2) // 2 < n_mid)

  n_bytes = (mid_p.numel() * mid_p.element_size() + out.numel() * out.element_size()
             + mid_p.element_size() * (kernel.numel() + c_out))
  flops = 2 * c_in * c_out * b * taps(8 * h) * taps(8 * w)
  t_bytes = n_bytes / H100_BYTES_PER_S * 1e3
  t_ops = flops / H100_PEAK_FLOPS[dtype_name] * 1e3
  return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def jpegl_bound_ms(z, out, kernel, dtype_name):
  """Least time for jpegl_synthesize on these inputs: bytes or operations.

  Bytes: z read once, the image written once, the weights and bias once
  (in z's dtype, as the model's). Operations: 2 C per output element.
  """
  k, _, c_in, c_out = kernel.shape
  n_bytes = (z.numel() * z.element_size() + out.numel() * out.element_size()
             + (kernel.numel() + c_out) * z.element_size())
  flops = 2 * c_in * out.numel()
  t_bytes = n_bytes / H100_BYTES_PER_S * 1e3
  t_ops = flops / H100_PEAK_FLOPS[dtype_name] * 1e3
  return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def rb_chain_bound_ms(x, n_blocks, dtype_name):
  """Least time for n_blocks residual blocks on x: bytes or operations.

  Bytes: x read once, the output written once, the float32 weights and
  biases once. Operations: per block and pixel 2 C Ch for each 1x1 conv,
  and 2 Ch^2 per 3x3 tap that lands inside the image ((3H-2)(3W-2) taps per
  image: SAME padding multiplies zeros at the edge, which is no work).
  """
  b, h, w, c = x.shape
  ch = c // 2
  n_weights = n_blocks * (c * ch + ch + 9 * ch * ch + ch + ch * c + c)
  n_bytes = 2 * x.numel() * x.element_size() + 4 * n_weights
  flops = n_blocks * b * (4 * c * ch * h * w + 2 * ch * ch * (3 * h - 2) * (3 * w - 2))
  t_bytes = n_bytes / H100_BYTES_PER_S * 1e3
  t_ops = flops / H100_PEAK_FLOPS[dtype_name] * 1e3
  return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


class switch_on:
  """Set an SNTC_* switch to "1" for a with-block; restore it after."""

  def __init__(self, name):
    self.name = name

  def __enter__(self):
    self.old = os.environ.get(self.name)
    os.environ[self.name] = "1"

  def __exit__(self, *exc):
    if self.old is None:
      os.environ.pop(self.name, None)
    else:
      os.environ[self.name] = self.old


def eval_y_hat(model, x, z=None, frozen_offset=None):
  """(y_hat, metrics) of the eval path (frame_loss, training=False) on image x
  (a device tensor), y_hat caught at the synthesis; z, when given, replaces
  the analysis's z."""
  import torch
  from shallow_ntc_tpu_torch.latents import LatentRVCollection, UQLatentRV

  caught = []
  with torch.no_grad():
    latents = model.infer_latent_rvs(x)
    if z is not None:
      latents = LatentRVCollection(uq=(UQLatentRV(loc=z), latents.uq[1]))
    synthesize = model.synthesize
    model.synthesize = lambda y_hat: caught.append(y_hat) or synthesize(y_hat)
    try:
      _, metrics, _ = model.frame_loss_given_latent_rvs(x, latents, training=False,
                                                        frozen_offset=frozen_offset)
    finally:
      del model.synthesize
  return caught[0].cpu().numpy(), {k: float(v) for k, v in metrics.items()}


def timed_compress(codec, x):
  """codec.compress(x) step by step: (blob, seconds in the device legs, in
  the host's symbol arithmetic and rANS). A device leg is dispatch, kernels
  and the copy back, timed to the host's wait for its result."""
  h, w = x.shape[1], x.shape[2]
  t0 = time.perf_counter()
  z, y = codec._fetch(*codec._analyze(x))()
  t1 = time.perf_counter()
  z_chunks, z_hat = codec._encode_z_host(z)
  t2 = time.perf_counter()
  mu, idx = codec._fetch(*codec._hyper_dec(z_hat))()
  t3 = time.perf_counter()
  blob, y_hat = codec._encode_y_host(z_chunks, y, mu, idx, h, w)
  t4 = time.perf_counter()
  codec._reconstruct(y_hat, h, w)
  t5 = time.perf_counter()
  return blob, (t1 - t0) + (t3 - t2) + (t5 - t4), (t2 - t1) + (t4 - t3)


def timed_decompress(codec, blob):
  """codec.decompress(blob) step by step: (image, device-leg seconds, host
  rANS seconds), as timed_compress."""
  t0 = time.perf_counter()
  h, w, z_hat, y_chunks = codec._decode_z_host(blob)
  t1 = time.perf_counter()
  mu, idx = codec._fetch(*codec._hyper_dec(z_hat))()
  t2 = time.perf_counter()
  y_hat = codec._decode_y_host(y_chunks, mu, idx)
  t3 = time.perf_counter()
  rec = codec._reconstruct(y_hat, h, w)
  t4 = time.perf_counter()
  return rec, (t2 - t1) + (t4 - t3), (t1 - t0) + (t3 - t2)


def codec_phase(model, model_cpu, images, zero_counts, read_counts, smi):
  """Phase 6: compress -> decompress of the flagship (float32, full width,
  seeded) on two 512x768 images and a 500x740 one, and of JPEGL_K16 on one;
  the decoded latent against the eval path's; compress and decompress in two
  processes through the CLI; the batch paths against the per-image path;
  one compress with the chain kernel; a GPU encode decoded on the CPU
  (reported); times. Returns the launch counts of the codec path."""
  import torch
  from shallow_ntc_tpu_torch import configs, eval_lib
  from shallow_ntc_tpu_torch.codec import api as codec_api
  from shallow_ntc_tpu_torch.models import base as models_base
  from shallow_ntc_tpu_torch.ops import jpegl_decode as jd
  from shallow_ntc_tpu_torch.ops import rb_chain as rb
  from shallow_ntc_tpu_torch.ops import twolayer_final as tl

  dev = next(model.parameters()).device

  phase = "codec"
  t = time.time()
  zero_counts()
  codec = codec_api.make_codec(model)
  table_s = time.time() - t
  offset = model.prior_quantization_offset().cpu().numpy()
  log(phase, f"flagship tables built in {table_s:.3f}s (factorized {codec.z_tables.channels} "
      f"channels, Gaussian {codec.y_tables.tables.num_tables} scales); the offset equals the "
      f"eval path's: {np.array_equal(offset, codec.z_tables.offset)}  [{smi}]")
  check(np.array_equal(offset, codec.z_tables.offset),
        "the codec's factorized offset differs from the eval path's")

  xs = [images[0], images[1], images[2][:500, :740]]
  counts = {"compress": [], "decompress": []}
  results, gaps = [], []
  for i, x in enumerate(xs):
    h, w = x.shape[:2]
    zero_counts()
    result = codec.compress(x)
    counts["compress"].append(read_counts())
    zero_counts()
    rec = codec.decompress(result.bitstring)
    counts["decompress"].append(read_counts())
    results.append(result)
    exact = (rec.dtype == np.uint8 and rec.shape == (h, w, 3)
             and np.array_equal(rec, result.reconstruction))
    # The decoded latent against the eval path's, run under the codec's
    # numerics from the encoder's latents (z on its coding grid, as the
    # decoder rebuilds it): equal exactly. From the analysis's own z the
    # eval's straight-through round lands an ulp off k + o in some elements,
    # and y_hat moves by an ulp there: reported.
    _, _, y_hat = codec.decode_latent(result.bitstring)
    x_dev = torch.from_numpy(x[None]).to(dev)
    z, _ = codec._fetch(*codec._analyze(x[None]))()
    z_grid = codec.z_tables.latent_from_symbols(codec.z_tables.symbols_from_latent(z))
    with codec_api.coding_numerics():
      y_eval, metrics = eval_y_hat(model, x_dev, torch.from_numpy(z_grid).to(dev),
                                   frozen_offset=torch.from_numpy(offset).to(dev))
      y_raw, _ = eval_y_hat(model, x_dev, frozen_offset=torch.from_numpy(offset).to(dev))
    gaps.append((result.bpp, metrics["bpp"]))
    log(phase, f"flagship {h}x{w}: {len(result.bitstring)} bytes, bpp {result.bpp:.5f} against "
        f"the likelihood's {metrics['bpp']:.5f} (gap {result.bpp / metrics['bpp'] - 1:+.4%}); "
        f"streams {codec_api.stream_counts(result.bitstring)}; decoder's image bit-exact: "
        f"{exact}; decoded y_hat equals the eval path's from the encoder's latents: "
        f"{np.array_equal(y_eval, y_hat)}, from the analysis's z: {np.mean(y_raw == y_hat):.6f} "
        f"equal, max|diff| {np.abs(y_raw - y_hat).max():.3e}; launches compress "
        f"{counts['compress'][-1]}, decompress {counts['decompress'][-1]}")
    check(exact, f"flagship {h}x{w}: the decoder's image differs from the encoder's")
    check(np.array_equal(y_eval, y_hat), f"flagship {h}x{w}: the decoded y_hat differs from the "
          "eval path's")
    check(counts["decompress"][-1][tl.STATS.name] >= 1,
          "a decompress did not launch final_deconv_phase")

  # Compress in one process and decompress in another, through the CLI, on
  # the same seeded weights; against this process's codec.
  raw = np.round((images[0] + 0.5) * 255.0).astype(np.uint8)
  x_cli = models_base.normalize_image(raw.astype(np.float32))
  root = os.path.dirname(os.path.abspath(__file__))
  with tempfile.TemporaryDirectory(prefix="chip_smoke_codec_") as tmp:
    np.save(os.path.join(tmp, "img.npy"), raw)
    t = time.time()
    for argv in (["compress", "--input", "img.npy", "--output", "img.sntc"],
                 ["decompress", "--input", "img.sntc", "--output", "rec.npy"]):
      proc = subprocess.run([sys.executable, "-m", "shallow_ntc_tpu_torch.compress", *argv,
                             "--init_seed", "0", "--device", dev.type], cwd=tmp, capture_output=True, text=True,
                            timeout=300, env=dict(os.environ, PYTHONPATH=root))
      check(proc.returncode == 0, f"the compress CLI failed: {proc.stderr[-2000:]}")
      log(phase, f"CLI {argv[0]}: {proc.stdout.strip()}")
    with open(os.path.join(tmp, "img.sntc"), "rb") as f:
      cli_blob = f.read()
    cli_rec = np.load(os.path.join(tmp, "rec.npy"))
  ref = codec.compress(x_cli)
  same = cli_blob == ref.bitstring and np.array_equal(cli_rec, ref.reconstruction)
  log(phase, f"compress and decompress in two processes (CLI, {time.time() - t:.1f}s): bytes "
      f"and image equal to this process's: {same}")
  check(same, "the CLI's two processes disagree with the in-process codec")

  # The batch paths against the per-image path.
  t = time.time()
  batch = codec.compress_batch(xs, reconstruct=True)
  batch_c_s = time.time() - t
  blobs = [r.bitstring for r in results]
  t = time.time()
  strict = codec.decompress_batch(blobs, strict=True)
  t1 = time.time()
  loose = codec.decompress_batch(blobs)
  batch_d_s = time.time() - t1
  diffs = [int(np.abs(b.reconstruction.astype(int) - r.reconstruction).max())
           for b, r in zip(batch, results)]
  loose_diffs = [int(np.abs(d.astype(int) - r.reconstruction).max())
                 for d, r in zip(loose, results)]
  held = ([b.bitstring for b in batch] == blobs and max(diffs + loose_diffs) <= 1
          and all(np.array_equal(d, r.reconstruction) for d, r in zip(strict, results)))
  log(phase, f"batch paths on the 3 images: bitstreams equal {[b.bitstring for b in batch] == blobs}"
      f", reconstructions max|diff| {diffs} (tol 1), decompress_batch strict equal "
      f"{all(np.array_equal(d, r.reconstruction) for d, r in zip(strict, results))}, loose "
      f"max|diff| {loose_diffs} (tol 1); compress_batch {batch_c_s:.3f}s, decompress_batch "
      f"{batch_d_s:.3f}s (strict {t1 - t:.3f}s)")
  check(held, "the batch paths disagree with the per-image path")

  # One compress with the residual blocks as the chain kernel.
  with switch_on("SNTC_FUSED_RB_CHAIN"):
    zero_counts()
    chain = codec.compress(xs[0])
    chain_counts = read_counts()
  exact = np.array_equal(codec.decompress(chain.bitstring), chain.reconstruction)
  log(phase, f"compress with SNTC_FUSED_RB_CHAIN=1: {len(chain.bitstring)} bytes (cuDNN route "
      f"{len(results[0].bitstring)}), launches {chain_counts}; decodes bit-exact: {exact}")
  check(chain_counts[rb.STATS.name] == CHAINS_PER_FORWARD and exact,
        f"the chain compress launched {chain_counts} or decoded otherwise")

  # GPU encode, CPU decode: reported, not held (the factorized tables and
  # mu may differ in the last bit across devices; PERF_NOTES.md).
  t = time.time()
  codec_cpu = codec_api.make_codec(model_cpu)
  zt_gpu, zt_cpu = codec.z_tables, codec_cpu.z_tables
  if np.array_equal(zt_gpu.tables.sizes, zt_cpu.tables.sizes):
    cdf_diff = np.abs(zt_gpu.tables.cdfs.astype(np.int64) - zt_cpu.tables.cdfs.astype(np.int64))
    tables_diff = (f"{np.count_nonzero(cdf_diff)} of {cdf_diff.size} CDF entries differ (max "
                   f"{cdf_diff.max()} of 65536)")
  else:
    tables_diff = "the table sizes differ"
  offsets_diff = float(np.abs(zt_gpu.offset - zt_cpu.offset).max())
  try:
    z_cpu = codec_cpu._decode_z_host(results[0].bitstring)[2]
    z_gpu = codec._decode_z_host(results[0].bitstring)[2]
    rec_cpu = codec_cpu.decompress(results[0].bitstring)
    interop = (f"bit-exact {np.array_equal(rec_cpu, results[0].reconstruction)}, "
               f"{np.mean(rec_cpu == results[0].reconstruction):.6f} of image values and "
               f"{np.mean(z_cpu == z_gpu):.6f} of z_hat equal")
  except RuntimeError as e:  # a desynchronized stream may fail to decode
    interop = f"decode failed ({e})"
  log(phase, f"GPU encode -> CPU decode of image 0 (reported): {interop}; factorized tables "
      f"across devices: {tables_diff}, offsets max|diff| {offsets_diff:.3e}; "
      f"{time.time() - t:.1f}s")

  # Times at 512x768 after a warm-up: each call, and its parts.
  reps = 10
  for _ in range(2):
    codec.decompress(codec.compress(xs[0]).bitstring)
  c_parts = [timed_compress(codec, xs[0][None]) for _ in range(reps)]
  d_parts = [timed_decompress(codec, blobs[0]) for _ in range(reps)]
  check(all(p[0] == blobs[0] for p in c_parts)
        and all(np.array_equal(p[0], results[0].reconstruction) for p in d_parts),
        "the timed steps differ from compress / decompress")
  t = time.perf_counter()
  for _ in range(reps):
    codec.compress(xs[0])
  c_ms = (time.perf_counter() - t) / reps * 1e3
  t = time.perf_counter()
  for _ in range(reps):
    codec.decompress(blobs[0])
  d_ms = (time.perf_counter() - t) / reps * 1e3
  timing = dict(
      compress_ms=c_ms, decompress_ms=d_ms,
      compress_device_ms=float(np.mean([p[1] for p in c_parts])) * 1e3,
      compress_host_rans_ms=float(np.mean([p[2] for p in c_parts])) * 1e3,
      decompress_device_ms=float(np.mean([p[1] for p in d_parts])) * 1e3,
      decompress_host_rans_ms=float(np.mean([p[2] for p in d_parts])) * 1e3,
      table_build_s=table_s)
  log(phase, f"flagship 512x768, mean of {reps} after a warm-up: compress {c_ms:.2f} ms (device "
      f"legs {timing['compress_device_ms']:.2f}, host rANS {timing['compress_host_rans_ms']:.2f}),"
      f" decompress {d_ms:.2f} ms (device legs {timing['decompress_device_ms']:.2f}, host rANS "
      f"{timing['decompress_host_rans_ms']:.2f}); tables {table_s:.3f}s; bpp against likelihood "
      + ", ".join(f"{a:.5f}/{b:.5f}" for a, b in gaps) + f"  [{smi}]")

  # JPEGL_K16: the same codec on the JPEG-like model, through jpegl_synthesize.
  m16 = eval_lib.build_model(configs.JPEGL_K16, init_seed=0, device=dev)
  codec16 = codec_api.make_codec(m16)
  zero_counts()
  r16 = codec16.compress(xs[0])
  k16_compress = read_counts()
  zero_counts()
  rec16 = codec16.decompress(r16.bitstring)
  k16_decompress = read_counts()
  exact = np.array_equal(rec16, r16.reconstruction)
  log(phase, f"JPEGL_K16 512x768: {len(r16.bitstring)} bytes, bpp {r16.bpp:.5f}; bit-exact "
      f"{exact}; launches compress {k16_compress}, decompress {k16_decompress}")
  check(exact, "JPEGL_K16: the decoder's image differs from the encoder's")
  check(k16_decompress[jd.STATS.name] >= 1, "the K16 decompress did not launch jpegl_synthesize")
  summary = dict(flagship_compress=counts["compress"][0],
                 flagship_decompress=counts["decompress"][0], chain_compress=chain_counts,
                 k16_compress=k16_compress, k16_decompress=k16_decompress, timing=timing,
                 bpp_vs_likelihood=[list(g) for g in gaps], gpu_to_cpu=interop, nvidia_smi=smi)
  log(phase, "summary " + json.dumps(summary))
  return summary


ITINF_REFERENCE_STEPS = 3
ITINF_BF16_STEPS = 300


def itinf_phase(image, zero_counts, read_counts, smi):
  """Phase 12: SGA iterative inference of the flagship (configs.ITINF) on one
  512x768 image at full width, seeded weights: the card against the CPU for
  3 steps; ms per step; the config's run; 300 steps with bf16 transforms;
  an init with the chain kernel. Returns the launch counts and times."""
  import itertools

  import torch
  from shallow_ntc_tpu_torch import configs, eval_lib, itinf_lib
  from shallow_ntc_tpu_torch.ops import rb_chain as rb
  from shallow_ntc_tpu_torch.ops import twolayer_final as tl

  phase = "itinf"
  cfg = copy.deepcopy(configs.ITINF)
  opt_cfg = cfg["model_config"]["optimizer_config"]
  te = cfg["train_eval_config"]
  x_np = image[None]
  t = time.time()
  models = {d: eval_lib.build_model(cfg["model_config"], init_seed=0, device=d)
            for d in ("cuda", "cpu")}
  model = models["cuda"]
  xs = {d: torch.from_numpy(x_np).to(d) for d in models}

  # GPU against CPU: 3 SGA steps from the CPU's latents with the same
  # logistic draws, float32, TF32 off. Latents: each element within 0.05 *
  # the sum of the steps' lr (Adam moves an element by ~lr whatever the size
  # of its gradient, so a gradient whose last bits differ moves it by a
  # fraction of lr), or else, listed, the difference's L2 within 1e-2 of the
  # L2 of the latent's movement (a gradient within rounding of 0 may take
  # the other sign on the other device, and Adam's first step moves that
  # element by lr either way); rd_loss, bpp and PSNR of each step rtol 1e-4.
  fns = {d: itinf_lib.make_itinf_functions(m, opt_cfg, te["num_steps"])
         for d, m in models.items()}
  state = {d: fns[d].init(xs[d]) for d in models}
  failures = []
  for name, a, b in zip(("z", "y"), state["cuda"][0].uq, state["cpu"][0].uq):
    err = (a.loc.detach().cpu() - b.loc.detach()).abs().max().item()
    scale = b.loc.abs().max().item()
    log(phase, f"init {name}: max|gpu-cpu| {err:.3e}, max|cpu| {scale:.3f} "
        "(tol 1e-4 * max(1, max|cpu|))")
    if err > 1e-4 * max(1.0, scale):
      failures.append(f"init {name}")
  with torch.no_grad():
    for a, b in zip(state["cuda"][0].uq, state["cpu"][0].uq):
      a.loc.copy_(b.loc)
  init = [rv.loc.detach().clone() for rv in state["cpu"][0].uq]
  draw_rng = np.random.default_rng(21)
  lr_sum = 0.0
  for step in range(ITINF_REFERENCE_STEPS):
    draws = [draw_rng.logistic(size=tuple(v.shape)).astype(np.float32) for v in init]
    m = {d: fns[d].step(xs[d], *state[d], step, None,
                        noise=tuple(torch.from_numpy(n).to(d) for n in draws))
         for d in models}
    lr_sum += float(m["cpu"]["scheduled_lr"])
    for key in ("rd_loss", "bpp", "psnr"):
      gpu_v, cpu_v = float(m["cuda"][key]), float(m["cpu"][key])
      rel = abs(gpu_v - cpu_v) / abs(cpu_v)
      log(phase, f"step {step} {key}: gpu {gpu_v:.6f} cpu {cpu_v:.6f} rel {rel:.2e} (tol 1e-4)")
      if rel > 1e-4:
        failures.append(f"step {step} {key}")
    for name, a, b, b0 in zip(("z", "y"), state["cuda"][0].uq, state["cpu"][0].uq, init):
      diff = (a.loc.detach().cpu() - b.loc.detach()).abs()
      tol = 0.05 * lr_sum
      beyond = int((diff > tol).sum())
      l2_rel = (diff.norm() / (b.loc.detach() - b0).norm()).item()
      log(phase, f"step {step} latent {name}: max|gpu-cpu| {diff.max().item():.3e} (tol "
          f"{tol:.3e}); {beyond} of {diff.numel()} elements past it, L2 of the difference / "
          f"L2 of the movement {l2_rel:.2e} (fallback tol 1e-2)")
      if beyond and l2_rel > 1e-2:
        failures.append(f"step {step} latent {name}")
  log(phase, f"GPU against CPU, {ITINF_REFERENCE_STEPS} steps at {EVAL_HW[0]}x{EVAL_HW[1]} "
      f"f32: done in {time.time() - t:.1f}s")
  check(not failures, f"the GPU SGA steps disagree with the CPU's: {failures}")
  del models["cpu"], fns, state

  # ms per SGA step by CUDA events, what a caller waits, beside the device
  # time of its kernels summed by torch.profiler over 5 steps. (cuda_ms's
  # host_ahead cannot hold the host ahead of ~500 launches a step: the
  # CUDA launch queue fills, and the host waits for the device.)
  def time_step(dtype, tf32):
    model.transforms_dtype = dtype
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = tf32
    try:
      f = itinf_lib.make_itinf_functions(model, opt_cfg, te["num_steps"])
      latents, optimizer = f.init(xs["cuda"])
      gen = torch.Generator(device=xs["cuda"].device)
      count = itertools.count()

      def one_step():
        s = next(count)
        f.step(xs["cuda"], latents, optimizer, s, None,
               generator=itinf_lib.seed_step(gen, 0, s))

      call = cuda_ms(torch, one_step, iters=30, warmup=5)
      device = kernels_ms(torch, one_step)[0]
    finally:
      model.transforms_dtype = None
      torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    return dict(ms=call, device_ms=device)

  step_times = {}
  for dtype_name, dtype in (("float32", None), ("bfloat16", torch.bfloat16)):
    for tf32 in (False, True):
      key = f"{dtype_name} transforms, TF32 {'on' if tf32 else 'off'}"
      step_times[key] = time_step(dtype, tf32)
      log(phase, f"SGA step {EVAL_HW[0]}x{EVAL_HW[1]} {key}: {step_times[key]['ms']:.4f} ms "
          f"a step by CUDA events; its kernels {step_times[key]['device_ms']:.4f} ms (busy "
          f"share {step_times[key]['device_ms'] / step_times[key]['ms']:.3f})  [{smi}]")

  # The config's run: float32 transforms, TF32 off, the chain kernel in the
  # init's analysis. 3000 steps, or 1000 (with the schedules over 1000) if a
  # step takes over 10 ms.
  f32_ms = step_times["float32 transforms, TF32 off"]["ms"]
  n_steps = te["num_steps"] if f32_ms <= 10.0 else 1000
  if n_steps != te["num_steps"]:
    model.scheduled_num_steps = n_steps
    log(phase, f"a float32 step takes {f32_ms:.3f} ms > 10 ms: the config's run takes "
        f"{n_steps} steps, scheduled over {n_steps}")
  run_cfg = dict(te, num_steps=n_steps)
  val_passes = -(-n_steps // run_cfg["eval_every_steps"])
  # The amortized eval at a step past the rd-lambda warm-up (which SGA never
  # takes), so both rd_losses weigh the distortion by the same lambda.
  amortized_m = next(eval_lib.evaluate_images(model, x_np, step=model.scheduled_num_steps))
  amortized = amortized_m["rd_loss"]
  with tempfile.TemporaryDirectory(prefix="chip_smoke_itinf_") as workdir:
    zero_counts()
    t = time.time()
    with switch_on("SNTC_FUSED_RB_CHAIN"):
      train_m, val_m, itinf_vars = itinf_lib.itinf_on_data_batch(
          model, x_np, run_cfg, opt_cfg, workdir=workdir, seed=0)
    torch.cuda.synchronize()
    run_s = time.time() - t
    counts = read_counts()
    with open(os.path.join(workdir, "train", "record.jsonl")) as f:
      rows = [json.loads(line) for line in f]
  for r in rows:
    log(phase, f"step {r['step']}: rd_loss {r['rd_loss']:.5f} bpp {r['bpp']:.5f} "
        f"psnr {r['psnr']:.4f} tau {r['tau']:.5f} scheduled_lr {r['scheduled_lr']:.2e}")
  log(phase, f"the config's run, {n_steps} steps of {EVAL_HW[0]}x{EVAL_HW[1]} f32 in "
      f"{run_s:.2f}s (init, steps, {val_passes} val pass): val rd_loss {val_m['rd_loss']:.5f} "
      f"bpp {val_m['bpp']:.5f} psnr {val_m['psnr']:.4f} msssim {val_m['msssim']:.5f} against "
      f"the amortized rd_loss {amortized:.5f}; launches {counts}  [{smi}]")
  log_every = run_cfg["log_metrics_every_steps"]
  check(all(np.isfinite(v) for r in rows + [val_m] for v in r.values())
        and [r["step"] for r in rows] == [min((i + 1) * log_every, n_steps)
                                          for i in range(-(-n_steps // log_every))],
        "the SGA log rows are missing or not finite")
  check(all(v.dtype == np.float32 for v in itinf_vars.values()), "the latents are not float32")
  check(amortized_m["sched_rd_lambda"] == val_m["sched_rd_lambda"],
        f"the amortized eval's lambda {amortized_m['sched_rd_lambda']} is not SGA's")
  check(val_m["rd_loss"] <= amortized,
        f"SGA did not improve on the amortized rd_loss: {val_m['rd_loss']} > {amortized}")
  check(counts[tl.STATS.name] == n_steps + val_passes,
        f"final_deconv_phase ran {counts[tl.STATS.name]} times in {n_steps} steps and "
        f"{val_passes} val passes")
  check(counts[rb.STATS.name] == CHAINS_PER_FORWARD,
        f"the init's analysis ran the chain kernel {counts[rb.STATS.name]} times")
  model.scheduled_num_steps = cfg["model_config"]["scheduled_num_steps"]

  # 300 steps with bf16 transforms: val rd_loss within 1.05x the amortized
  # (bf16) rd_loss, as the JAX package's bf16 test holds it.
  model.transforms_dtype = torch.bfloat16
  amortized_bf16 = next(eval_lib.evaluate_images(
      model, x_np, step=model.scheduled_num_steps))["rd_loss"]
  zero_counts()
  t = time.time()
  _, val_bf16, _ = itinf_lib.itinf_on_data_batch(
      model, x_np, dict(te, num_steps=ITINF_BF16_STEPS), opt_cfg, seed=0)
  torch.cuda.synchronize()
  bf16_s = time.time() - t
  bf16_counts = read_counts()
  model.transforms_dtype = None
  log(phase, f"{ITINF_BF16_STEPS} steps with bf16 transforms in {bf16_s:.2f}s: val rd_loss "
      f"{val_bf16['rd_loss']:.5f} against the amortized {amortized_bf16:.5f} (tol x1.05); "
      f"launches {bf16_counts}")
  check(val_bf16["rd_loss"] <= 1.05 * amortized_bf16,
        f"bf16 SGA: {val_bf16['rd_loss']} > 1.05 x {amortized_bf16}")
  check(bf16_counts[tl.STATS.name] == ITINF_BF16_STEPS + 1,
        f"bf16 SGA launched final_deconv_phase {bf16_counts[tl.STATS.name]} times")

  # An init with the chain kernel against the cuDNN init: z and y within
  # 1e-4 * max(1, max|cudnn|), as phase 4 holds them.
  f = itinf_lib.make_itinf_functions(model, opt_cfg, te["num_steps"])
  zero_counts()
  with switch_on("SNTC_FUSED_RB_CHAIN"):
    chain_latents, _ = f.init(xs["cuda"])
  chain_counts = read_counts()
  cudnn_latents, _ = f.init(xs["cuda"])
  for name, a, b in zip(("z", "y"), chain_latents.uq, cudnn_latents.uq):
    err = (a.loc - b.loc).abs().max().item()
    scale = b.loc.abs().max().item()
    log(phase, f"init {name}: chain vs cudnn max|err| {err:.3e}, max|cudnn| {scale:.3f} "
        "(tol 1e-4 * max(1, max|cudnn|))")
    check(err <= 1e-4 * max(1.0, scale), f"the chain init disagrees on {name}")
  check(chain_counts[rb.STATS.name] == CHAINS_PER_FORWARD,
        f"an init with SNTC_FUSED_RB_CHAIN=1 launched {chain_counts}")
  summary = dict(steps=n_steps, val_passes=val_passes, launches=counts,
                 bf16_launches=bf16_counts, chain_init_launches=chain_counts,
                 step_ms=step_times, seconds_per_image=run_s, bf16_seconds=bf16_s,
                 val_rd_loss=val_m["rd_loss"], amortized_rd_loss=amortized,
                 val_rd_loss_bf16=val_bf16["rd_loss"], amortized_rd_loss_bf16=amortized_bf16,
                 nvidia_smi=smi)
  log(phase, "summary " + json.dumps(summary))
  return summary


def make_reference(small, zero_counts, read_counts):
  """The GPU-against-CPU check of phases 5, 9, 13 and 14 on the crop `small`."""
  import torch
  from shallow_ntc_tpu_torch.latents import LatentRVCollection, UQLatentRV

  dev = torch.device("cuda")

  def reference(phase, model_gpu, model_cpu):
    """GPU eval of the 192x256 crop against the CPU eval; return the GPU
    launch counts of the part from the same latents on. Either family: the
    prior's latent is z for mshyper and y for factorized, whose total rate
    is the prior's and so only reported; where the offset heuristic is off
    the prior's grid is the integers."""
    t = time.time()
    failures = []

    def compare(name, gpu_t, cpu_t):
      err = (gpu_t.cpu() - cpu_t).abs().max().item()
      scale = cpu_t.abs().max().item()
      log(phase, f"192x256 {name}: max|gpu-cpu| {err:.3e}, max|cpu| {scale:.3f} "
          f"(tol 1e-4 * max(1, max|cpu|))")
      if err > 1e-4 * max(1.0, scale):
        failures.append(name)

    with torch.no_grad():
      rv_cpu = model_cpu.infer_latent_rvs(small)
      rv_gpu = model_gpu.infer_latent_rvs(small.to(dev))
      names = ("z", "y")[-len(rv_cpu.uq):]
      for name, a, b in zip(names, rv_gpu.uq, rv_cpu.uq):
        compare(name, a.loc, b.loc)
      z_off = model_cpu.prior_quantization_offset()
      z_q = torch.round(rv_cpu.uq[0].loc - (0.0 if z_off is None else z_off))
      z_q = z_q if z_off is None else z_q + z_off
      sums = []
      for shift in (-0.5, 0.5):
        logits = (model_gpu._prior.logits_cdf(z_q.to(dev) + shift).cpu(),
                  model_cpu._prior.logits_cdf(z_q + shift))
        compare(f"prior logits at {names[0]}_hat{shift:+.1f}", *logits)
        sums.append(logits)
      floored = [int(((sums[0][i] + sums[1][i]) == 0).sum()) for i in (0, 1)]
      log(phase, f"192x256 elements of {names[0]}_hat where the prior's lo + up == 0 (the sign "
          f"trick's floor): gpu {floored[0]}, cpu {floored[1]} of {z_q.numel()}")
      same = LatentRVCollection(uq=tuple(UQLatentRV(loc=r.loc.to(dev)) for r in rv_cpu.uq))
      zero_counts()
      _, m_gpu, rec_gpu = model_gpu.frame_loss_given_latent_rvs(small.to(dev), same)
      counts = read_counts()
      _, m_cpu, rec_cpu = model_cpu.frame_loss_given_latent_rvs(small, rv_cpu)
    for key in ("latent_bpp", "psnr", "hyper_latent_bpp", "bpp"):
      if key not in m_cpu:
        continue
      gpu_v, cpu_v = float(m_gpu[key]), float(m_cpu[key])
      rel = abs(gpu_v - cpu_v) / abs(cpu_v)
      held = key in ("latent_bpp", "psnr")
      log(phase, f"192x256 {key}: gpu {gpu_v:.6f} cpu {cpu_v:.6f} rel {rel:.2e} "
          + ("(tol 1e-3)" if held else "(reported: includes the floored elements)"))
      if held and rel > 1e-3:
        failures.append(key)
    same_px = (rec_gpu.cpu() == rec_cpu).float().mean().item()
    log(phase, f"192x256 reconstruction: {same_px:.6f} of pixels equal on the 255 grid "
        f"(tol 0.99); GPU launches from the latents on {counts}; done in {time.time() - t:.1f}s")
    check(same_px >= 0.99 and not failures, f"GPU eval disagrees with the CPU eval: {failures}")
    return counts

  return reference


def make_decode(model, y_hat, z_hat):
  """The B=8 decode of a model as a function: the hyper-synthesis of z_hat
  (mshyper) and the synthesis of y_hat."""
  import torch

  def decode():
    with torch.no_grad():
      if hasattr(model, "hyper_synthesize"):
        mu, idx = model.hyper_synthesize(z_hat)
        return mu, idx, model.synthesize(y_hat)
      return None, None, model.synthesize(y_hat)

  return decode


def check_decode(name, out, y_hat):
  import torch

  mu, idx, rec = out
  b, h, w, _ = y_hat.shape
  check(rec.shape == (b, 16 * h, 16 * w, 3) and torch.isfinite(rec).all().item()
        and (mu is None or (mu.shape == y_hat.shape and torch.isfinite(idx).all().item())),
        f"the {name} decode output has the wrong shape or is not finite")


def train_two_steps(phase, name, family, zero_counts, read_counts, steps, all_move=True):
  """`steps` steps of a TRAIN_CONFIGS entry through train_lib.train_and_eval at
  B=8 256x256 f32 and its final eval: losses finite, every parameter moved
  (with all_move=False: some moved, the rest listed). Returns (launch
  counts, number of forwards)."""
  import torch
  from shallow_ntc_tpu_torch import configs, train_lib

  cfg = copy.deepcopy(configs.TRAIN_CONFIGS[name])
  cfg["train_eval_config"]["log_metrics_every_steps"] = 1
  with tempfile.TemporaryDirectory(prefix=f"chip_smoke_train_{name}_") as workdir:
    zero_counts()
    t = time.time()
    state = train_lib.train_and_eval(cfg, workdir, device="cuda", init_seed=0, num_steps=steps)
    counts = read_counts()
    with open(os.path.join(workdir, "train", "record.jsonl")) as f:
      rows = [json.loads(line) for line in f]
    with open(os.path.join(workdir, "val", "record.jsonl")) as f:
      val = [json.loads(line) for line in f]
  for r in rows:
    log(phase, f"{name} step {r['step']}: rd_loss {r['rd_loss']:.5f} bpp {r['bpp']:.5f} "
        f"psnr {r['psnr']:.4f} steps/s {r['steps_per_sec']:.3f}")
  forwards = steps + cfg["train_eval_config"]["max_validation_steps"]
  log(phase, f"{name}: val rd_loss {val[-1]['rd_loss']:.5f}; {steps} steps of B={TRAIN_BATCH} "
      f"{TRAIN_HW}x{TRAIN_HW} f32 + val ({forwards} forwards) in {time.time() - t:.1f}s; "
      f"launches {counts}")
  check([r["step"] for r in rows] == list(range(1, steps + 1))
        and all(np.isfinite(v) for r in rows + val for v in r.values()),
        f"a {name} train step's metrics are missing or not finite")
  init, _ = train_lib.build_model(cfg["model_config"], init_seed=0, device="cuda", family=family)
  unmoved = [k for k, v in init.state_dict().items()
             if torch.equal(v, state.model.state_dict()[k])]
  log(phase, f"{name}: {len(unmoved)} of {len(init.state_dict())} parameter tensors unchanged"
      + (f" ({unmoved})" if unmoved else ""))
  check(not unmoved or (not all_move and len(unmoved) < len(init.state_dict())),
        f"{name} parameters did not move: {unmoved[:5]}")
  return counts, forwards


def timed_factorized_compress(codec, x):
  """FactorizedCodec.compress step by step: (blob, device-leg seconds, host
  rANS seconds), as timed_compress."""
  h, w = x.shape[1], x.shape[2]
  t0 = time.perf_counter()
  (y,) = codec._fetch(codec._analyze(x))()
  t1 = time.perf_counter()
  blob, y_hat = codec._encode_host(y, h, w)
  t2 = time.perf_counter()
  codec._reconstruct(y_hat, h, w)
  t3 = time.perf_counter()
  return blob, (t1 - t0) + (t3 - t2), t2 - t1


def timed_factorized_decompress(codec, blob):
  t0 = time.perf_counter()
  h, w, y_hat = codec.decode_latent(blob)
  t1 = time.perf_counter()
  rec = codec._reconstruct(y_hat, h, w)
  t2 = time.perf_counter()
  return rec, t2 - t1, t1 - t0


def cli_roundtrip(phase, config, raw, dev):
  """Compress in one process and decompress in another through the codec
  CLI (--init_seed 0); returns (blob, image)."""
  root = os.path.dirname(os.path.abspath(__file__))
  with tempfile.TemporaryDirectory(prefix="chip_smoke_cli_") as tmp:
    np.save(os.path.join(tmp, "img.npy"), raw)
    t = time.time()
    for argv in (["compress", "--input", "img.npy", "--output", "img.sntc"],
                 ["decompress", "--input", "img.sntc", "--output", "rec.npy"]):
      proc = subprocess.run([sys.executable, "-m", "shallow_ntc_tpu_torch.compress", *argv,
                             "--config", config, "--init_seed", "0", "--device", dev.type],
                            cwd=tmp, capture_output=True, text=True, timeout=300,
                            env=dict(os.environ, PYTHONPATH=root))
      check(proc.returncode == 0, f"the compress CLI failed: {proc.stderr[-2000:]}")
      log(phase, f"CLI --config {config} {argv[0]}: {proc.stdout.strip()}")
    with open(os.path.join(tmp, "img.sntc"), "rb") as f:
      blob = f.read()
    rec = np.load(os.path.join(tmp, "rec.npy"))
  log(phase, f"CLI in two processes: {time.time() - t:.1f}s")
  return blob, rec


FACTORIZED_TRAIN_STEPS = 2


def factorized_phase(images, zero_counts, read_counts, smi, reference):
  """Phase 13: the factorized family at full width (bls2017_rd, 192 filters),
  seeded weights: eval of three 512x768 f32 images, a B=8 bf16 decode, GPU
  against CPU on a 192x256 crop, 2 train steps through train_and_eval and
  the train step's time, codec round trips (also through the CLI in two
  processes) and their times, and ITINF_FACTORIZED's SGA run. The family
  runs no Pallas kernel in JAX, so no kernel of the port launches here.
  Returns the phase's numbers."""
  import itertools

  import torch
  from shallow_ntc_tpu_torch import configs, eval_lib, itinf_lib, train_lib
  from shallow_ntc_tpu_torch.codec import api as codec_api
  from shallow_ntc_tpu_torch.models import base as models_base

  phase = "factorized"
  dev = torch.device("cuda")
  cfg, _, family = configs.eval_config("bls2017_rd")
  model = eval_lib.build_model(cfg, init_seed=0, device="cuda", family=family)
  n_params = sum(p.numel() for p in model.parameters())
  zero_counts()
  t = time.time()
  records = list(eval_lib.evaluate_images(model, images))
  torch.cuda.synchronize()
  eval_s = time.time() - t
  counts = {"eval": read_counts()}
  for i, r in enumerate(records):
    log(phase, f"bls2017_rd image {i} {EVAL_HW[0]}x{EVAL_HW[1]}: bpp {r['bpp']:.5f} psnr "
        f"{r['psnr']:.4f} msssim {r['msssim']:.5f} rd_loss {r['rd_loss']:.5f}")
  log(phase, f"bls2017_rd, {n_params} params: {len(records)} images in {eval_s:.2f}s; launches "
      f"{counts['eval']}")
  check(all(np.isfinite(r[k]) for r in records for k in ("bpp", "psnr", "msssim", "rd_loss"))
        and "latent_bpp" not in records[0], "bls2017_rd eval metrics not finite, or two rates")

  d_rng = np.random.default_rng(14)
  mh, mw = EVAL_HW[0] // 16, EVAL_HW[1] // 16
  y_hat = torch.from_numpy(d_rng.integers(-8, 8, (DECODE_BATCH, mh, mw, 192))).to(
      dev, torch.bfloat16)
  m16 = eval_lib.build_model(cfg, init_seed=0, device="cuda", family=family).to(torch.bfloat16)
  zero_counts()
  check_decode("bls2017_rd", make_decode(m16, y_hat, None)(), y_hat)
  counts["decode"] = read_counts()
  log(phase, f"bls2017_rd decode B={DECODE_BATCH} {EVAL_HW[0]}x{EVAL_HW[1]} bf16: shape and "
      f"values held; launches {counts['decode']}")
  del m16

  model_cpu = eval_lib.build_model(cfg, init_seed=0, device="cpu", family=family)
  reference(phase, model, model_cpu)

  counts["train"], _ = train_two_steps(phase, "bls2017_rd", family, zero_counts, read_counts,
                                       FACTORIZED_TRAIN_STEPS)
  t_model, opt_cfg = train_lib.build_model(configs.TRAIN_CONFIGS["bls2017_rd"]["model_config"],
                                           init_seed=0, device="cuda", family=family)
  t_state, lr_fn = train_lib.create_train_state(t_model, opt_cfg)
  t_step = train_lib.make_train_step(t_model, t_state.optimizer, lr_fn)
  t_batch = torch.from_numpy((d_rng.integers(0, 256, (TRAIN_BATCH, TRAIN_HW, TRAIN_HW, 3))
                              / 255.0 - 0.5).astype(np.float32)).to(dev)
  train_step_ms = [cuda_ms(torch, lambda: t_step(t_state, t_batch), iters=8, warmup=2)
                   for _ in range(2)]
  log(phase, f"bls2017_rd train step B={TRAIN_BATCH} {TRAIN_HW}x{TRAIN_HW} f32: "
      + " / ".join(f"{x:.3f}" for x in train_step_ms) + f" ms  [{smi}]")
  del t_model, t_state, t_step, t_batch

  # The codec: two 512x768 images and a 500x740 one, bit-exact GPU to GPU.
  codec = codec_api.make_codec(model)
  check(isinstance(codec, codec_api.FactorizedCodec), "make_codec gave no FactorizedCodec")
  xs = [images[0], images[1], images[2][:500, :740]]
  results = []
  for x, r in zip(xs, records):
    zero_counts()
    result = codec.compress(x)
    rec = codec.decompress(result.bitstring)
    c = read_counts()
    exact = rec.shape == x.shape and np.array_equal(rec, result.reconstruction)
    results.append(result)
    log(phase, f"codec {x.shape[0]}x{x.shape[1]}: {len(result.bitstring)} bytes, bpp "
        f"{result.bpp:.5f} (the full image's likelihood: {r['bpp']:.5f}); streams "
        f"{codec_api.stream_counts(result.bitstring)}; bit-exact {exact}; launches {c}")
    check(exact, f"factorized {x.shape[:2]}: the decoder's image differs from the encoder's")
  raw = np.round((images[0] + 0.5) * 255.0).astype(np.uint8)
  cli_blob, cli_rec = cli_roundtrip(phase, "bls2017_rd", raw, dev)
  ref = codec.compress(models_base.normalize_image(raw.astype(np.float32)))
  same = cli_blob == ref.bitstring and np.array_equal(cli_rec, ref.reconstruction)
  log(phase, f"CLI bytes and image equal to this process's: {same}")
  check(same, "the factorized CLI's two processes disagree with the in-process codec")
  blobs = [r.bitstring for r in results]
  batch = codec.compress_batch(xs, reconstruct=True)
  strict = codec.decompress_batch(blobs, strict=True)
  held = ([b.bitstring for b in batch] == blobs
          and all(np.array_equal(d, r.reconstruction) for d, r in zip(strict, results))
          and all(np.abs(b.reconstruction.astype(int) - r.reconstruction).max() <= 1
                  for b, r in zip(batch, results)))
  log(phase, f"batch paths against the per-image path: {held}")
  check(held, "the factorized batch paths disagree with the per-image path")
  reps = 10
  for _ in range(2):
    codec.decompress(codec.compress(xs[0]).bitstring)
  c_parts = [timed_factorized_compress(codec, xs[0][None]) for _ in range(reps)]
  d_parts = [timed_factorized_decompress(codec, blobs[0]) for _ in range(reps)]
  check(all(p[0] == blobs[0] for p in c_parts)
        and all(np.array_equal(p[0], results[0].reconstruction) for p in d_parts),
        "the timed steps differ from compress / decompress")
  t = time.perf_counter()
  for _ in range(reps):
    codec.compress(xs[0])
  c_ms = (time.perf_counter() - t) / reps * 1e3
  t = time.perf_counter()
  for _ in range(reps):
    codec.decompress(blobs[0])
  d_ms = (time.perf_counter() - t) / reps * 1e3
  timing = dict(compress_ms=c_ms, decompress_ms=d_ms,
                compress_device_ms=float(np.mean([p[1] for p in c_parts])) * 1e3,
                compress_host_rans_ms=float(np.mean([p[2] for p in c_parts])) * 1e3,
                decompress_device_ms=float(np.mean([p[1] for p in d_parts])) * 1e3,
                decompress_host_rans_ms=float(np.mean([p[2] for p in d_parts])) * 1e3)
  log(phase, f"codec {EVAL_HW[0]}x{EVAL_HW[1]}, mean of {reps} after a warm-up: compress "
      f"{c_ms:.2f} ms (device "
      f"legs {timing['compress_device_ms']:.2f}, host rANS {timing['compress_host_rans_ms']:.2f}),"
      f" decompress {d_ms:.2f} ms (device legs {timing['decompress_device_ms']:.2f}, host rANS "
      f"{timing['decompress_host_rans_ms']:.2f})  [{smi}]")
  del model, model_cpu, codec

  # SGA: ITINF_FACTORIZED on image 0. ms per step (float32 and bf16
  # transforms, TF32 off), then the config's run with float32 transforms:
  # 3000 steps, or 1000 (scheduled over 1000) if a step takes over 10 ms.
  icfg = copy.deepcopy(configs.ITINF_FACTORIZED)
  opt_cfg = icfg["model_config"]["optimizer_config"]
  te = icfg["train_eval_config"]
  smodel = eval_lib.build_model(icfg["model_config"], init_seed=0, device="cuda",
                                family=icfg["model_family"])
  x_np = images[0][None]
  x_dev = torch.from_numpy(x_np).to(dev)
  step_ms = {}
  for name, dtype in (("float32", None), ("bfloat16", torch.bfloat16)):
    smodel.transforms_dtype = dtype
    f = itinf_lib.make_itinf_functions(smodel, opt_cfg, te["num_steps"])
    latents, optimizer = f.init(x_dev)
    gen = torch.Generator(device=dev)
    count = itertools.count()

    def one_step():
      s = next(count)
      f.step(x_dev, latents, optimizer, s, None, generator=itinf_lib.seed_step(gen, 0, s))

    step_ms[name] = cuda_ms(torch, one_step, iters=30, warmup=5)
    log(phase, f"SGA step {EVAL_HW[0]}x{EVAL_HW[1]} {name} transforms, TF32 off: "
        f"{step_ms[name]:.4f} ms  [{smi}]")
  smodel.transforms_dtype = None
  n_steps = te["num_steps"] if step_ms["float32"] <= 10.0 else 1000
  if n_steps != te["num_steps"]:
    smodel.scheduled_num_steps = n_steps
  run_cfg = dict(te, num_steps=n_steps)
  amortized_m = next(eval_lib.evaluate_images(smodel, x_np, step=smodel.scheduled_num_steps))
  zero_counts()
  t = time.time()
  _, val_m, itinf_vars = itinf_lib.itinf_on_data_batch(smodel, x_np, run_cfg, opt_cfg, seed=0)
  torch.cuda.synchronize()
  run_s = time.time() - t
  counts["itinf"] = read_counts()
  log(phase, f"ITINF_FACTORIZED, {n_steps} steps of {EVAL_HW[0]}x{EVAL_HW[1]} f32 in "
      f"{run_s:.2f}s: val rd_loss {val_m['rd_loss']:.5f} bpp {val_m['bpp']:.5f} psnr "
      f"{val_m['psnr']:.4f} against the amortized rd_loss {amortized_m['rd_loss']:.5f}; "
      f"launches {counts['itinf']}  [{smi}]")
  check(set(itinf_vars) == {"uq_0_loc"} and itinf_vars["uq_0_loc"].dtype == np.float32
        and all(np.isfinite(v) for v in val_m.values()), "the factorized SGA run's output")
  check(amortized_m["sched_rd_lambda"] == val_m["sched_rd_lambda"],
        "the amortized eval's lambda is not SGA's")
  check(val_m["rd_loss"] <= amortized_m["rd_loss"],
        f"factorized SGA did not improve on the amortized rd_loss: {val_m['rd_loss']} > "
        f"{amortized_m['rd_loss']}")
  check(all(sum(c.values()) == 0 for c in counts.values()),
        f"the factorized family launched a kernel: {counts}")
  summary = dict(eval_seconds=eval_s, train_step_ms=train_step_ms, codec=timing,
                 bpp=[r.bpp for r in results], sga_step_ms=step_ms, sga_steps=n_steps,
                 sga_seconds=run_s, val_rd_loss=val_m["rd_loss"],
                 amortized_rd_loss=amortized_m["rd_loss"], launches=counts, nvidia_smi=smi)
  log(phase, "summary " + json.dumps(summary))
  return summary


def families_phase(images, zero_counts, read_counts, smi, reference):
  """Phase 14: two_layer_syn2 (CNN 256 -> 320, TwoLayerSynthesis, mixedq) and
  mbt2018 at full width, seeded weights: eval of three images, a codec round
  trip and GPU against CPU on a 192x256 crop each; for two_layer_syn2 also
  the B=8 bf16 decode and 2 mixedq train steps. final_deconv_phase's count is
  zeroed and read around each of two_layer_syn2's paths and must equal its
  forwards; mbt2018 launches no kernel. Returns the launch counts."""
  import torch
  from shallow_ntc_tpu_torch import configs, eval_lib
  from shallow_ntc_tpu_torch.codec import api as codec_api
  from shallow_ntc_tpu_torch.ops import twolayer_final as tl

  phase = "families"
  dev = torch.device("cuda")
  mh, mw = EVAL_HW[0] // 16, EVAL_HW[1] // 16
  f_rng = np.random.default_rng(16)
  y_hat = torch.from_numpy(f_rng.integers(-8, 8, (DECODE_BATCH, mh, mw, 320))).to(
      dev, torch.bfloat16)
  z_hat = torch.from_numpy(f_rng.integers(-8, 8, (DECODE_BATCH, mh // 4, mw // 4, 320))).to(
      dev, torch.bfloat16)
  launches = {}
  for name in ("two_layer_syn2", "mbt2018"):
    cfg, _, family = configs.eval_config(name)
    model = eval_lib.build_model(cfg, init_seed=0, device="cuda", family=family)
    n_params = sum(p.numel() for p in model.parameters())
    expect = (lambda n: n) if name == "two_layer_syn2" else (lambda n: 0)
    counts = {}
    zero_counts()
    t = time.time()
    records = list(eval_lib.evaluate_images(model, images))
    counts["eval"] = read_counts()
    for i, r in enumerate(records):
      log(phase, f"{name} image {i} {EVAL_HW[0]}x{EVAL_HW[1]}: bpp {r['bpp']:.5f} psnr "
          f"{r['psnr']:.4f} msssim {r['msssim']:.5f} rd_loss {r['rd_loss']:.5f}")
    log(phase, f"{name}, {n_params} params, offset heuristic {model.offset_heuristic}: "
        f"{len(records)} images in {time.time() - t:.2f}s; launches {counts['eval']}")
    check(all(np.isfinite(r[k]) for r in records for k in ("bpp", "psnr", "msssim", "rd_loss")),
          f"{name} eval metrics not finite")
    counts["reference"] = reference(phase, model,
                                    eval_lib.build_model(cfg, init_seed=0, device="cpu",
                                                         family=family))
    codec = codec_api.make_codec(model)
    zero_counts()
    result = codec.compress(images[0])
    counts["compress"] = read_counts()
    zero_counts()
    rec = codec.decompress(result.bitstring)
    counts["decompress"] = read_counts()
    exact = np.array_equal(rec, result.reconstruction)
    log(phase, f"{name} codec {EVAL_HW[0]}x{EVAL_HW[1]}: {len(result.bitstring)} bytes, bpp "
        f"{result.bpp:.5f} "
        f"(likelihood {records[0]['bpp']:.5f}); bit-exact {exact}; launches compress "
        f"{counts['compress']}, decompress {counts['decompress']}")
    check(exact, f"{name}: the decoder's image differs from the encoder's")
    forwards = {"eval": len(images), "reference": 1, "compress": 1, "decompress": 1}
    if name == "two_layer_syn2":
      check(not model.offset_heuristic, "two_layer_syn2 (mixedq) kept the offset heuristic")
      m16 = eval_lib.build_model(cfg, init_seed=0, device="cuda", family=family).to(
          torch.bfloat16)
      zero_counts()
      check_decode(name, make_decode(m16, y_hat, z_hat)(), y_hat)
      counts["decode"] = read_counts()
      forwards["decode"] = 1
      del m16
      # Not every parameter can move in 2 steps here: mixedq decodes the
      # rounded latents, and at this seeded init every |z| and |y| is far
      # below .5, so the hyper-synthesis reads zeros and the synthesis mu,
      # and their kernels get no gradient; and the 1.8M-step schedule warms
      # the lr up over 36k steps, so step 1's 2.8e-9 is below a float32 ulp
      # of most parameters. The unmoved tensors are listed.
      counts["train"], forwards["train"] = train_two_steps(
          phase, name, family, zero_counts, read_counts, 2, all_move=False)
    for path, c in counts.items():
      check(c[tl.STATS.name] == expect(forwards[path])
            and sum(c.values()) == c[tl.STATS.name],
            f"{name} {path}: launches {c} in {forwards[path]} forwards")
    log(phase, f"{name}: final_deconv_phase launches by path "
        + ", ".join(f"{k} {c[tl.STATS.name]} in {forwards[k]} forwards" for k, c in counts.items()))
    launches[name] = {k: c[tl.STATS.name] for k, c in counts.items()}
    del model, codec
  log(phase, "summary " + json.dumps(dict(launches=launches, nvidia_smi=smi)))
  return launches


def phase_gemm(int8ops, fd, kernel, stride, z):
  """The int8 GEMM operands of the phase conv of `kernel` (stride s) over z,
  as conv_s1_int8 builds them: (im2col [M, K], weights [N, K], the phase
  kernel, its pads)."""
  w_phase, dmin, t = fd.phase_kernel(kernel.to(z.dtype), stride)
  pads = (-dmin, t - 1 + dmin)
  cols, b_t, _, _, _ = int8ops.int8_operands(z, w_phase, *pads)
  return cols, b_t.contiguous(), w_phase, pads


def check_phase_gemm(torch, int8ops, phase, name, cols, b_t):
  """The card's int32 product of the int8 operands against a float64 product
  of the same operands on the card: exact while |sum| <= K 127^2 < 2^53."""
  acc = int8ops.int8_matmul(cols, b_t)
  exact = cols.double() @ b_t.double().t()
  torch.cuda.synchronize()
  same = torch.equal(acc.double(), exact)
  log(phase, f"{name} GEMM [{cols.shape[0]}, {cols.shape[1]}] x [{cols.shape[1]}, "
      f"{b_t.shape[0]}] int8 -> int32 on the card: equal to the float64 product "
      f"(|sum| <= {cols.shape[1]} * 127^2 < 2^53): {same}")
  check(same, f"the {name} int8 GEMM is not exact")


def int8_phase(images, zero_counts, read_counts, smi):
  """Phase 15: the int8 inference paths (ops/int8ops.py) at full width with
  seeded weights. The flagship's B=8 512x768 bf16 decode in float, int8_syn
  and int8_all; the k13s8 phase GEMM exact and equal to the CPU's, with its
  times beside its bound; a jpegl_rd (k18s16) int8 decode; the eval of the
  3 images in the five arms of scripts/int8_quality.py, f32, TF32 off; the
  chain's precedence over the encode gate; the codec: a float bitstream
  under an int8_syn decoder, and the CLI's int8_syn roundtrip. Returns the
  phase's numbers."""
  import torch
  from shallow_ntc_tpu_torch import configs, eval_lib
  from shallow_ntc_tpu_torch.codec import api as codec_api
  from shallow_ntc_tpu_torch.ops import fast_deconv as fd
  from shallow_ntc_tpu_torch.ops import int8ops
  from shallow_ntc_tpu_torch.ops import rb_chain as rb
  from shallow_ntc_tpu_torch.ops import twolayer_final as tl

  phase = "int8"
  dev = torch.device("cuda")
  rng = np.random.default_rng(15)
  mh, mw = EVAL_HW[0] // 16, EVAL_HW[1] // 16
  y_hat = torch.from_numpy(rng.integers(-8, 8, (DECODE_BATCH, mh, mw, 320))).to(
      dev, torch.bfloat16)
  z_hat = torch.from_numpy(rng.integers(-8, 8, (DECODE_BATCH, mh // 4, mw // 4, 320))).to(
      dev, torch.bfloat16)
  pixels = DECODE_BATCH * EVAL_HW[0] * EVAL_HW[1]
  summary = {"nvidia_smi": smi}

  # The flagship's decode in the three modes of the eval CLI's --decode_dtype.
  model = eval_lib.build_model(configs.TWO_LAYER_SYN_RD, init_seed=0,
                               device="cuda").to(torch.bfloat16)
  decode = make_decode(model, y_hat, z_hat)
  outs, decodes = {}, {}
  for name, mode in (("float", ""), ("int8_syn", "syn"), ("int8_all", "all")):
    with int8ops.decode_mode(mode):
      zero_counts()
      outs[name] = decode()
      launches = read_counts()[tl.STATS.name]
      check_decode(f"flagship {name}", outs[name], y_hat)
      ms = cuda_ms(torch, decode, iters=20, warmup=3)
      dev_ms, n_kernels = kernels_ms(torch, decode)
    ref = outs["float"][2].float()
    abs_diff = (outs[name][2].float() - ref).abs().max().item()
    diff = abs_diff / ref.abs().max().item()
    decodes[name] = dict(ms=ms, mpx_per_s=pixels / ms / 1e3, device_ms=dev_ms,
                         device_activities=n_kernels, final_deconv_launches=launches,
                         max_abs_diff_vs_float=abs_diff, rel_diff_vs_float=diff)
    log(phase, f"flagship decode B={DECODE_BATCH} {EVAL_HW[0]}x{EVAL_HW[1]} bf16 {name}: "
        f"{ms:.4f} ms ({pixels / ms / 1e3:.2f} Mpx/s), kernels {dev_ms:.4f} ms in "
        f"{n_kernels:.0f} device activities a decode, final_deconv_phase launches {launches}, "
        f"max|rec - float rec| {abs_diff:.4e} ({diff:.4e} of max|float rec|)  [{smi}]")
    check(launches == 1, f"the {name} decode launched final_deconv_phase {launches} times")
  same_mu = all(torch.equal(a, b) for a, b in zip(outs["int8_syn"][:2], outs["float"][:2]))
  log(phase, f"int8_syn decode: mu and scale indexes equal to the float decode's: {same_mu}; "
      f"int8_all moves mu by {(outs['int8_all'][0] - outs['float'][0]).abs().max().item():.4e}")
  check(same_mu, "int8_syn moved the hyper-decoder's output")
  check(all(0 < decodes[k]["rel_diff_vs_float"] < 0.05 for k in ("int8_syn", "int8_all")),
        "an int8 reconstruction is not near the float one")
  summary["decode"] = decodes

  # The k13s8 phase GEMM of that decode (base and residual deconvs as one
  # phase conv, B=8): exact on the card, and its rescaled output equal to the
  # CPU's; its time beside its bound and the bf16 phase conv's.
  syn = model._synthesis
  kernel_br = torch.cat([syn.base_conv.kernel, syn.res_conv.kernel], dim=-1)
  cols, b_t, w_phase, pads = phase_gemm(int8ops, fd, kernel_br, 8, y_hat)
  check_phase_gemm(torch, int8ops, phase, "k13s8 phase", cols, b_t)
  gpu = int8ops.conv_s1_int8(y_hat, w_phase, *pads, torch.bfloat16)
  cpu = int8ops.conv_s1_int8(y_hat.cpu(), w_phase.cpu(), *pads, torch.bfloat16)
  same = torch.equal(gpu.cpu(), cpu)
  log(phase, f"k13s8 conv_s1_int8 B={DECODE_BATCH} bf16: the card's output equal to the CPU's "
      f"bit for bit: {same}")
  check(same, "the int8 phase conv on the card differs from the CPU's")
  m, k = cols.shape
  n = b_t.shape[0]
  gemm = dict(ms=cuda_ms(torch, lambda: int8ops.int8_matmul(cols, b_t), host_ahead=True),
              conv_ms=cuda_ms(torch, lambda: int8ops.conv_s1_int8(y_hat, w_phase, *pads,
                                                                  torch.bfloat16),
                              host_ahead=True),
              bf16_conv_ms=cuda_ms(torch, lambda: fd._conv_s1_float(y_hat, w_phase, *pads),
                                   host_ahead=True))
  gemm["bound_ms"], gemm["bound_by"] = int8_gemm_bound_ms(m, k, n)
  gemm["shape"] = f"M={m} K={k} N={n}"
  log(phase, f"k13s8 phase GEMM {gemm['shape']} (torch._int_mm): {gemm['ms']:.5f} ms, bound "
      f"{gemm['bound_ms']:.5f} ms ({gemm['bound_by']}, {2 * m * k * n / 1e9:.1f} GOP at 1979 "
      f"TOPS); the whole int8 conv (quantize, im2col, GEMM, rescale) {gemm['conv_ms']:.5f} ms; "
      f"the bf16 phase conv (cuDNN) {gemm['bf16_conv_ms']:.5f} ms  [{smi}]")
  summary["k13s8_gemm"] = gemm
  del model, decode, outs, cols, b_t, gpu, cpu

  # jpegl_rd (k18s16 through FastConvTranspose, k6s4 hyper-decoder) in int8_all.
  jl = eval_lib.build_model(configs.JPEGL_RD, init_seed=0, device="cuda").to(torch.bfloat16)
  jl_decode = make_decode(jl, y_hat, z_hat)
  ref = jl_decode()
  with int8ops.decode_mode("all"):
    out = jl_decode()
    check_decode("jpegl_rd int8_all", out, y_hat)
    jl_ms = cuda_ms(torch, jl_decode, iters=20, warmup=3)
  diff = ((out[2].float() - ref[2].float()).abs().max() / ref[2].float().abs().max()).item()
  cols, b_t, _, _ = phase_gemm(int8ops, fd, jl._synthesis.conv.kernel, 16, y_hat)
  check_phase_gemm(torch, int8ops, phase, "jpegl_rd k18s16 phase", cols, b_t)
  log(phase, f"jpegl_rd decode B={DECODE_BATCH} bf16 int8_all: {jl_ms:.4f} ms, max|rec - "
      f"float rec| / max|float rec| {diff:.4e}")
  check(0 < diff < 0.05, "the jpegl_rd int8 reconstruction is not near the float one")
  summary["jpegl_rd_decode_ms"] = jl_ms
  del jl, jl_decode, cols, b_t

  # The eval of the 3 images in the five arms of scripts/int8_quality.py.
  model = eval_lib.build_model(configs.TWO_LAYER_SYN_RD, init_seed=0, device="cuda")
  arms = {"f32": ("", False), "syn": ("syn", False), "all": ("all", False),
          "enc": ("", True), "enc_syn": ("syn", True)}
  records, eval_launches = {}, 0
  for arm, (mode, enc) in arms.items():
    with int8ops.decode_mode(mode), (switch_on("SNTC_INT8_ENCODE") if enc
                                     else contextlib.nullcontext()):
      zero_counts()
      t = time.time()
      records[arm] = list(eval_lib.evaluate_images(model, images))
      torch.cuda.synchronize()
      secs = time.time() - t
      eval_launches += read_counts()[tl.STATS.name]
    mean = {k: float(np.mean([r[k] for r in records[arm]])) for k in ("bpp", "psnr", "msssim")}
    log(phase, f"eval arm {arm}: bpp {mean['bpp']:.6f} psnr {mean['psnr']:.5f} msssim "
        f"{mean['msssim']:.6f} (mean of {len(images)} images, {secs:.2f}s)"
        + ("" if arm == "f32" else f"; delta vs f32: bpp "
           f"{mean['bpp'] - np.mean([r['bpp'] for r in records['f32']]):+.6f}, psnr "
           f"{mean['psnr'] - np.mean([r['psnr'] for r in records['f32']]):+.5f} dB"))
  for a, b_ in (("syn", "f32"), ("enc_syn", "enc")):
    same = [r["bpp"] == q["bpp"] for r, q in zip(records[a], records[b_])]
    log(phase, f"eval: {a} bpp equal to {b_} bpp per image: {same}")
    check(all(same), f"the {a} arm moved the rate")
  check(eval_launches == len(images) * len(arms),
        f"the eval arms launched final_deconv_phase {eval_launches} times")
  summary["eval_arms"] = {arm: {k: float(np.mean([r[k] for r in recs]))
                                for k in ("bpp", "psnr", "msssim")}
                          for arm, recs in records.items()}

  # The encode gate moves the latents; the chain kernel takes its blocks away
  # from it, leaving the attentions' 1x1s and the hyper-analysis's k3s1.
  image0 = torch.from_numpy(images[:1]).to(dev)
  conv = int8ops.conv_s1_int8
  calls = []
  int8ops.conv_s1_int8 = lambda *a: calls.append(1) or conv(*a)
  latents, gated = {}, {}
  try:
    for way, env in (("float", ()), ("enc", ("SNTC_INT8_ENCODE",)),
                     ("enc+chain", ("SNTC_INT8_ENCODE", "SNTC_FUSED_RB_CHAIN"))):
      with contextlib.ExitStack() as stack:
        for name in env:
          stack.enter_context(switch_on(name))
        calls.clear()
        zero_counts()
        with torch.no_grad():
          latents[way] = [rv.loc for rv in model.infer_latent_rvs(image0).uq]
        gated[way] = (len(calls), read_counts()[rb.STATS.name])
  finally:
    int8ops.conv_s1_int8 = conv
  moves = {way: [(a - b_).abs().max().item() for a, b_ in zip(latents[way], latents["float"])]
           for way in ("enc", "enc+chain")}
  log(phase, f"image 0 analysis: int8 convs and chain launches {gated}; max|z - float z|, "
      f"max|y - float y|: enc {moves['enc'][0]:.4e}, {moves['enc'][1]:.4e}; enc with the chain "
      f"{moves['enc+chain'][0]:.4e}, {moves['enc+chain'][1]:.4e}")
  check(gated["float"] == (0, 0) and gated["enc"][1] == 0 and gated["enc"][0] > 3
        and gated["enc+chain"] == (3, CHAINS_PER_FORWARD),
        f"the encode gate's int8 convs and chain launches: {gated}")
  check(moves["enc"][1] > 0, "the encode gate did not move the latents")
  summary["encode_gate"] = dict(int8_convs_and_chains=gated, latent_moves=moves)

  # The codec (f32): a float bitstream under an int8_syn decoder decodes the
  # same latent; ms per call; the CLI's int8_syn roundtrip.
  codec = codec_api.make_codec(model)
  x = images[0]
  result = codec.compress(x)
  _, _, y_float = codec.decode_latent(result.bitstring)
  with int8ops.decode_mode("syn"):
    _, _, y_syn = codec.decode_latent(result.bitstring)
    rec_syn = codec.decompress(result.bitstring)
  same = np.array_equal(y_syn, y_float)
  px_diff = float(np.mean(rec_syn != result.reconstruction))
  log(phase, f"codec {x.shape[0]}x{x.shape[1]}: a float bitstream ({len(result.bitstring)} "
      "bytes) decoded under "
      f"int8_syn: y_hat equal to the float decoder's: {same}; {px_diff:.4f} of the pixels "
      "differ from the float reconstruction")
  check(same and px_diff > 0, "the int8_syn decoder does not read float bitstreams as expected")
  codec_ms = {}
  for name, mode, fn in (("compress float", "", lambda: codec.compress(x)),
                         ("decompress float", "", lambda: codec.decompress(result.bitstring)),
                         ("compress int8_syn", "syn", lambda: codec.compress(x)),
                         ("decompress int8_syn", "syn",
                          lambda: codec.decompress(result.bitstring))):
    with int8ops.decode_mode(mode):
      fn()
      t = time.time()
      for _ in range(3):
        fn()
      codec_ms[name] = (time.time() - t) / 3 * 1e3
  log(phase, "codec ms per call (mean of 3 after a warm-up): "
      + ", ".join(f"{k} {v:.2f}" for k, v in codec_ms.items()) + f"  [{smi}]")
  summary["codec_ms"] = codec_ms
  raw = np.round((images[0] + 0.5) * 255.0).astype(np.uint8)
  root = os.path.dirname(os.path.abspath(__file__))
  with tempfile.TemporaryDirectory(prefix="chip_smoke_int8_") as tmp:
    np.save(os.path.join(tmp, "img.npy"), raw)
    t = time.time()
    proc = subprocess.run([sys.executable, "-m", "shallow_ntc_tpu_torch.compress", "roundtrip",
                           "--input", "img.npy", "--init_seed", "0", "--decode_dtype",
                           "int8_syn"], cwd=tmp, capture_output=True, text=True, timeout=300,
                          env=dict(os.environ, PYTHONPATH=root))
  check(proc.returncode == 0, f"the compress CLI failed: {proc.stderr[-2000:]}")
  log(phase, f"CLI roundtrip --decode_dtype int8_syn ({time.time() - t:.1f}s): "
      f"{proc.stdout.strip()}")
  check(proc.stdout.strip().endswith("bit_exact=True"), "the int8_syn CLI roundtrip failed")
  summary["final_deconv_launches"] = (sum(d["final_deconv_launches"] for d in decodes.values())
                                      + eval_launches)
  summary["chain_launches"] = gated["enc+chain"][1]
  log(phase, "summary " + json.dumps(summary))
  return summary


def extras_phase(images, zero_counts, read_counts, smi):
  """Phase 16: LPIPS (random weights) on the 3 eval images, ElicSynthesis at
  its default width (chain off and on) and TwoLayerResSynthesis(res_type=
  "d2s") at the flagship's, each on the card against the CPU, float32, TF32
  off. Returns the phase's numbers."""
  import torch
  from shallow_ntc_tpu_torch import configs, eval_lib
  from shallow_ntc_tpu_torch import params as params_lib
  from shallow_ntc_tpu_torch.models import lpips
  from shallow_ntc_tpu_torch.models import transforms as T
  from shallow_ntc_tpu_torch.ops import rb_chain as rb

  phase = "inference-extras"
  dev = torch.device("cuda")
  summary = {"nvidia_smi": smi}

  # LPIPS of each image against the flagship's reconstruction of it.
  model = eval_lib.build_model(configs.TWO_LAYER_SYN_RD, init_seed=0, device="cuda")
  x255 = torch.from_numpy(np.round((images + 0.5) * 255.0).astype(np.float32))
  with torch.no_grad():
    recs = torch.cat([model.end_to_end_frame_loss(torch.from_numpy(img[None]).to(dev))[2].cpu()
                      for img in images])
  del model
  fns = {d: lpips.make_lpips_fn(weights=lpips.random_weights(device=d)) for d in ("cuda", "cpu")}
  vals = {d: [float(fns[d](x255[i:i + 1].to(d), recs[i:i + 1].to(d)))
              for i in range(len(images))] for d in fns}
  rel = max(abs(g - c) / abs(c) for g, c in zip(vals["cuda"], vals["cpu"]))
  x0, r0 = x255[:1].to(dev), recs[:1].to(dev)
  lp_ms = cuda_ms(torch, lambda: fns["cuda"](x0, r0), iters=10, warmup=2)
  log(phase, f"LPIPS (random weights) of the 3 images against the flagship's reconstructions: "
      f"card {[f'{v:.6f}' for v in vals['cuda']]}, CPU {[f'{v:.6f}' for v in vals['cpu']]}, "
      f"max rel {rel:.2e} (tol 1e-3); {lp_ms:.3f} ms an image on the card  [{smi}]")
  check(rel <= 1e-3 and all(np.isfinite(v) and v > 0 for v in vals["cuda"]),
        "LPIPS on the card disagrees with the CPU")
  summary["lpips"] = dict(card=vals["cuda"], cpu=vals["cpu"], max_rel=rel, ms=lp_ms)

  def card_vs_cpu(name, cfg, z, chains):
    """A seeded transform's output on the card (the chain kernel off, or also
    on) against the CPU's."""
    module = T.build_transform(cfg, z.shape[-1])
    params_lib.load_params(module, params_lib.init_params(module, 0))
    with torch.no_grad():
      ref = module(z)
      module.to(dev)
      z_d = z.to(dev)
      runs = {}
      for chain in chains:
        with switch_on("SNTC_FUSED_RB_CHAIN") if chain else contextlib.nullcontext():
          zero_counts()
          out = module(z_d)
          launches = read_counts()[rb.STATS.name]
          ms = cuda_ms(torch, lambda: module(z_d), iters=5, warmup=1)
        err = (out.cpu() - ref).abs().max().item()
        tol = 1e-4 * max(1.0, ref.abs().max().item())
        log(phase, f"{name}{' (chain)' if chain else ''} z {tuple(z.shape)} -> "
            f"{tuple(out.shape)}: card vs CPU max|err| {err:.3e} (tol {tol:.3e}); "
            f"fused_rb_chain launches {launches}; {ms:.3f} ms on the card  [{smi}]")
        check(out.shape == (1,) + EVAL_HW + (3,) and err <= tol,
              f"{name} disagrees with the CPU")
        runs[f"chain {chain}"] = dict(max_abs_err=err, tol=tol, chain_launches=launches, ms=ms)
    return runs

  z = torch.from_numpy(np.random.default_rng(16).standard_normal(
      (1, EVAL_HW[0] // 16, EVAL_HW[1] // 16, 320), np.float32))
  elic = card_vs_cpu("ElicSynthesis", dict(cls="ElicSynthesis"), z, (False, True))
  check(elic["chain True"]["chain_launches"] == ELIC_SYNTHESIS_CHAINS
        and elic["chain False"]["chain_launches"] == 0, f"ElicSynthesis's chain launches: {elic}")
  summary["elic_synthesis"] = elic
  summary["d2s"] = card_vs_cpu(
      "TwoLayerResSynthesis d2s", dict(cls="TwoLayerResSynthesis", channels=(12, 3),
                                       res_type="d2s"), z, (False,))
  summary["chain_launches"] = elic["chain True"]["chain_launches"]
  log(phase, "summary " + json.dumps(summary))
  return summary


def main():
  import torch
  if not torch.cuda.is_available():
    print("chip_smoke: CUDA is not available", file=sys.stderr)
    return 1
  try:
    from shallow_ntc_tpu_torch import configs, eval_lib, train_lib
    from shallow_ntc_tpu_torch.codec import bindings as rans
    from shallow_ntc_tpu_torch.ops import cuda_build
    from shallow_ntc_tpu_torch.ops import fast_deconv as fd
    from shallow_ntc_tpu_torch.ops import jpegl_decode as jd
    from shallow_ntc_tpu_torch.ops import rb_chain as rb
    from shallow_ntc_tpu_torch.ops import resblock
    from shallow_ntc_tpu_torch.ops import twolayer_final as tl
  except ImportError as e:
    print(f"chip_smoke: the port is not beside this script ({e})", file=sys.stderr)
    return 1
  import torch.nn.functional as F

  # --- 1. build ------------------------------------------------------------
  t = time.time()
  sources = sorted({tl.SOURCE, rb.SOURCE, resblock.SOURCE, jd.SOURCE})
  with concurrent.futures.ThreadPoolExecutor(len(sources) + 1) as pool:
    librans = pool.submit(rans.build)
    built = list(pool.map(cuda_build.build, sources))
    built.append(librans.result())
  for source, so in zip(sources + ["codec/rans.cc (g++)"], built):
    log("build", f"{source} -> {so}")
  log("build", f"{len(sources)} CUDA sources and the rANS coder built in parallel in "
      f"{time.time() - t:.1f}s")
  stats = (tl.STATS, rb.STATS, resblock.STATS, jd.STATS)

  def zero_counts():
    torch.cuda.synchronize()
    for st in stats:
      st.launches = 0

  def read_counts():
    torch.cuda.synchronize()
    return {st.name: st.launches for st in stats}

  # --- 2. device -----------------------------------------------------------
  dev = torch.device("cuda")
  kind = torch.cuda.get_device_name(0)
  smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True, text=True,
                       timeout=60).stdout.strip().splitlines()[0]
  log("device", f"torch {torch.__version__} cuda {torch.version.cuda}; {kind}; "
      f"nvidia-smi: {smi}")
  torch.backends.cudnn.allow_tf32 = False
  torch.backends.cuda.matmul.allow_tf32 = False

  # --- 3. kernels against their plain versions ------------------------------
  rng = np.random.default_rng(0)

  def final_inputs(b, h, w, dtype, k=5, c_in=12, c_out=3, gen=None):
    gen = rng if gen is None else gen
    mid = torch.from_numpy(gen.standard_normal((b, h, w, 64 * c_in), np.float32))
    kern = torch.from_numpy(gen.standard_normal((k, k, c_in, c_out), np.float32) * 0.1)
    bias = torch.from_numpy(gen.standard_normal((c_out,), np.float32) * 0.1)
    return mid.to(dev, dtype), kern.to(dev, dtype), bias.to(dev)

  # (B, H, W, dtype, k, c_in, c_out): the eval and decode shapes, then the
  # shapes the kernel's tiles (one phase row x 8 phase columns) make ragged,
  # as tests/test_torch_cuda.py has them: W no multiple of 8 and W = 1, H = 1,
  # B = 1; k = 3, 5, 7; c_in 12, 5, 6, 16; c_out 3, 4, 5, 8; and the train
  # shape. The cases after the first four draw from a generator of their own,
  # so that the data of the later phases does not depend on them.
  mh, mw = EVAL_HW[0] // 16, EVAL_HW[1] // 16
  fd_train = (TRAIN_BATCH, TRAIN_HW // 16, TRAIN_HW // 16, torch.float32, 5, 12, 3)
  cases = [(1, mh, mw, torch.float32, 5, 12, 3), (DECODE_BATCH, mh, mw, torch.bfloat16, 5, 12, 3),
           (3, 5, 7, torch.float32, 5, 12, 3), (2, 3, 4, torch.float32, 7, 12, 3)]
  new_cases = [(1, 1, 1, torch.bfloat16, 5, 12, 3), (2, 3, 9, torch.bfloat16, 7, 12, 3),
               (1, 2, 11, torch.float32, 3, 12, 3), (2, 3, 5, torch.float32, 5, 5, 5),
               (2, 3, 5, torch.bfloat16, 5, 5, 5), (1, 2, 10, torch.bfloat16, 3, 16, 8),
               (3, 1, 17, torch.float32, 7, 16, 3), (2, 2, 9, torch.bfloat16, 5, 6, 4),
               (1, 2, 9, torch.float32, 5, 6, 4), fd_train]
  # The SGA step's shape with bf16 transforms (phase 12).
  fd_itinf_bf16 = (1, mh, mw, torch.bfloat16, 5, 12, 3)
  new_cases.append(fd_itinf_bf16)
  fd_rng = np.random.default_rng(9)
  errs = {}
  for case in cases + new_cases:
    b, h, w, dtype, k, c_in, c_out = case
    mid, kern, bias = final_inputs(*case, gen=None if case in cases else fd_rng)
    out = tl.final_deconv_cuda(mid, kern, bias, c_in)
    ref = tl.final_deconv_plain(mid, kern, bias, c_in)
    torch.cuda.synchronize()
    err = (out.float() - ref.float()).abs().max().item()
    scale = ref.float().abs().max().item()
    tol = 1e-4 if dtype == torch.float32 else 2e-2 * scale
    log("kernels", f"final_deconv_phase B={b} {h}x{w} k={k} c_in={c_in} c_out={c_out} {dtype}: "
        f"max|err| {err:.3e} (tol {tol:.3e}, max|y| {scale:.3f})")
    check(out.shape == ref.shape and err <= tol, f"final_deconv_phase disagrees: {err} > {tol}")
    errs[("final_deconv_phase", case)] = err
  # bfloat16 mid with float32 weights and a float32 bias off the bfloat16
  # grid, at the decode shape: kernel and plain version both add the bias in
  # float32 before the one rounding (rounding it first moves ~30% of the
  # outputs by an ulp). mid is scaled by 0.05, so every output lies near its
  # bias, away from 0, where one ulp is no bound on a sum's rounding. A
  # generator of its own.
  fb_rng = np.random.default_rng(12)
  mid = torch.from_numpy(fb_rng.standard_normal((DECODE_BATCH, mh, mw, 768), np.float32) * 0.05)
  kern = torch.from_numpy(fb_rng.standard_normal((5, 5, 12, 3), np.float32) * 0.1).to(dev)
  mid = mid.to(dev, torch.bfloat16)
  bias = torch.tensor([1 + 3 * 2**-10, -2 + 5 * 2**-9, 0.5 + 2**-11], device=dev)
  out = tl.final_deconv_cuda(mid, kern, bias, 12).float()
  ref = tl.final_deconv_plain(mid, kern, bias, 12).float()
  ulp = torch.exp2(torch.floor(torch.log2(ref.abs())) - 7)
  same = (out == ref).float().mean().item()
  within = ((out - ref).abs() <= ulp).all().item()
  log("kernels", f"final_deconv_phase B={DECODE_BATCH} {mh}x{mw} bf16 mid, float32 weights and "
      f"bias: {same:.6f} of outputs equal (tol 0.99), all within one bf16 ulp: {within}")
  check(same >= 0.99 and within, "final_deconv_phase adds a float32 bias otherwise than plain")
  mid, kern, bias = final_inputs(2, 3, 4, torch.float32)
  cot = torch.randn(2, 48, 64, 3, device=dev)
  grads = []
  for fn in (tl.final_deconv_phase, tl.final_deconv_plain):
    leaves = [x.clone().requires_grad_(True) for x in (mid, kern, bias)]
    fn(*leaves, 12).backward(cot)
    grads.append([x.grad for x in leaves])
  g_err = max((a - b_).abs().max().item() for a, b_ in zip(*grads))
  log("kernels", f"final_deconv_phase backward vs plain: max|err| {g_err:.3e} (tol 1e-4)")
  check(g_err <= 1e-4, "final_deconv_phase gradients disagree")

  def rb_params(n, c, seed):
    """Seeded block weights at the scale of a glorot init (fan-in normalized)."""
    r = np.random.default_rng(seed)
    ch = c // 2

    def mk(*shape):
      fan_in = int(np.prod(shape[:-1])) if len(shape) > 1 else 1
      return torch.from_numpy((r.standard_normal(shape) / np.sqrt(fan_in)).astype(np.float32))

    return [tuple(t.to(dev) for t in (mk(c, ch), mk(ch) * 0.1, mk(3, 3, ch, ch), mk(ch) * 0.1,
                                      mk(ch, c), mk(c) * 0.1)) for _ in range(n)]

  # (B, H, W, C, N): the train stages (128x128, 64x64 and 32x32 at C=192,
  # 16x16 at C=320, the largest shared-memory case), eval stage 1, and odd
  # shapes: H and W multiples of neither tile, C/2 not a multiple of 8. N=1
  # goes through fused_resblock's own entry.
  rb_train, rb_eval = (TRAIN_BATCH, TRAIN_HW // 2, TRAIN_HW // 2, 192, 3), (1, 256, 384, 192, 3)
  rb_stages = [(TRAIN_BATCH, TRAIN_HW // s, TRAIN_HW // s, 192, 3) for s in (4, 8)] + [
      (TRAIN_BATCH, TRAIN_HW // 16, TRAIN_HW // 16, 320, 3)]
  # The cases of rb_new_cases draw x from a generator of their own, so that
  # the data of the later phases does not depend on the cases added here.
  rb_cases = [rb_train, rb_eval, rb_stages[-1], (3, 7, 5, 16, 2),
              (TRAIN_BATCH, TRAIN_HW // 2, TRAIN_HW // 2, 192, 1), (3, 7, 5, 16, 1)]
  rb_new_cases = [*rb_stages[:2], (2, 17, 9, 192, 2), (3, 7, 5, 20, 2), (2, 17, 9, 320, 1),
                  (2, 9, 17, 20, 1)]
  for case in rb_cases + rb_new_cases:
    b, h, w, c, n = case
    params = rb_params(n, c, seed=sum(case))
    x_rng = rng if case in rb_cases else np.random.default_rng(sum(case))
    x32 = torch.from_numpy(x_rng.standard_normal((b, h, w, c), np.float32)).to(dev)
    for dtype in (torch.float32, torch.bfloat16):
      x = x32.to(dtype)
      name = "fused_resblock" if n == 1 else "fused_rb_chain"
      out = (resblock.fused_resblock_cuda(x, *params[0]) if n == 1
             else rb.rb_chain_cuda(x, params))
      ref = rb.dense_rb_chain(x, params)
      torch.cuda.synchronize()
      err = (out.float() - ref.float()).abs().max().item()
      scale = ref.float().abs().max().item()
      tol = (1e-4 if dtype == torch.float32 else 2e-2) * scale
      log("kernels", f"{name} B={b} {h}x{w} C={c} N={n} {dtype}: max|err| {err:.3e} "
          f"(tol {tol:.3e}, max|y| {scale:.3f})")
      check(out.shape == ref.shape and err <= tol, f"{name} disagrees: {err} > {tol}")
      errs[(name, case, dtype)] = err
  for name, n in (("fused_rb_chain", 3), ("fused_resblock", 1)):
    params = rb_params(n, 192, seed=99)
    x = torch.randn(2, 9, 11, 192, device=dev)
    cot = torch.randn_like(x)
    fused = ((lambda xx, pp: resblock.fused_resblock(xx, *pp[0])) if n == 1
             else rb.fused_rb_chain)
    grads = []
    for fn in (fused, rb.dense_rb_chain):
      x_l = x.clone().requires_grad_(True)
      p_l = [tuple(t.clone().requires_grad_(True) for t in blk) for blk in params]
      (fn(x_l, p_l) * cot).sum().backward()
      grads.append([x_l.grad] + [t.grad for blk in p_l for t in blk])
    # Both sides run the plain version's backward; cuDNN's weight gradients
    # may sum in another order from call to call.
    g_err = max(((a - b_).abs().max() / max(1.0, b_.abs().max().item())).item()
                for a, b_ in zip(*grads))
    log("kernels", f"{name} N={n} backward vs plain (x and {6 * n} weights): "
        f"max|err| / max(1, max|g|) {g_err:.3e} (tol 1e-5)")
    check(g_err <= 1e-5, f"{name} gradients disagree")

  # jpegl_synthesize (B, H_l, W_l, C, k, dtype): JPEGL_K16's decode and eval
  # shapes, a ragged M at C=320 (B=1 3x5: fewer latent tiles than the bf16
  # kernel's walkers) and 64-latent tiles that cross latent rows with a
  # ragged last tile (B=2 3x48) in both dtypes, the offset channel (C odd,
  # with no bias) and k=8. Weights and bias in z's dtype, as the model's
  # parameters are, except the last three cases (float32, rounded by the
  # wrapper). Weights at the scale of a glorot init, asymmetric (a missed
  # flip shows). A generator of its own, so that the phases before this
  # slice draw their data as before.
  jl_rng = np.random.default_rng(6)

  def jpegl_inputs(b, hl, wl, c, k, dtype, params=None):
    z = torch.from_numpy(jl_rng.normal(0, 3, (b, hl, wl, c)).astype(np.float32))
    kern = torch.from_numpy((jl_rng.normal(0, 0.1, (k, k, c, 3)) / np.sqrt(c / 32))
                            .astype(np.float32)).to(dev, params or torch.float32)
    bias = (torch.from_numpy(jl_rng.normal(0, 0.1, (3,)).astype(np.float32))
            .to(dev, params or torch.float32) if c % 2 == 0 else None)
    return z.to(dev, dtype), kern, bias

  jl_decode = (DECODE_BATCH, mh, mw, 320, 16, torch.bfloat16, torch.bfloat16)
  jl_eval = (1, mh, mw, 320, 16, torch.float32, torch.float32)
  jl_cases = [jl_decode, jl_eval]
  for dtype in (torch.bfloat16, torch.float32):
    jl_cases += [(1, 3, 5, 320, 16, dtype, dtype), (2, 3, mw, 320, 16, dtype, dtype)]
  for case in jl_cases + [(3, 5, 7, 321, 16, torch.float32), (3, 5, 7, 321, 16, torch.bfloat16),
                          (2, 3, 5, 16, 8, torch.float32)]:
    z, kern, bias = jpegl_inputs(*case)
    out = jd.jpegl_synthesize_cuda(z, kern, bias)
    ref = jd.jpegl_synthesize_plain(z, kern, bias)
    torch.cuda.synchronize()
    err = (out.float() - ref.float()).abs().max().item()
    scale = ref.float().abs().max().item()
    tol = 1e-4 * max(1.0, scale) if case[5] == torch.float32 else 1e-2 * scale
    log("kernels", f"jpegl_synthesize B={case[0]} {case[1]}x{case[2]} C={case[3]} k={case[4]} "
        f"{case[5]}, params {kern.dtype}{'' if bias is not None else ', no bias'}: "
        f"max|err| {err:.3e} (tol {tol:.3e}, max|y| {scale:.3f})")
    check(out.shape == ref.shape and err <= tol, f"jpegl_synthesize disagrees: {err} > {tol}")
    errs[("jpegl_synthesize", case)] = err
  z, kern, bias = jpegl_inputs(1, 2, 3, 16, 8, torch.float32)
  try:
    jd.jpegl_synthesize(z.requires_grad_(True), kern, bias).sum().backward()
    raised = False
  except NotImplementedError:
    raised = True
  log("kernels", f"jpegl_synthesize backward raises NotImplementedError (JAX has none "
      f"either): {raised}")
  check(raised, "jpegl_synthesize's backward did not raise")

  # --- 4. the main path -----------------------------------------------------
  t = time.time()
  model = eval_lib.build_model(configs.TWO_LAYER_SYN_RD, init_seed=0, device="cuda")
  n_params = sum(p.numel() for p in model.parameters())
  log("eval", f"flagship model, {n_params} params, seeded init in {time.time() - t:.1f}s")
  images = np.stack([rng.integers(0, 256, EVAL_HW + (3,)) for _ in range(3)])
  images = (images / 255.0 - 0.5).astype(np.float32)
  model_bf16 = eval_lib.build_model(configs.TWO_LAYER_SYN_RD, init_seed=0,
                                    device="cuda").to(torch.bfloat16)
  y_hat = torch.from_numpy(rng.integers(-8, 8, (DECODE_BATCH, mh, mw, 320))).to(
      dev, torch.bfloat16)
  z_hat = torch.from_numpy(rng.integers(-8, 8, (DECODE_BATCH, mh // 4, mw // 4, 320))).to(
      dev, torch.bfloat16)

  def decode():
    with torch.no_grad():
      mu, idx = model_bf16.hyper_synthesize(z_hat)
      return mu, idx, model_bf16.synthesize(y_hat)

  torch.cuda.synchronize()
  tl.STATS.launches = 0
  t = time.time()
  records, image_s = [], []
  for record in eval_lib.evaluate_images(model, images):
    torch.cuda.synchronize()
    image_s.append(time.time() - t)
    records.append(record)
    t = time.time()
  eval_launches = tl.STATS.launches
  mu, idx, rec = decode()
  torch.cuda.synchronize()
  launches = tl.STATS.launches
  for i, r in enumerate(records):
    log("eval", f"image {i} {EVAL_HW[0]}x{EVAL_HW[1]}: bpp {r['bpp']:.5f} psnr {r['psnr']:.4f} "
        f"msssim {r['msssim']:.5f} rd_loss {r['rd_loss']:.5f}")
  log("eval", "seconds per image (the first includes cuDNN warm-up): "
      + ", ".join(f"{x:.4f}" for x in image_s)
      + f"; final_deconv_phase launches: eval {eval_launches}, eval+decode {launches}")
  # The eval pass computes the prior's offset once (evaluate_images); the
  # path before it recomputed the 60-step bisection for every image
  # (end_to_end_frame_loss). Both on the same 3 images, warm, in turns.
  def old_path():
    for img in images:
      with torch.no_grad():
        _, m, _ = model.end_to_end_frame_loss(torch.from_numpy(img[None]).to(dev))
      {k: float(v) for k, v in m.items()}

  eval_ways = {"once per pass": [], "per image": []}
  for way in ("once per pass", "per image", "per image", "once per pass"):
    t = time.time()
    if way == "once per pass":
      list(eval_lib.evaluate_images(model, images))
    else:
      old_path()
    torch.cuda.synchronize()
    eval_ways[way].append((time.time() - t) / len(images) * 1e3)
  log("eval", "ms per image over 3 images, the prior offset "
      + "; ".join(f"{k}: {' / '.join(f'{x:.3f}' for x in v)}" for k, v in eval_ways.items())
      + f"  [{smi}]")
  check(all(np.isfinite(r[k]) for r in records for k in ("bpp", "psnr", "msssim", "rd_loss")),
        "eval metrics not finite")
  check(eval_launches >= 3, f"eval launched final_deconv_phase {eval_launches} times, not >= 3")
  check(launches > eval_launches, "the decode did not launch final_deconv_phase")
  check(rec.shape == (DECODE_BATCH,) + EVAL_HW + (3,) and torch.isfinite(rec).all().item()
        and mu.shape == y_hat.shape and torch.isfinite(idx).all().item(),
        "decode output has the wrong shape or is not finite")

  # Image 0 three ways: the residual blocks as cuDNN convs, as 7 chain
  # kernels, as 21 block kernels. Held: the continuous latents z and y
  # (before any rounding), the latent rate and PSNR. The total and
  # hyper-latent rates are reported only: a z within float rounding of a .5
  # boundary rounds the other way when a route sums in another order, and
  # its rate then differs though z agrees (rel 6.0e-05 and 1.8e-04 on two
  # seed streams); given the same z the hyper-latent rate is the same
  # function on every route, so holding z holds it.
  ways, latents = {}, {}
  image0 = torch.from_numpy(images[:1]).to(dev)
  for way, env in (("cudnn", None), ("chain", "SNTC_FUSED_RB_CHAIN"),
                   ("resblock", "SNTC_FUSED_RESBLOCK")):
    with switch_on(env) if env else contextlib.nullcontext():
      zero_counts()
      r = next(eval_lib.evaluate_images(model, images[:1]))
      ways[way] = (r, read_counts())
      with torch.no_grad():
        latents[way] = [rv.loc for rv in model.infer_latent_rvs(image0).uq]
    log("eval", f"image 0 with the residual blocks as {way}: bpp {r['bpp']:.6f} (latent "
        f"{r['latent_bpp']:.6f}, hyper-latent {r['hyper_latent_bpp']:.6f}) psnr {r['psnr']:.6f}; "
        f"launches {ways[way][1]}")
  base = ways["cudnn"][0]
  for way in ("chain", "resblock"):
    for name, a, b_ in zip(("z", "y"), latents[way], latents["cudnn"]):
      err = (a - b_).abs().max().item()
      scale = b_.abs().max().item()
      log("eval", f"image 0 {name}: {way} vs cudnn max|err| {err:.3e}, max|cudnn| {scale:.3f} "
          f"(tol 1e-4 * max(1, max|cudnn|))")
      check(err <= 1e-4 * max(1.0, scale), f"eval with the {way} kernels disagrees on {name}")
    for key in ("latent_bpp", "psnr", "bpp", "hyper_latent_bpp"):
      rel = abs(ways[way][0][key] - base[key]) / abs(base[key])
      held = key in ("latent_bpp", "psnr")
      log("eval", f"image 0 {key}: {way} vs cudnn rel {rel:.2e} "
          + ("(tol 1e-4)" if held else "(reported: rounding of z near .5)"))
      check(not held or rel <= 1e-4, f"eval with the {way} kernels disagrees on {key}: {rel}")
  check(ways["cudnn"][1][rb.STATS.name] == 0 and ways["cudnn"][1][resblock.STATS.name] == 0,
        "the default eval launched a residual-block kernel")
  check(ways["chain"][1][rb.STATS.name] == CHAINS_PER_FORWARD
        and ways["chain"][1][resblock.STATS.name] == 0,
        f"SNTC_FUSED_RB_CHAIN=1 eval: {ways['chain'][1]}, not {CHAINS_PER_FORWARD} chains")
  check(ways["resblock"][1][resblock.STATS.name] == BLOCKS_PER_FORWARD
        and ways["resblock"][1][rb.STATS.name] == 0,
        f"SNTC_FUSED_RESBLOCK=1 eval: {ways['resblock'][1]}, not {BLOCKS_PER_FORWARD} blocks")

  # --- 5. reference: the GPU path against the port's CPU path -------------
  # Continuous tensors are held to float tolerance, and the rest of the path
  # starts from the same latents on both devices, so that no float
  # difference flips a rounded symbol. The hyper-latent rate is held through
  # the prior's CDF logits: where those of z_hat -/+ .5 sum to exactly zero,
  # the reference's sign trick (shallow_ntc_tpu/ops/entropy.py:164) takes
  # p = 0 and the 1e-9 floor, so which of those elements hit the floor
  # depends on the last bit of each device's arithmetic.
  small = torch.from_numpy(images[:1, :192, :256])

  reference = make_reference(small, zero_counts, read_counts)

  model_cpu = eval_lib.build_model(configs.TWO_LAYER_SYN_RD, init_seed=0, device="cpu")
  reference("reference", model, model_cpu)

  # --- 6. codec: real bitstreams of the flagship and of JPEGL_K16 ---------
  codec_counts = codec_phase(model, model_cpu, images, zero_counts, read_counts, smi)

  # --- 7. train: the flagship's training through its entry point ---------
  del model, model_cpu
  train_cfg = copy.deepcopy(configs.TRAIN_CONFIGS["two_layer_syn_rd"])
  train_cfg["train_eval_config"]["log_metrics_every_steps"] = 1
  val_forwards = train_cfg["train_eval_config"]["max_validation_steps"]
  with tempfile.TemporaryDirectory(prefix="chip_smoke_train_") as workdir:
    zero_counts()
    t = time.time()
    with switch_on("SNTC_FUSED_RB_CHAIN"):
      state = train_lib.train_and_eval(train_cfg, workdir, device="cuda", init_seed=0,
                                       num_steps=TRAIN_STEPS)
    train_counts = read_counts()
    train_s = time.time() - t
    with open(os.path.join(workdir, "train", "record.jsonl")) as f:
      train_records = [json.loads(line) for line in f]
    with open(os.path.join(workdir, "val", "record.jsonl")) as f:
      val_records = [json.loads(line) for line in f]
    for r in train_records:
      log("train", f"step {r['step']}: rd_loss {r['rd_loss']:.5f} bpp {r['bpp']:.5f} "
          f"psnr {r['psnr']:.4f} scheduled_lr {r['scheduled_lr']:.4e} "
          f"steps/s {r['steps_per_sec']:.3f}")
    log("train", f"val at step {val_records[-1]['step']}: rd_loss {val_records[-1]['rd_loss']:.5f}"
        f" msssim {val_records[-1]['msssim']:.5f}; {TRAIN_STEPS} steps of B={TRAIN_BATCH} "
        f"{TRAIN_HW}x{TRAIN_HW} f32 + {val_forwards} val images in {train_s:.1f}s; "
        f"launches {train_counts}")
    check([r["step"] for r in train_records] == list(range(1, TRAIN_STEPS + 1))
          and all(np.isfinite(v) for r in train_records + val_records for v in r.values()),
          "a train step's metrics are missing or not finite")
    forwards = TRAIN_STEPS + val_forwards
    check(train_counts[rb.STATS.name] == CHAINS_PER_FORWARD * forwards,
          f"the chain kernel ran {train_counts[rb.STATS.name]} times in {forwards} forwards")
    check(train_counts[tl.STATS.name] >= forwards,
          f"final_deconv_phase ran {train_counts[tl.STATS.name]} times in {forwards} forwards")
    init_model, opt_cfg = train_lib.build_model(train_cfg["model_config"], init_seed=0,
                                                device="cuda")
    unmoved = [k for k, v in init_model.state_dict().items()
               if torch.equal(v, state.model.state_dict()[k])]
    log("train", f"{len(unmoved)} of {len(init_model.state_dict())} parameter tensors "
        f"unchanged after {TRAIN_STEPS} steps")
    check(not unmoved, f"parameters did not move: {unmoved[:5]}")
    restored, _ = train_lib.create_train_state(init_model, opt_cfg, seed=1)
    train_lib.restore_checkpoint(workdir, restored)
    same = (restored.step == state.step == TRAIN_STEPS
            and restored.optimizer.count == state.optimizer.count
            and all(torch.equal(a, b) for a, b in zip(init_model.state_dict().values(),
                                                      state.model.state_dict().values()))
            and all(torch.equal(a, b) for a, b in zip(
                restored.optimizer.mu + restored.optimizer.nu,
                state.optimizer.mu + state.optimizer.nu))
            and torch.equal(restored.generator.get_state(), state.generator.get_state()))
    log("train", f"checkpoint at step {restored.step} restored equal to the live state: {same}")
    check(same, "the restored checkpoint differs from the live state")
  del state, restored, init_model

  # --- 8. train-reference: the GPU train step against the CPU one ----------
  t = time.time()
  ref_models = {d: train_lib.build_model(train_cfg["model_config"], init_seed=0, device=d)[0]
                for d in ("cuda", "cpu")}
  batch = (rng.integers(0, 256, (2, 64, 64, 3)) / 255.0 - 0.5).astype(np.float32)
  noise = [rng.uniform(-0.5, 0.5, shape).astype(np.float32)
           for shape in ((2, 1, 1, 320), (2, 4, 4, 320))]
  ref_metrics = {}
  zero_counts()
  with switch_on("SNTC_FUSED_RB_CHAIN"):
    for d, m in ref_models.items():
      ref_state, lr_fn = train_lib.create_train_state(m, opt_cfg)
      ref_metrics[d] = train_lib.make_train_step(m, ref_state.optimizer, lr_fn)(
          ref_state, torch.from_numpy(batch).to(d),
          noise=tuple(torch.from_numpy(u).to(d) for u in noise))
  ref_counts = read_counts()
  failures = []
  for key, cpu_v in ref_metrics["cpu"].items():
    gpu_v, cpu_v = float(ref_metrics["cuda"][key]), float(cpu_v)
    rel = abs(gpu_v - cpu_v) / max(abs(cpu_v), 1e-30)
    log("train-reference", f"B=2 64x64 {key}: gpu {gpu_v:.6f} cpu {cpu_v:.6f} rel {rel:.2e} "
        "(tol 1e-4)")
    if rel > 1e-4:
      failures.append(key)
  # Each gradient tensor within 1e-3 max|g| + 1e-6 elementwise. A relu whose
  # input lies within float32 rounding of 0 (|a| ~ 1e-8 at this seeded init)
  # can take the other side on the other device, in either path; the flip
  # moves the gradients it feeds by one pixel's term (up to ~1% of max|g|,
  # ~0.2% in L2, at 64x64). Such a tensor passes only if its L2 error is
  # within 1e-2 of its L2 norm, and is listed; the kernels phase holds each
  # kernel elementwise, so this allowance covers flips only.
  worst, flipped = (0.0, ""), []
  for (name, p_gpu), p_cpu in zip(ref_models["cuda"].named_parameters(),
                                  ref_models["cpu"].parameters()):
    g_cpu = p_cpu.grad
    diff = (p_gpu.grad.cpu() - g_cpu).abs()
    tol = 1e-3 * g_cpu.abs().max().item() + 1e-6
    worst = max(worst, (diff.max().item() / tol, name))
    if diff.max().item() <= tol:
      continue
    l2_rel = (diff.norm() / (g_cpu.norm() + 1e-30)).item()
    flipped.append(f"{name} (L2 rel {l2_rel:.2e})")
    if l2_rel > 1e-2:
      failures.append(name)
  log("train-reference", f"gradients of {len(list(ref_models['cpu'].parameters()))} tensors: "
      f"worst max|gpu-cpu| / (1e-3 max|g| + 1e-6) = {worst[0]:.3e} ({worst[1]}); "
      f"{len(flipped)} tensors pass by the relu-flip allowance only: {flipped}; "
      f"GPU launches {ref_counts}; done in {time.time() - t:.1f}s")
  check(ref_counts[rb.STATS.name] == CHAINS_PER_FORWARD,
        "the GPU reference step did not run the chain kernel")
  check(not failures, f"the GPU train step disagrees with the CPU one: {failures[:8]}")
  del ref_models

  # --- 9. eval-jpegl: the JPEG-like model, k18 (cuDNN) and K16 (the kernel) --
  jpegl = {}
  for name, cfg in (("jpegl_rd", configs.JPEGL_RD), ("JPEGL_K16", configs.JPEGL_K16)):
    m = eval_lib.build_model(cfg, init_seed=0, device="cuda")
    zero_counts()
    t = time.time()
    recs = list(eval_lib.evaluate_images(m, images))
    counts = read_counts()
    jpegl[name] = (m, recs, counts)
    for i, r in enumerate(recs):
      log("eval-jpegl", f"{name} image {i} {EVAL_HW[0]}x{EVAL_HW[1]}: bpp {r['bpp']:.5f} "
          f"psnr {r['psnr']:.4f} msssim {r['msssim']:.5f} rd_loss {r['rd_loss']:.5f}")
    log("eval-jpegl", f"{name}: {len(recs)} images in {time.time() - t:.2f}s; launches {counts}")
    check(all(np.isfinite(r[k]) for r in recs for k in ("bpp", "psnr", "msssim", "rd_loss")),
          f"{name} eval metrics not finite")
  check(jpegl["JPEGL_K16"][2][jd.STATS.name] >= len(images),
        f"the K16 eval launched jpegl_synthesize {jpegl['JPEGL_K16'][2][jd.STATS.name]} times")
  check(jpegl["jpegl_rd"][2][jd.STATS.name] == 0, "the k18 eval launched jpegl_synthesize")
  k16_cpu = eval_lib.build_model(configs.JPEGL_K16, init_seed=0, device="cpu")
  ref_counts = reference("eval-jpegl", jpegl["JPEGL_K16"][0], k16_cpu)
  check(ref_counts[jd.STATS.name] == 1, "the K16 GPU reference did not launch jpegl_synthesize")
  jpegl_eval_launches = jpegl["JPEGL_K16"][2][jd.STATS.name]
  del jpegl, k16_cpu

  # --- 10. train-jpegl: jpegl_rd's training through its entry point -------
  jl_cfg = copy.deepcopy(configs.TRAIN_CONFIGS["jpegl_rd"])
  jl_cfg["train_eval_config"]["log_metrics_every_steps"] = 1
  with tempfile.TemporaryDirectory(prefix="chip_smoke_train_jpegl_") as workdir:
    zero_counts()
    t = time.time()
    with switch_on("SNTC_FUSED_RB_CHAIN"):
      state = train_lib.train_and_eval(jl_cfg, workdir, device="cuda", init_seed=0,
                                       num_steps=JPEGL_TRAIN_STEPS)
    jl_counts = read_counts()
    with open(os.path.join(workdir, "train", "record.jsonl")) as f:
      jl_records = [json.loads(line) for line in f]
    with open(os.path.join(workdir, "val", "record.jsonl")) as f:
      jl_val = [json.loads(line) for line in f]
  for r in jl_records:
    log("train-jpegl", f"step {r['step']}: rd_loss {r['rd_loss']:.5f} bpp {r['bpp']:.5f} "
        f"psnr {r['psnr']:.4f} steps/s {r['steps_per_sec']:.3f}")
  jl_forwards = JPEGL_TRAIN_STEPS + jl_cfg["train_eval_config"]["max_validation_steps"]
  log("train-jpegl", f"val rd_loss {jl_val[-1]['rd_loss']:.5f}; {JPEGL_TRAIN_STEPS} steps of "
      f"B={TRAIN_BATCH} {TRAIN_HW}x{TRAIN_HW} f32 + val in {time.time() - t:.1f}s; "
      f"launches {jl_counts}")
  check([r["step"] for r in jl_records] == list(range(1, JPEGL_TRAIN_STEPS + 1))
        and all(np.isfinite(v) for r in jl_records + jl_val for v in r.values()),
        "a jpegl_rd train step's metrics are missing or not finite")
  check(jl_counts[rb.STATS.name] == CHAINS_PER_FORWARD * jl_forwards
        and jl_counts[jd.STATS.name] == 0, f"jpegl_rd training launched {jl_counts}")
  jl_init, _ = train_lib.build_model(jl_cfg["model_config"], init_seed=0, device="cuda")
  unmoved = [k for k, v in jl_init.state_dict().items()
             if torch.equal(v, state.model.state_dict()[k])]
  log("train-jpegl", f"{len(unmoved)} of {len(jl_init.state_dict())} parameter tensors "
      f"unchanged after {JPEGL_TRAIN_STEPS} steps")
  check(not unmoved, f"jpegl_rd parameters did not move: {unmoved[:5]}")
  del state, jl_init

  # --- 11. timing -----------------------------------------------------------
  # The full-width train step, chain kernel off and on, in turns (off, on,
  # on, off), each the mean of 8 steps by CUDA events after 2 warm-up steps.
  t_model, _ = train_lib.build_model(train_cfg["model_config"], init_seed=0, device="cuda")
  t_state, lr_fn = train_lib.create_train_state(t_model, opt_cfg)
  t_step = train_lib.make_train_step(t_model, t_state.optimizer, lr_fn)
  t_batch = torch.from_numpy((rng.integers(0, 256, (TRAIN_BATCH, TRAIN_HW, TRAIN_HW, 3))
                              / 255.0 - 0.5).astype(np.float32)).to(dev)
  step_ms = {"off": [], "on": []}
  for way in ("off", "on", "on", "off"):
    if way == "on":
      with switch_on("SNTC_FUSED_RB_CHAIN"):
        step_ms[way].append(cuda_ms(torch, lambda: t_step(t_state, t_batch), iters=8, warmup=2))
    else:
      step_ms[way].append(cuda_ms(torch, lambda: t_step(t_state, t_batch), iters=8, warmup=2))
  zero_counts()
  with switch_on("SNTC_FUSED_RB_CHAIN"):
    t_step(t_state, t_batch)
  step_counts = read_counts()
  check(step_counts[rb.STATS.name] == CHAINS_PER_FORWARD and step_counts[tl.STATS.name] >= 1,
        f"one train step launched {step_counts}")
  train_step_ms = {k: float(np.mean(v)) for k, v in step_ms.items()}
  log("timing", f"train step B={TRAIN_BATCH} {TRAIN_HW}x{TRAIN_HW} f32: chain kernel off "
      + " / ".join(f"{x:.3f}" for x in step_ms["off"]) + " ms, on "
      + " / ".join(f"{x:.3f}" for x in step_ms["on"]) + f" ms; one step launches "
      f"{step_counts}  [{smi}]")
  del t_model, t_state, t_step, t_batch

  def time_rb(case, dtype):
    b, h, w, c, n = case
    params = rb_params(n, c, seed=sum(case))
    x = torch.from_numpy(rng.standard_normal((b, h, w, c), np.float32)).to(dev, dtype)
    fn = ((lambda: resblock.fused_resblock_cuda(x, *params[0])) if n == 1
          else (lambda: rb.rb_chain_cuda(x, params)))
    ms = cuda_ms(torch, fn, iters=10, warmup=2, host_ahead=True)
    plain = cuda_ms(torch, lambda: rb.dense_rb_chain(x, params), iters=10, warmup=2,
                    host_ahead=True)
    bound, by = rb_chain_bound_ms(x, n, str(dtype).split(".")[-1])
    name = "fused_resblock" if n == 1 else "fused_rb_chain"
    log("timing", f"{name} B={b} {h}x{w} C={c} N={n} {dtype}: kernel {ms:.5f} ms, plain "
        f"(cuDNN) {plain:.5f} ms, bound {bound:.5f} ms ({by})  [{smi}]")
    return dict(ms=ms, plain_ms=plain, bound_ms=bound, bound_by=by, library_ms=None,
                shape=f"B={b} {h}x{w} C={c} N={n} {str(dtype).split('.')[-1]}",
                max_abs_err=errs[(name, case, dtype)])

  rb_block = rb_train[:4] + (1,)
  chain_t = {k: time_rb(case, dtype) for k, case, dtype in (
      ("train f32", rb_train, torch.float32), ("train bf16", rb_train, torch.bfloat16),
      ("eval f32", rb_eval, torch.float32))}
  # The other stages of a train forward (3, 1 and 2 chains of its 7).
  for case in rb_stages:
    for dtype in (torch.float32, torch.bfloat16):
      chain_t[f"stage {case[1]}x{case[2]} C={case[3]} {str(dtype).split('.')[-1]}"] = time_rb(
          case, dtype)
  block_t = {k: time_rb(rb_block, dtype) for k, dtype in (
      ("train f32", torch.float32), ("train bf16", torch.bfloat16))}

  pixels = DECODE_BATCH * EVAL_HW[0] * EVAL_HW[1]
  decode_ms = cuda_ms(torch, decode, iters=20, warmup=3)
  log("timing", f"decode B={DECODE_BATCH} {EVAL_HW[0]}x{EVAL_HW[1]} bf16: {decode_ms:.4f} ms, "
      f"{pixels / decode_ms / 1e3:.2f} Mpx/s  [{smi}]")

  def time_final(b, h, w, dtype):
    """The kernel with its weights and bias in the input's type, as the
    model's parameters are, so a call launches the kernel alone."""
    mid, kern, bias = final_inputs(b, h, w, dtype)
    bias = bias.to(dtype)
    out = tl.final_deconv_cuda(mid, kern, bias, 12)
    x_d2s = fd.depth_to_space(mid, 8).permute(0, 3, 1, 2)  # NCHW view, channels-last
    weight = kern.flip(0, 1).permute(2, 3, 0, 1).contiguous()
    lib = F.conv_transpose2d(x_d2s, weight, bias, stride=2, padding=1)
    lib_err = (lib[:, :, : 16 * h, : 16 * w].permute(0, 2, 3, 1).float()
               - out.float()).abs().max().item()
    ms = cuda_ms(torch, lambda: tl.final_deconv_cuda(mid, kern, bias, 12), host_ahead=True)
    call = cuda_ms(torch, lambda: tl.final_deconv_cuda(mid, kern, bias, 12))
    plain = cuda_ms(torch, lambda: tl.final_deconv_plain(mid, kern, bias, 12), iters=20,
                    host_ahead=True)
    lib_ms = cuda_ms(torch, lambda: F.conv_transpose2d(x_d2s, weight, bias, stride=2,
                                                       padding=1), host_ahead=True)
    bound, by = final_deconv_bound_ms(mid, out, kern, str(dtype).split(".")[-1])
    log("timing", f"final_deconv_phase B={b} {h}x{w} {dtype}: kernel {ms:.5f} ms (a call "
        f"{call:.5f} ms), plain {plain:.5f} ms, conv_transpose2d {lib_ms:.5f} ms (vs kernel "
        f"max|diff| {lib_err:.2e}), bound {bound:.5f} ms ({by})  [{smi}]")
    return dict(ms=ms, call_ms=call, plain_ms=plain, bound_ms=bound, bound_by=by,
                library_ms=lib_ms)

  decode_t = time_final(DECODE_BATCH, mh, mw, torch.bfloat16)
  eval_t = time_final(1, mh, mw, torch.float32)
  train_fd_t = time_final(*fd_train[:4])
  itinf_bf16_t = time_final(*fd_itinf_bf16[:4])
  del model_bf16

  # The JPEG-like decode at the same shape: k18 (cuDNN) and K16 (the kernel).
  jl_decode_ms, jl_decode_launches = {}, {}
  for name, cfg in (("jpegl_rd", configs.JPEGL_RD), ("JPEGL_K16", configs.JPEGL_K16)):
    m = eval_lib.build_model(cfg, init_seed=0, device="cuda").to(torch.bfloat16)

    def decode_jpegl():
      with torch.no_grad():
        mu, idx = m.hyper_synthesize(z_hat)
        return mu, idx, m.synthesize(y_hat)

    zero_counts()
    mu, idx, rec = decode_jpegl()
    jl_decode_launches[name] = read_counts()[jd.STATS.name]
    check(rec.shape == (DECODE_BATCH,) + EVAL_HW + (3,) and torch.isfinite(rec).all().item()
          and mu.shape == y_hat.shape and torch.isfinite(idx).all().item(),
          f"the {name} decode output has the wrong shape or is not finite")
    jl_decode_ms[name] = cuda_ms(torch, decode_jpegl, iters=20, warmup=3)
    log("timing", f"decode {name} B={DECODE_BATCH} {EVAL_HW[0]}x{EVAL_HW[1]} bf16: "
        f"{jl_decode_ms[name]:.4f} ms, {pixels / jl_decode_ms[name] / 1e3:.2f} Mpx/s; "
        f"jpegl_synthesize launches in one decode: {jl_decode_launches[name]}  [{smi}]")
    del m
  check(jl_decode_launches["JPEGL_K16"] == 1 and jl_decode_launches["jpegl_rd"] == 0,
        f"jpegl_synthesize launches per decode: {jl_decode_launches}")

  # The decodes of phases 13 and 14's configurations at the same shape:
  # bls2017_rd (the factorized family: the synthesis alone, y of 192
  # channels), two_layer_syn2 (final_deconv_phase) and mbt2018 (cuDNN only).
  fam_decode = {}
  nd_rng = np.random.default_rng(13)
  y_hat_192 = torch.from_numpy(nd_rng.integers(-8, 8, (DECODE_BATCH, mh, mw, 192))).to(
      dev, torch.bfloat16)
  for name in ("bls2017_rd", "two_layer_syn2", "mbt2018"):
    cfg, _, family = configs.eval_config(name)
    m = eval_lib.build_model(cfg, init_seed=0, device="cuda", family=family).to(torch.bfloat16)
    fn = make_decode(m, y_hat_192 if family == "factorized" else y_hat, z_hat)
    zero_counts()
    check_decode(name, fn(), y_hat_192 if family == "factorized" else y_hat)
    fd_launches = read_counts()[tl.STATS.name]
    ms = cuda_ms(torch, fn, iters=20, warmup=3)
    fam_decode[name] = dict(ms=ms, mpx_per_s=pixels / ms / 1e3, launches=fd_launches)
    log("timing", f"decode {name} B={DECODE_BATCH} {EVAL_HW[0]}x{EVAL_HW[1]} bf16: {ms:.4f} ms, "
        f"{pixels / ms / 1e3:.2f} Mpx/s; final_deconv_phase launches in one decode: "
        f"{fd_launches}  [{smi}]")
    del m
  check([v["launches"] for v in fam_decode.values()] == [0, 1, 0],
        f"final_deconv_phase launches per decode: {fam_decode}")

  def time_jpegl(case):
    """The kernel with its weights and bias in z's type, as the model's
    parameters are, so a call launches the kernel alone."""
    b, hl, wl, c, k, dtype, _ = case
    z, kern, bias = jpegl_inputs(*case)
    out = jd.jpegl_synthesize_cuda(z, kern, bias)
    zn = z.permute(0, 3, 1, 2)  # NCHW view of the NHWC latents
    weight = kern.flip(0, 1).permute(2, 3, 0, 1).contiguous()

    def lib():
      return F.conv_transpose2d(zn, weight, bias, stride=k)

    lib_err = (lib().permute(0, 2, 3, 1).float() - out.float()).abs().max().item()
    ms = cuda_ms(torch, lambda: jd.jpegl_synthesize_cuda(z, kern, bias), host_ahead=True)
    call = cuda_ms(torch, lambda: jd.jpegl_synthesize_cuda(z, kern, bias))
    plain = cuda_ms(torch, lambda: jd.jpegl_synthesize_plain(z, kern, bias), iters=20,
                    host_ahead=True)
    lib_ms = cuda_ms(torch, lib, host_ahead=True)
    bound, by = jpegl_bound_ms(z, out, kern, str(dtype).split(".")[-1])
    log("timing", f"jpegl_synthesize B={b} {hl}x{wl} C={c} {dtype}: kernel {ms:.5f} ms (a call "
        f"{call:.5f} ms), plain {plain:.5f} ms, conv_transpose2d {lib_ms:.5f} ms (vs kernel "
        f"max|diff| {lib_err:.2e}), bound {bound:.5f} ms ({by})  [{smi}]")
    return dict(ms=ms, call_ms=call, plain_ms=plain, bound_ms=bound, bound_by=by,
                library_ms=lib_ms)

  jl_decode_t = time_jpegl(jl_decode)
  jl_eval_t = time_jpegl(jl_eval)

  # --- 12. itinf: SGA iterative inference of the flagship ----------------
  itinf = itinf_phase(images[0], zero_counts, read_counts, smi)

  # --- 13. factorized: the factorized family end to end -------------------
  fact = factorized_phase(images, zero_counts, read_counts, smi, reference)

  # --- 14. families: two_layer_syn2 (mixedq) and mbt2018 ------------------
  fam_launches = families_phase(images, zero_counts, read_counts, smi, reference)

  # --- 15. int8: the int8 inference paths ----------------------------------
  int8 = int8_phase(images, zero_counts, read_counts, smi)

  # --- 16. inference-extras: LPIPS, ElicSynthesis, res_type="d2s" ---------
  extras = extras_phase(images, zero_counts, read_counts, smi)
  codec_fd = sum(codec_counts[k][tl.STATS.name]
                 for k in ("flagship_compress", "flagship_decompress"))
  codec_k16 = sum(codec_counts[k][jd.STATS.name] for k in ("k16_compress", "k16_decompress"))
  itinf_fd = itinf["launches"][tl.STATS.name]
  kernels = [dict(
      name=tl.STATS.name, route="cuda",
      source="shallow_ntc_tpu_torch/csrc/final_deconv.cu",
      replaces="shallow_ntc_tpu/ops/pallas/twolayer_final.py:273",
      launches=int8["final_deconv_launches"],
      path="int8: the flagship's B=8 decode in float, int8_syn and int8_all, and the eval of "
           "3 images in 5 arms (the final stage stays float)",
      max_abs_err=errs[("final_deconv_phase", cases[1])],
      **decode_t,
      shape=f"B={DECODE_BATCH} mid {mh}x{mw}x768 bf16 (decode)",
      eval_shape=dict(shape=f"B=1 mid {mh}x{mw}x768 f32 (eval)",
                      max_abs_err=errs[("final_deconv_phase", cases[0])], **eval_t),
      train_shape=dict(shape=f"B={fd_train[0]} mid {fd_train[1]}x{fd_train[2]}x768 f32 (train)",
                       max_abs_err=errs[("final_deconv_phase", fd_train)], **train_fd_t),
      itinf_bf16_shape=dict(shape=f"B=1 mid {mh}x{mw}x768 bf16 (SGA step, bf16 transforms)",
                            max_abs_err=errs[("final_deconv_phase", fd_itinf_bf16)],
                            **itinf_bf16_t),
      decode_mpx_per_s=pixels / decode_ms / 1e3)]
  # Launches: this slice's paths are the int8 decode and eval (phase 15:
  # final_deconv_phase once a forward, as the final stage stays float; the
  # chain in the encode gate's precedence check) and ElicSynthesis with the
  # chain on (phase 16). The earlier slices' paths beside them: SGA (phase
  # 12), the codec of phase 6 (one compress and one decompress of image 0, a
  # compress with the chain, the JPEGL_K16 round trip), the training run of
  # phase 7 (4 steps and the final eval), the eval of image 0 with
  # SNTC_FUSED_RESBLOCK=1 (fused_resblock's own path, phase 4), the K16 eval
  # of phase 9. The chain's times are at train stage 1 in f32.
  kernels[0]["launches_by_path"] = {
      "int8": int8["final_deconv_launches"],
      "itinf": itinf_fd, "itinf bf16": itinf["bf16_launches"][tl.STATS.name],
      "codec": codec_fd, "eval+decode": launches, "train": train_counts[tl.STATS.name],
      **{f"two_layer_syn2 {k}": v for k, v in fam_launches["two_layer_syn2"].items()}}
  kernels[0]["family_decodes"] = fam_decode
  kernels[0]["factorized"] = fact
  kernels[0]["int8"] = int8
  kernels[0]["inference_extras"] = extras
  kernels.append(dict(
      name=rb.STATS.name, route="cuda", source="shallow_ntc_tpu_torch/csrc/rb_chain.cu",
      replaces="shallow_ntc_tpu/ops/pallas/rb_chain.py:263",
      launches=extras["chain_launches"] + int8["chain_launches"],
      path="ElicSynthesis at 32x48x320 with SNTC_FUSED_RB_CHAIN=1, and the flagship's "
           "analysis with the chain and SNTC_INT8_ENCODE=1",
      launches_by_path={"ElicSynthesis": extras["chain_launches"],
                        "int8 encode precedence": int8["chain_launches"],
                        "itinf": itinf["launches"][rb.STATS.name],
                        "codec": codec_counts["chain_compress"][rb.STATS.name],
                        "train": train_counts[rb.STATS.name]},
      **chain_t["train f32"], other_shapes={k: v for k, v in chain_t.items() if k != "train f32"}))
  kernels.append(dict(
      name=resblock.STATS.name, route="cuda", source="shallow_ntc_tpu_torch/csrc/rb_chain.cu",
      replaces="shallow_ntc_tpu/ops/pallas/resblock.py:202",
      launches=ways["resblock"][1][resblock.STATS.name], path="eval image 0, SNTC_FUSED_RESBLOCK=1",
      **block_t["train f32"], other_shapes={"train bf16": block_t["train bf16"]}))
  kernels[1]["train_step_ms"] = train_step_ms
  kernels[0]["itinf_step_ms"] = itinf["step_ms"]
  # jpegl_synthesize's times at the decode shape (B=8 bf16), the eval shape
  # beside them. ms is the device time of the kernel alone: weights and bias
  # in z's type.
  kernels.append(dict(
      name=jd.STATS.name, route="cuda", source="shallow_ntc_tpu_torch/csrc/jpegl_decode.cu",
      replaces="shallow_ntc_tpu/ops/pallas/jpegl_decode.py:75",
      launches=codec_k16, path="codec: JPEGL_K16 compress + decompress",
      max_abs_err=errs[("jpegl_synthesize", jl_decode)], **jl_decode_t,
      shape=f"B={DECODE_BATCH} z {mh}x{mw}x320 bf16 (decode)",
      eval_shape=dict(shape=f"B=1 z {mh}x{mw}x320 f32 (eval)",
                      max_abs_err=errs[("jpegl_synthesize", jl_eval)], **jl_eval_t),
      launches_by_path={"codec K16": codec_k16, "eval K16": jpegl_eval_launches,
                        "decode K16": jl_decode_launches["JPEGL_K16"]},
      decode_mpx_per_s={k: pixels / v / 1e3 for k, v in jl_decode_ms.items()}))
  print(json.dumps({"kernels": kernels}), flush=True)
  print(smi, flush=True)
  print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                           "count": torch.cuda.device_count()}}), flush=True)
  return 0


if __name__ == "__main__":
  sys.exit(main())
