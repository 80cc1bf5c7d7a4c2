#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (shallow_ntc_tpu_torch) on one NVIDIA GPU.

  python3 chip_smoke.py

Phases, one flushed line each with its seconds (TF32 off but where a phase
says otherwise):
  1. build     nvcc builds every CUDA kernel of the main paths (csrc/*.cu),
               one process per source, and g++ the codec's rANS coder
               (codec/rans.cc) and the image loader (dataio/loader.cc), all
               started together.
  2. device    the card's name, and its name and power limit from nvidia-smi.
  3. kernels   each kernel against its plain PyTorch version on the card, at
               the main paths' shapes plus odd ones, f32 and bf16, and its
               gradients through its autograd.Function (jpegl_synthesize has
               none: its backward must raise); fused_rb_chain_padded's
               keep_pad output (interior bit for bit the dense kernel's, pad
               columns 0, one launch a chain); fails on a miss.
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
               params, batch and noise: loss, metrics and every gradient;
               then two Adam updates of the full-width flagship's 169
               parameter tensors on the card, train_lib.Adam's multi-tensor
               update against the per-parameter loop (loop_adam_update) from
               the same state: unclipped bit for bit, clipped within 1e-7.
  9. eval-jpegl  the JPEG-like model at full width (ELIC 192/192/192/320),
               seeded weights, three 512x768 f32 images each: jpegl_rd (k18,
               the paper's decoder, a cuDNN transposed conv) and JPEGL_K16
               (k16, through jpegl_synthesize); then K16 on the card against
               the port's CPU eval on a 192x256 crop, as in phase 5.
 10. train-jpegl  2 steps of jpegl_rd through train_lib.train_and_eval at
               B=8 256x256 f32 with SNTC_FUSED_RB_CHAIN=1: losses finite,
               params moved, no jpegl_synthesize launch (k18).
 11. timing    the train step with the chain kernel on and off, 4 turns of
               each, at TF32 off and at TF32 on (the train CLI's default),
               the spread of the turns logged; at TF32 on with the chain
               off, 4 turns each of the step with train_lib.Adam's
               multi-tensor update and with the per-parameter loop; the chain at
               each train stage; the B=8 bf16
               decode in Mpx/s of the flagship, jpegl_rd and JPEGL_K16; each
               kernel, its plain version and (where one exists) one PyTorch
               library call computing the same function, by CUDA events,
               beside its bound (final_deconv_phase at the decode, eval and
               train shapes, and at B=1 bf16, the SGA step's with bf16
               transforms); each decode's model FLOPs (utils/profiling
               .get_flops on the card), TFLOP/s and share of the bf16 dense
               peak.
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
 17. experiments  the experiment workflow through its CLIs, each run as
               `python -m` in a process of its own whose launch counts start
               at 0 and are read at its end, under a temporary directory:
               python -m shallow_ntc_tpu_torch.deadleaves (16 train PNGs at
               320x320, 2 valid and 2 eval at 512x768); read_png's time at
               512x768 and a write -> read round trip; mshyper.train of
               mshyper/configs/two_layer_syn_rd.py --hid 3 (lambda 0.01) for
               4 steps at B=8 256x256 with SNTC_FUSED_RB_CHAIN=1, TF32 off,
               2 validation images (the chain 7 and final_deconv_phase once
               a forward); mshyper.itinf of itinf.py --hid 3 warm-started
               from that experiment by wid beside a decoy work unit wid=0,
               100 SGA steps of the 2 eval images (the digest of the params
               the CLI started from, in its warm_start.json, equal to the
               checkpoint's and not the decoy's); eval --workdir --dataset
               deadleaves_eval --profile (records equal to an in-process
               eval of the checkpoint to rel 1e-5, the three profile times,
               the link); bls2017_rd.py trained 2 steps and evaluated (no
               kernel launches).
 18. parallel  the multi-device paths on the one card, the flagship at full
               width: MS-SSIM's moment filters under TF32 against the repaired
               ones; the height-split eval of a 512x768 image on 2 and 4
               strips (devices=[cuda:0] * N) against the unsplit eval (bpp,
               PSNR, rd_loss rtol 1e-4; final_deconv_phase once a strip;
               times); the eval twice (its forward under deterministic
               cuDNN, held bit for bit) and its forward twice with cuDNN's
               default algorithms (the first module whose output then
               differs run to run), and the forward's ms both ways by CUDA
               events in 40 alternating pairs, beside phase 4's eval ms per
               image; the train CLI with --dp_devices 2 --dist_backend gloo
               (two spawned ranks on cuda:0, 3 steps at B=8 256x256 and lr
               1e-4 without warm-up, the chain on, each rank's launch
               counts; every run of this part under deterministic cuDNN)
               against --dp_devices 1 on the same global batches (rd_loss
               rtol 1e-4, ms a step), its params against one process that
               averages the two half batches' gradients (rtol 2e-3 atol
               2e-6; measured bit for bit), and a control with each rank on
               its own gradients, which must exceed that tolerance; one
               NCCL rank through --coordinator (2 steps) whose checkpoint
               evaluates; the codec CLI (--spatial_devices 1) on a PNG of
               that workdir, its bitstream decoded by a 2-strip codec and a
               2-strip bitstream by the CLI, each bit for bit.
 19. image-input  JPEG input on the native loader (dataio/): the host's
               jpeglib.h / png.h / zlib.h, image libraries and g++; every
               image of tests/data/jpeg/ decoded twice, equal to the
               digests of the JAX package's reads (tests/data/jpeg_sha256.json:
               PIL, and JAX's libjpeg/libpng loader; the CMYK JPEG must
               raise); decode_crop_batch with 1 and 8 threads equal, centre
               crops equal to the whole decode's window; the loader's ms per
               B=8 batch of 256x256 crops of the 640x480 JPEGs (median of
               20, 1 and 8 threads) beside phase 11's train step;
               mshyper/configs/two_layer_syn.py (the paper's flagship,
               dataset cocotrain) through python -m
               shallow_ntc_tpu_torch.mshyper.train with
               SHALLOW_NTC_DATA_DIR holding coco/train2017/*.jpg (the 8
               JPEGs) and kodak_landscape/*.png (2 dead-leaves 512x768), 3
               steps at B=8 256x256 with SNTC_FUSED_RB_CHAIN=1 (the chain 7
               and final_deconv_phase once a forward), its checkpoint
               evaluated; a DatasetIterable whose ImageStore's cache_limit
               is under 10x the corpus takes the native branch, and 2 of its
               batches go through the flagship's train step.
 20. flops     model FLOPs counted from the shapes (utils/profiling.py):
               scripts/torch_get_flops.py's table at 512x768 on the card (the
               kernels on their routes) equal to a CPU count of the same run
               and to results/flops_audit.csv (params equal, FLOPs within
               2%); the eval of one 512x768 image counted on the card with
               SNTC_FUSED_RB_CHAIN=1, with SNTC_FUSED_RESBLOCK=1 and for
               JPEGL_K16, each equal to the CPU count, with
               final_deconv_phase, fused_rb_chain, fused_resblock and
               jpegl_synthesize launched in the counted forwards; the
               decodes' model TFLOP/s of phase 11 beside the bf16 peak; a
               profiling.trace of one decode that names the port's kernels.
 21. tf-checkpoint  the reference's TF checkpoints without TensorFlow
               (utils/tf_checkpoint.py, convert_tf_checkpoint.py): the
               committed fixture tests/data/tf_ckpt/ read with its crc32c
               checks, every variable equal to the digests of TF's reads
               (tests/data/tf_ckpt_sha256.json); converted through the CLI
               (its own process, --device cuda), the workdir evaluated on the
               card against the CPU as in phase 5; the full-width flagship's
               seeded params laid out as the reference's TF variables,
               converted into a workdir on the card: params bit for bit the
               seeded ones, and its eval of one 512x768 image with
               SNTC_FUSED_RB_CHAIN=1 bit for bit the seeded model's, with
               final_deconv_phase once and the chain 7 times; its ms an image
               by CUDA events.
 22. rd-pipeline  the R-D result tools (shallow_ntc_tpu_torch/results.py),
               each CLI in its own process on phase 17's workdirs (the
               full-width two_layer_syn_rd.py --hid 3 trained 4 steps, its
               100-step SGA of 2 images): scripts/torch_itinf_to_results.py
               and scripts/aggregate_results.py over its SGA workdir and
               eval JSON; codec overhead and int8 quality of the 2 512x768
               eval images, the basis grid and the saved-latent eval on the
               card (SNTC_FUSED_RB_CHAIN=1) against --device cpu runs: every
               round trip lossless, PSNR and y's rate within phase 5's rtol
               1e-3 (the real bytes and z's rate reported, as phase 5
               reports them), int8_syn's rate the float path's, the basis
               within 1e-3, final_deconv_phase and fused_rb_chain launched
               as each process should; 3 SGA steps of jpegl_rd (k18s16) on
               the card against the CPU on phase 5's crop.
 23. measure   the measurement layer (shallow_ntc_tpu_torch/measure.py), each
               CLI in its own process: scripts/torch_spatial_codec_e2e.py
               --mode card on the 2048x1536 dead-leaves image with
               SNTC_FUSED_RB_CHAIN=1, unsplit and on 2 and 4 strips of
               cuda:0 (each self round trip bit for bit, the cross decodes
               within 1 uint8 at bpp rtol 1e-4, the split evals at rtol
               1e-4, final_deconv_phase once a decode strip and the chain 7
               times an analysis strip in every call, peak memory); the
               card's z and y of that image against the CPU pass (phase 5's
               tolerance); torch_codec_latency.py and torch_codec_e2e_bench.py
               on 8 generated 512x768 PNGs; torch_itinf_bench.py at B=1 and
               B=8; torch_bench_suite.py --fast; torch_encode_roofline.py.
               Then final_deconv_phase at the 2048x1536 codec's B=1 f32 mid
               (128x96) and at SGA's B=8 f32 shape, the chain at B=1
               1024x768 C=192 N=3 f32 and at the encode's B=8 bf16 chain
               stages (256x384, 128x192, 64x96 C=192), each against its
               plain version; all but the last two timed beside the bound.
 24. rd-sweep  the R-D sweep (scripts/torch_rd_run.py), two points at once,
               each in a process of its own: --config bls2017_rd --hids 3 at
               192 filters, 20 train steps on 16 dead-leaves PNGs, eval of 2
               at 512x768 (the other stages skipped); the point's record, its
               aggregate row, its eval against the eval CLI's --device cpu
               pass on the same workdir (PSNR and MSE within phase 13's rtol
               1e-3, bpp reported), no kernel launched (the factorized family
               has none), a second invocation that skips the point. Beside
               it the flagship's point as a full R-D run starts it:
               --config two_layer_syn_rd --hids 2 --keep_checkpoints --skip
               basis at full width, 20 train steps with a checkpoint and a
               val pass every 10 (the train loop keeps both checkpoints),
               eval and codec overhead of 2 images, int8 quality with the
               hyper-decoder's ranges and its --save_hyper .npz of the
               step-10 and final checkpoints, 10 SGA steps; every stage in
               order, the departed step as the int8 records and the
               driver's DEPART_BPP give it, the .npz of the final and the
               departed checkpoint under --root and no other, the train
               stage without the chain kernel (final_deconv_phase once a
               forward), the chain 7 times a forward in the eval and int8
               passes, the records' hyper_ranges, its aggregate rows;
               within 305 s.
 25. graphs    the captured steps (shallow_ntc_tpu_torch/step_graph.py: one
               CUDA graph a step, the train and SGA CLIs' default on the card)
               against the eager loops, full width, seeded weights: SGA of
               512x768 images, 200 steps of the flagship at B=1 in f32 and
               with bf16 transforms, 50 at B=8, 200 of the factorized family;
               10 flagship train steps at B=8 256x256 (TF32 on), the chain
               kernel off and on. Under deterministic algorithms: latents, or
               params and Adam's moments, bit for bit or within 1e-5; a
               replay's launches (final_deconv_phase once, the chain 7 times
               when on) and each run's counts equal to the eager run's. With
               the default algorithms (the B=1 flagship SGA and the train step
               without the chain): ms a step both ways by CUDA events, and how
               far graph departs from eager and eager from eager. A capture
               that cannot run (a .item() in the step) raises, in a process of
               its own.
Phase 11 also times the B=8 bf16 decodes of bls2017_rd, two_layer_syn2 and
mbt2018. Every phase that trains or runs SGA through an entry point (7, 10,
12-14, 17, 19, 22, 24) issues its steps as CUDA graphs, the entry points'
default on the card; phase 18's DDP ranks and its one-process runs
(--dispatch eager) issue them eagerly.
Then one JSON line of kernels, the nvidia-smi line, and the last line
{"ok": true, "device": {...}}. Any failed phase exits non-zero before that
line. Without CUDA, or without the port beside this script, it exits 1.
"""

import concurrent.futures
import contextlib
import copy
import glob as glob_lib
import json
import os
import shutil
import signal
import socket
import subprocess
import sys
import tempfile
import threading
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
  Operations: the wrapper's declared FLOPs of the call (twolayer_final.flops:
  2 * c_in * c_out per (output pixel, tap) pair that reads a mid pixel
  inside the image).
  """
  from shallow_ntc_tpu_torch.ops import twolayer_final

  c_out = kernel.shape[3]
  n_bytes = (mid_p.numel() * mid_p.element_size() + out.numel() * out.element_size()
             + mid_p.element_size() * (kernel.numel() + c_out))
  flops = twolayer_final.flops(mid_p.shape, kernel.shape)
  t_bytes = n_bytes / H100_BYTES_PER_S * 1e3
  t_ops = flops / H100_PEAK_FLOPS[dtype_name] * 1e3
  return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def jpegl_bound_ms(z, out, kernel, dtype_name):
  """Least time for jpegl_synthesize on these inputs: bytes or operations.

  Bytes: z read once, the image written once, the weights and bias once
  (in z's dtype, as the model's). Operations: the wrapper's declared FLOPs
  (jpegl_decode.flops: 2 C per output element).
  """
  from shallow_ntc_tpu_torch.ops import jpegl_decode

  c_out = kernel.shape[3]
  n_bytes = (z.numel() * z.element_size() + out.numel() * out.element_size()
             + (kernel.numel() + c_out) * z.element_size())
  flops = jpegl_decode.flops(z.shape, kernel.shape)
  t_bytes = n_bytes / H100_BYTES_PER_S * 1e3
  t_ops = flops / H100_PEAK_FLOPS[dtype_name] * 1e3
  return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def rb_chain_bound_ms(x, n_blocks, dtype_name, pad=0):
  """Least time for n_blocks residual blocks on x: bytes or operations.

  Bytes: x read once, the output (with `pad` zero columns on each side of
  W for keep_pad) written once, the float32 weights and biases once.
  Operations: the wrapper's declared FLOPs (rb_chain.flops: per block and
  pixel 2 C Ch for each 1x1 conv, and 2 Ch^2 per 3x3 tap that lands inside
  the image: SAME padding multiplies zeros at the edge, which is no work).
  """
  from shallow_ntc_tpu_torch.ops import rb_chain

  c = x.shape[-1]
  ch = c // 2
  n_weights = n_blocks * (c * ch + ch + 9 * ch * ch + ch + ch * c + c)
  out_numel = x.numel() // x.shape[2] * (x.shape[2] + 2 * pad)
  n_bytes = (x.numel() + out_numel) * x.element_size() + 4 * n_weights
  flops = rb_chain.flops(x.shape, ch, n_blocks)
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


def sga_gpu_against_cpu(phase, models, xs, opt_cfg, num_steps):
  """SGA on the card against the CPU: `models` and `xs` map "cuda" and "cpu"
  to a model with the same params and the image batch."""
  import torch
  from shallow_ntc_tpu_torch import itinf_lib

  t = time.time()
  # GPU against CPU: 3 SGA steps from the CPU's latents with the same
  # logistic draws, float32, TF32 off. Latents: each element within 0.05 *
  # the sum of the steps' lr (Adam moves an element by ~lr whatever the size
  # of its gradient, so a gradient whose last bits differ moves it by a
  # fraction of lr), or else, listed, the difference's L2 within 1e-2 of the
  # L2 of the latent's movement (a gradient within rounding of 0 may take
  # the other sign on the other device, and Adam's first step moves that
  # element by lr either way); rd_loss, bpp and PSNR of each step rtol 1e-4.
  fns = {d: itinf_lib.make_itinf_functions(m, opt_cfg, num_steps)
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
  h, w = xs["cpu"].shape[1:3]
  log(phase, f"GPU against CPU, {ITINF_REFERENCE_STEPS} SGA steps at {h}x{w} f32: done in "
      f"{time.time() - t:.1f}s")
  check(not failures, f"the GPU SGA steps disagree with the CPU's: {failures}")


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
  models = {d: eval_lib.build_model(cfg["model_config"], init_seed=0, device=d)
            for d in ("cuda", "cpu")}
  model = models["cuda"]
  xs = {d: torch.from_numpy(x_np).to(d) for d in models}

  sga_gpu_against_cpu(phase, models, xs, opt_cfg, te["num_steps"])
  del models["cpu"]

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


EXP_HID = 3  # two_layer_syn_rd.py's and itinf.py's work unit 3: rd_lambda 0.01, wid 3
EXP_TRAIN_STEPS, EXP_SGA_STEPS = 4, 100


# Runs a CLI in a process of its own and writes its launch counts, which
# start at 0, at its end: [*COUNTED, counts.json, module or script, args...].
COUNTED = [sys.executable, "-m", "shallow_ntc_tpu_torch.utils.counted"]


def run_counted(phase, cwd, env, name, target, args, launches=None, lock=None):
  """Run `target` (a module or a script path) with `args` in a process of its
  own under COUNTED in `cwd`; add its launch counts to `launches` (under
  `lock`). Returns (its counts, its seconds, its stdout); raises if it
  fails."""
  counts_path = os.path.join(cwd, f"{name}_counts.json")
  t = time.time()
  proc = subprocess.run([*COUNTED, counts_path, target, *args], cwd=cwd, env=env,
                        capture_output=True, text=True, timeout=600)
  secs = time.time() - t
  if proc.returncode:
    print(proc.stdout[-4000:], proc.stderr[-8000:], file=sys.stderr, flush=True)
    raise RuntimeError(f"{target} {' '.join(args)} exited with {proc.returncode}")
  with open(counts_path) as f:
    counts = json.load(f)
  if launches is not None:
    with lock:
      for k, v in counts.items():
        launches[k] += v
  shown = os.path.basename(target) if target.endswith(".py") else f"python -m {target}"
  log(phase, f"{name}: {shown} in {secs:.1f} s, launches {counts}")
  return counts, secs, proc.stdout


def experiments_phase(smi, tmp):
  """Phase 17: the experiment workflow through its CLIs, each in a process of
  its own that starts with every launch count at 0 and reports them at its
  end, everything under the directory `tmp` (SHALLOW_NTC_PROJECT_DIR):
  dead-leaves PNGs generated, the flagship config script trained (hid 3,
  the chain kernel on), SGA warm-started from that experiment by wid, eval
  --workdir with --profile, then bls2017_rd.py trained and evaluated.
  Returns the phase's numbers, its launches by kernel and (under "paths")
  the workdirs and the eval's JSON, which phase 22 reads."""
  import torch
  from shallow_ntc_tpu_torch import data as data_lib
  from shallow_ntc_tpu_torch import eval_lib, train_lib
  from shallow_ntc_tpu_torch.utils import config as config_lib
  from shallow_ntc_tpu_torch.utils import runname as runname_lib

  phase = "experiments"
  t_phase = time.time()
  root = os.path.dirname(os.path.abspath(__file__))
  configs_dir = os.path.join(root, "shallow_ntc_tpu_torch", "{}", "configs", "{}.py")
  summary = {"nvidia_smi": smi}
  launches = {"final_deconv_phase": 0, "fused_rb_chain": 0, "fused_resblock": 0,
              "jpegl_synthesize": 0}
  with contextlib.ExitStack() as stack:
    env = dict(os.environ, PYTHONPATH=root, SHALLOW_NTC_PROJECT_DIR=tmp,
               SLURM_ARRAY_JOB_ID="smoke", SLURM_ARRAY_TASK_ID=str(EXP_HID))
    env.pop("SNTC_FUSED_RB_CHAIN", None)
    env.pop("SNTC_FUSED_RESBLOCK", None)
    lock = threading.Lock()

    def run_cli(name, module, args, **extra_env):
      return run_counted(phase, tmp, dict(env, **extra_env), name, module, args, launches, lock)

    # 1. The data: python -m shallow_ntc_tpu_torch.deadleaves.
    dl = os.path.join(tmp, "data", "deadleaves")
    t = time.time()
    proc = subprocess.run([sys.executable, "-m", "shallow_ntc_tpu_torch.deadleaves", "--out", dl,
                           "--num_train", "16", "--num_valid", "2", "--num_eval", "2",
                           "--workers", str(min(8, os.cpu_count() or 1))],
                          cwd=tmp, env=env, capture_output=True, text=True, timeout=600)
    check(proc.returncode == 0, f"deadleaves failed: {proc.stderr[-2000:]}")
    n_files = {sub: len(os.listdir(os.path.join(dl, sub))) for sub in ("train", "valid", "eval")}
    summary["deadleaves_s"] = time.time() - t
    log(phase, f"deadleaves: {n_files} PNGs in {summary['deadleaves_s']:.1f} s")
    check(n_files == {"train": 16, "valid": 2, "eval": 2}, f"deadleaves wrote {n_files}")

    # 2. PNG read time at 512x768 and a write -> read round trip.
    eval_glob = os.path.join(dl, "eval", "*.png")
    first = sorted(glob_lib.glob(eval_glob))[0]
    read_s = []
    for _ in range(3):
      t = time.perf_counter()
      img = data_lib.read_png(first)
      read_s.append(time.perf_counter() - t)
    noise = np.random.default_rng(17).integers(0, 256, img.shape, dtype=np.uint8)
    data_lib.write_png(os.path.join(tmp, "roundtrip.png"), noise)
    same = np.array_equal(data_lib.read_png(os.path.join(tmp, "roundtrip.png")), noise)
    summary["png_read_ms"] = 1e3 * float(np.median(read_s))
    log(phase, f"read_png of a {img.shape[0]}x{img.shape[1]} PNG: "
        f"{' / '.join(f'{1e3 * x:.1f}' for x in read_s)} ms (host); write -> read of noise "
        f"{'equal' if same else 'DIFFERS'}")
    check(same and img.shape == EVAL_HW + (3,), f"PNG round trip equal: {same}; {img.shape}")

    # 3. Train the flagship's config script, work unit 3, the chain kernel on.
    te = "--config.train_eval_config."
    xms = os.path.join(tmp, "train_xms")
    counts, train_s, _ = run_cli(
        "train", "shallow_ntc_tpu_torch.mshyper.train",
        ["--config", configs_dir.format("mshyper", "two_layer_syn_rd"), "--hid", str(EXP_HID),
         f"{te}num_steps={EXP_TRAIN_STEPS}", f"{te}eval_every_steps={EXP_TRAIN_STEPS}",
         f"{te}checkpoint_every_steps={EXP_TRAIN_STEPS}", f"{te}max_validation_steps=2",
         f"{te}log_metrics_every_steps=1", "--matmul_precision", "highest",
         "--experiments_dir", xms], SNTC_FUSED_RB_CHAIN="1")
    workdir = os.path.join(xms, "smoke", f"wid={EXP_HID}-mshyper-lmbda=0.01-num_steps="
                           f"{EXP_TRAIN_STEPS}")
    check(os.path.isdir(workdir), f"no workdir {workdir}: {os.listdir(os.path.join(xms, 'smoke'))}")
    with open(os.path.join(workdir, "train", "record.jsonl")) as f:
      rows = [json.loads(line) for line in f]
    with open(os.path.join(workdir, "val", "record.jsonl")) as f:
      val_rows = [json.loads(line) for line in f]
    step_ms = [1e3 / r["steps_per_sec"] for r in rows]
    summary["train"] = dict(workdir=os.path.relpath(workdir, tmp), seconds=train_s,
                            step_ms=step_ms, rd_loss=[r["rd_loss"] for r in rows],
                            val=val_rows, launches=counts)
    log(phase, f"train workdir {os.path.relpath(workdir, tmp)}: steps "
        f"{[r['step'] for r in rows]}, ms a step (record.jsonl) "
        f"{' / '.join(f'{x:.1f}' for x in step_ms)}, rd_loss "
        f"{' / '.join(f'{r['rd_loss']:.3f}' for r in rows)}; val {val_rows}  [{smi}]")
    # 7 chains and one final deconv a forward: 4 steps and 2 val images.
    forwards = EXP_TRAIN_STEPS + 2
    check([r["step"] for r in rows] == list(range(1, EXP_TRAIN_STEPS + 1))
          and all(np.isfinite(v) for r in rows + val_rows for v in r.values())
          and [r["step"] for r in val_rows] == [EXP_TRAIN_STEPS]
          and train_lib.latest_checkpoint_step(workdir) == EXP_TRAIN_STEPS
          and counts["fused_rb_chain"] == CHAINS_PER_FORWARD * forwards
          and counts["final_deconv_phase"] == forwards, f"the train CLI's run: {summary['train']}")
    with open(os.path.join(workdir, "config.json")) as f:
      saved = json.load(f)
    want = config_lib.resolve_config(configs_dir.format("mshyper", "two_layer_syn_rd"), [
        ("train_eval_config.num_steps", str(EXP_TRAIN_STEPS))], EXP_HID)
    check(saved["model_config"] == json.loads(json.dumps(want["model_config"]))
          and os.path.isfile(os.path.join(workdir, "run_info.json")),
          "the workdir's config.json is not the script's")

    # A decoy work unit wid=0 in the same experiment, every float param of
    # its checkpoint shifted by 1: a warm start by the wrong wid finds it.
    decoy = os.path.join(xms, "smoke", "wid=0-decoy")
    os.makedirs(train_lib.checkpoint_dir(decoy))
    shutil.copy(os.path.join(workdir, "config.json"), decoy)
    ckpt = train_lib.load_newest_checkpoint(train_lib.checkpoint_dir(workdir))
    decoy_model = {k: v + 1 if v.is_floating_point() else v for k, v in ckpt["model"].items()}
    torch.save(dict(ckpt, model=decoy_model),
               os.path.join(train_lib.checkpoint_dir(decoy), f"ckpt_{ckpt['step']}.pt"))

    # 6. The factorized family (bls2017_rd.py, work unit 0, 2 steps, then
    # eval), in a thread of its own beside steps 4 and 5: each CLI is a
    # process of its own, so its launch counts are its own.
    def factorized_runs():
      fxms = os.path.join(tmp, "factorized_xms")
      counts, f_train_s, _ = run_cli(
          "factorized-train", "shallow_ntc_tpu_torch.factorized.train",
          ["--config", configs_dir.format("factorized", "bls2017_rd"), "--hid", "0",
           f"{te}num_steps=2", f"{te}eval_every_steps=2", f"{te}checkpoint_every_steps=2",
           f"{te}max_validation_steps=1", f"{te}log_metrics_every_steps=1",
           "--matmul_precision", "highest", "--experiments_dir", fxms], SLURM_ARRAY_TASK_ID="0")
      fworkdir = os.path.join(fxms, "smoke", "wid=0-factorized-lmbda=0.00125-num_steps=2")
      f_counts, f_eval_s, out = run_cli(
          "factorized-eval", "shallow_ntc_tpu_torch.eval",
          ["--workdir", fworkdir, "--dataset", "deadleaves_eval", "--results_dir",
           os.path.join(tmp, "factorized_results")])
      return counts, f_train_s, fworkdir, f_counts, f_eval_s, out

    # Left before the directory is removed, after the thread has ended.
    factorized = stack.enter_context(concurrent.futures.ThreadPoolExecutor(1)).submit(
        factorized_runs)

    # 4. SGA warm-started from the experiment by wid.
    itinf_cfg = configs_dir.format("mshyper", "itinf")
    ixms = os.path.join(tmp, "itinf_xms")
    counts, sga_s, _ = run_cli(
        "itinf", "shallow_ntc_tpu_torch.mshyper.itinf",
        ["--config", itinf_cfg, "--hid", str(EXP_HID),
         f"{te}warm_start_exp_dir={os.path.join(xms, 'smoke')}",
         "--config.data_config.dataset=deadleaves_eval", f"{te}num_steps={EXP_SGA_STEPS}",
         f"{te}eval_every_steps={EXP_SGA_STEPS}", f"{te}log_metrics_every_steps=50",
         "--experiments_dir", ixms])
    iworkdir = os.path.join(ixms, "smoke", f"wid={EXP_HID}-mshyper-wwid={EXP_HID}-uq=sga")
    with open(os.path.join(iworkdir, "metrics.json")) as f:
      sga = json.load(f)
    # The digest of the params that the CLI's SGA started from, against the
    # work unit's checkpoint and the decoy's.
    with open(os.path.join(iworkdir, "warm_start.json")) as f:
      warm = json.load(f)
    warm_equal = (warm["params_sha256"] == train_lib.params_digest(ckpt["model"])
                  and warm["step"] == EXP_TRAIN_STEPS)
    not_decoy = warm["params_sha256"] != train_lib.params_digest(decoy_model)
    summary["itinf"] = dict(workdir=os.path.relpath(iworkdir, tmp), seconds=sga_s,
                            metrics=sga, launches=counts, warm_start=warm,
                            params_equal_checkpoint=warm_equal, params_not_decoy=not_decoy)
    log(phase, f"itinf workdir {os.path.relpath(iworkdir, tmp)}: {EXP_SGA_STEPS} SGA steps of "
        f"2 images in {sga_s:.1f} s; val rd_loss {[round(m['rd_loss'], 4) for m in sga]}; "
        f"the CLI's warm-start params (digest) equal wid={EXP_HID}'s checkpoint: {warm_equal}, "
        f"differ from the decoy wid=0's: {not_decoy}  [{smi}]")
    check(warm_equal and not_decoy and len(sga) == 2 and all(np.isfinite(m["rd_loss"]) for m in sga)
          and counts["final_deconv_phase"] == 2 * (EXP_SGA_STEPS + 1)
          and all(os.path.isfile(os.path.join(iworkdir, f"batch_id={i}", "itinf_vars.npz"))
                  for i in range(2)), f"the itinf CLI's run: {summary['itinf']}")

    # 5. eval --workdir --profile against an in-process eval of the checkpoint.
    results = os.path.join(tmp, "json_results")
    counts, eval_s, out = run_cli(
        "eval", "shallow_ntc_tpu_torch.eval",
        ["--workdir", workdir, "--dataset", "deadleaves_eval", "--profile",
         "--results_dir", results])
    path = out.strip().splitlines()[-1]
    name = f"mshyper-lmbda=0.01-num_steps={EXP_TRAIN_STEPS}-step={EXP_TRAIN_STEPS}-xid=smoke.json"
    check(os.path.basename(path) == name and os.path.islink(os.path.join(results, name)),
          f"eval wrote {path}")
    with open(os.path.join(results, name)) as f:
      records = json.load(f)
    counts_f, f_train_s, fworkdir, f_counts, f_eval_s, f_out = factorized.result()
    model, _ = eval_lib.load_latest_ckpt(workdir, device="cuda")
    images = list(data_lib.get_dataset(eval_glob, "test", 1, None))
    ref = list(eval_lib.evaluate_images(model, images, step=EXP_TRAIN_STEPS))
    torch.cuda.synchronize()
    t = time.perf_counter()
    again = list(eval_lib.evaluate_images(model, images, step=EXP_TRAIN_STEPS))
    torch.cuda.synchronize()
    eval_ms = 1e3 * (time.perf_counter() - t) / len(images)
    repeat_exact = again == ref  # is the in-process eval itself bit-reproducible?
    del model
    times = ("analysis_time", "hyper_synthesis_time", "synthesis_time")
    hparams = dict(runname_lib.parse_runname(os.path.basename(workdir)))
    worst = max(abs(rec[k] - r[k]) / max(abs(r[k]), 1e-12)
                for rec, r in zip(records, ref) for k in r)
    exact = all(rec[k] == r[k] for rec, r in zip(records, ref) for k in r)
    summary["eval"] = dict(results=os.path.relpath(path, tmp), seconds=eval_s, launches=counts,
                           ms_an_image=eval_ms, exact=exact, max_rel=worst,
                           in_process_repeat_exact=repeat_exact,
                           profile={k: [rec[k] for rec in records] for k in times})
    log(phase, f"eval --workdir --profile: {os.path.relpath(path, tmp)}; records against the "
        f"in-process eval: {'equal' if exact else f'max rel {worst:.2e}'} (the in-process "
        f"eval run twice: {'equal' if repeat_exact else 'differs'}); in-process "
        f"{eval_ms:.2f} ms an image; profile (s) "
        + ", ".join(f"{k} {' / '.join(f'{rec[k]:.6f}' for rec in records)}" for k in times)
        + f"  [{smi}]")
    check(len(records) == len(ref) == 2 and worst <= 1e-5
          and all(rec[k] > 0 for rec in records for k in times)
          and all(rec["instance_id"] == i and all(rec[k] == v for k, v in hparams.items())
                  for i, rec in enumerate(records))
          and counts["final_deconv_phase"] >= 2, f"the eval CLI's run: {summary['eval']}")

    with open(f_out.strip().splitlines()[-1]) as f:
      f_records = json.load(f)
    summary["factorized"] = dict(workdir=os.path.relpath(fworkdir, tmp), train_s=f_train_s,
                                 eval_s=f_eval_s, bpp=[r["bpp"] for r in f_records],
                                 psnr=[r["psnr"] for r in f_records])
    log(phase, f"factorized workdir {os.path.relpath(fworkdir, tmp)}: trained in "
        f"{f_train_s:.1f} s, evaluated in {f_eval_s:.1f} s: bpp "
        f"{[round(r['bpp'], 4) for r in f_records]}, psnr "
        f"{[round(r['psnr'], 3) for r in f_records]}")
    check(len(f_records) == 2 and all(np.isfinite(r["bpp"]) and np.isfinite(r["psnr"])
                                      for r in f_records)
          and not any(counts_f.values()) and not any(f_counts.values()),
          f"the factorized runs: {summary['factorized']}, launches {counts_f} {f_counts}")
  summary["launches"] = launches
  summary["seconds"] = time.time() - t_phase
  log(phase, f"launches in this phase {launches}; {summary['seconds']:.1f} s")
  summary["paths"] = dict(tmp=tmp, workdir=workdir, itinf_workdir=iworkdir, eval_json=path)
  return summary


RD_PATH = ("rd-pipeline: the R-D result tools' CLIs on the card, each in its own process, on "
           "phase 17's full-width two_layer_syn_rd.py --hid 3 workdir (4 steps) and its SGA "
           "workdir, SNTC_FUSED_RB_CHAIN=1: codec overhead and int8 quality of 2 512x768 "
           "images, the basis grid, the saved-latent eval of 2 images")
RD_IMAGES = 2
# Launches a GPU process of phase 22 makes: (final_deconv_phase, fused_rb_chain).
# Codec overhead: 2 compresses (the analysis's 7 chains, the encoder's
# reconstruction) and 2 decompresses, then 2 likelihood evals; int8 quality:
# 3 arms of 2 evals; the basis grid: one synthesize; the saved-latent eval:
# one synthesis for each of the 2 batches (no analysis).
RD_LAUNCHES = {"codec-gpu": (3 * RD_IMAGES, 2 * RD_IMAGES * CHAINS_PER_FORWARD),
               "int8-gpu": (3 * RD_IMAGES, 3 * RD_IMAGES * CHAINS_PER_FORWARD),
               "basis-gpu": (1, 0), "recompute-gpu": (RD_IMAGES, 0)}


def rd_pipeline_phase(experiments, small, smi):
  """Phase 22: the R-D result tools (shallow_ntc_tpu_torch/results.py) through
  their CLIs, each in a process of its own, on phase 17's workdirs: SGA
  records (scripts/torch_itinf_to_results.py) and scripts/aggregate_results.py
  over them and phase 17's eval JSON; then on the card with the chain
  kernel and, as the reference, with --device cpu: codec overhead and int8
  quality of the 2 eval images, the basis functions, the saved-latent eval
  of a copy of the SGA workdir each. Held: every round trip lossless on
  both; PSNR and y's rate within phase 5's rtol 1e-3 (the real bytes and
  the whole rate, z's part included, reported as phase 5 reports them);
  the saved-latent eval's bpp too (the same latents); int8_syn's rate the
  float path's; the basis within 1e-3; the launches of each GPU process. Then 3 SGA steps of jpegl_rd (k18s16) at full width on the card
  against the CPU on phase 5's 192x256 crop, as phase 12's."""
  import torch
  from shallow_ntc_tpu_torch import configs, eval_lib

  phase = "rd-pipeline"
  t_phase = time.time()
  root = os.path.dirname(os.path.abspath(__file__))
  scripts = os.path.join(root, "scripts")
  paths = experiments["paths"]
  tmp = paths["tmp"]
  out = os.path.join(tmp, "rd")
  os.makedirs(os.path.join(out, "json"))
  env = dict(os.environ, PYTHONPATH=root, SHALLOW_NTC_PROJECT_DIR=tmp, SNTC_FUSED_RB_CHAIN="1")
  for key in ("SNTC_FUSED_RESBLOCK", "SNTC_INT8_DECODE", "SNTC_INT8_ENCODE"):
    env.pop(key, None)
  cpu_env = dict(env, OMP_NUM_THREADS="4")  # two CPU processes at a time share the cores
  launches = {"final_deconv_phase": 0, "fused_rb_chain": 0, "fused_resblock": 0,
              "jpegl_synthesize": 0}
  lock = threading.Lock()
  summary = {"nvidia_smi": smi}
  sga_copy = {}
  for side in ("gpu", "cpu"):
    sga_copy[side] = os.path.join(out, f"recompute_{side}", "smoke",
                                  os.path.basename(paths["itinf_workdir"]))
    shutil.copytree(paths["itinf_workdir"], sga_copy[side])

  def tool_args(tool, side):
    f = os.path.join(out, f"{tool}_{side}")
    dev = ["--device", "cuda" if side == "gpu" else "cpu"]
    return {"codec": ["--workdir", paths["workdir"], "--dataset", "deadleaves_eval",
                      "--max_images", str(RD_IMAGES), "--out", f + ".json"],
            "int8": ["--workdir", paths["workdir"], "--dataset", "deadleaves_eval",
                     "--max_images", str(RD_IMAGES), "--out", f + ".json"],
            "basis": ["--workdir", paths["workdir"], "--out", f + ".png", "--save_basis",
                      f + ".npy"],
            "recompute": ["--itinf_glob", os.path.join(os.path.dirname(sga_copy[side]), "*")],
            }[tool] + dev

  scripts_of = {"codec": "torch_measure_codec_overhead.py", "int8": "torch_int8_quality.py",
                "basis": "torch_vis_syn_filters.py",
                "recompute": "torch_recompute_itinf_metrics.py"}
  counts = {}

  def runs(side, tools):
    for tool in tools:
      name = f"{tool}-{side}"
      counts[name] = run_counted(
          phase, out, env if side == "gpu" else cpu_env, name,
          os.path.join(scripts, scripts_of[tool]), tool_args(tool, side),
          launches if side == "gpu" else None, lock)[0]

  def results_runs():
    run_counted(phase, out, cpu_env, "itinf-to-results",
                os.path.join(scripts, "torch_itinf_to_results.py"),
                ["--itinf_glob", os.path.join(os.path.dirname(paths["itinf_workdir"]), "*"),
                 "--out", os.path.join(out, "json")])
    shutil.copy(paths["eval_json"], os.path.join(out, "json"))
    run_counted(phase, out, cpu_env, "aggregate", os.path.join(scripts, "aggregate_results.py"),
                ["--results_glob", os.path.join(out, "json", "*.json"), "--out", out])
    runs("cpu", ("basis", "recompute"))

  with concurrent.futures.ThreadPoolExecutor(3) as pool:
    jobs = [pool.submit(runs, "gpu", ("codec", "int8", "basis", "recompute")),
            pool.submit(runs, "cpu", ("codec", "int8")), pool.submit(results_runs)]
    for job in jobs:
      job.result()

  def load(name):
    with open(os.path.join(out, name)) as f:
      return json.load(f)

  def rel(a, b):
    return abs(a - b) / max(abs(b), 1e-12)

  failures = []
  # The aggregate: the eval's method and the SGA's, 2 images each.
  agg = load("aggregate.json")
  summary["aggregate"] = {m: {k: agg[m][k] for k in ("rd_lambda", "num_images", "bpp", "psnr",
                                                       "rd_loss")} for m in agg}
  log(phase, f"aggregate.json: {summary['aggregate']}")
  if sorted(agg) != ["mshyper", "mshyper+sga"] or any(
      agg[m]["num_images"] != [RD_IMAGES] or agg[m]["rd_lambda"] != [0.01] for m in agg):
    failures.append("aggregate")

  # Codec overhead: lossless on both; y's likelihood and PSNR within rtol
  # 1e-3, as phase 5 holds them. The real bytes and the whole likelihood
  # are reported: z's tables and the elements where its prior's
  # probability floors (phase 5) may differ in a last bit across devices,
  # so a bitstream is the device's own (phase 6).
  codec = {side: load(f"codec_{side}.json") for side in ("gpu", "cpu")}
  for g, c in zip(codec["gpu"]["per_image"], codec["cpu"]["per_image"]):
    diffs = {k: rel(g[k], c[k]) for k in ("likelihood_latent_bpp", "psnr")}
    log(phase, f"codec overhead image {g['instance_id']}: gpu {g['real_bytes']} bytes "
        f"(real {g['real_bpp']:.5f} bpp, likelihood {g['likelihood_bpp']:.5f}, "
        f"{g['overhead_pct']:+.3f}%: header {g['header_bpp']:.5f}, flush {g['flush_bpp']:.5f}, "
        f"coding {g['coding_bpp']:.5f}), cpu {c['real_bytes']} bytes (reported: rel "
        f"{rel(g['real_bytes'], c['real_bytes']):.2e}; likelihood rel "
        f"{rel(g['likelihood_bpp'], c['likelihood_bpp']):.2e}); held rel "
        + ", ".join(f"{k} {v:.2e}" for k, v in diffs.items()) + " (tol 1e-3)")
    if not (g["roundtrip_lossless"] and c["roundtrip_lossless"]) or max(diffs.values()) > 1e-3:
      failures.append(f"codec image {g['instance_id']}")
  summary["codec_overhead"] = {side: {k: v for k, v in codec[side].items() if k != "per_image"}
                               for side in codec}

  # int8 quality: each arm's PSNR within rtol 1e-3 (its bpp, z's part
  # included, reported); int8_syn's rate the float path's on both.
  int8 = {side: load(f"int8_{side}.json") for side in ("gpu", "cpu")}
  pairs = list(zip(int8["gpu"]["per_image"], int8["cpu"]["per_image"]))
  worst = {end: max(rel(g[k], c[k]) for g, c in pairs for k in g if k.endswith(end))
           for end in ("_psnr", "_bpp")}
  syn_rate = all(r["syn_bpp"] == r["f32_bpp"] for side in int8 for r in int8[side]["per_image"])
  summary["int8_quality"] = {side: int8[side]["summary"] for side in int8}
  log(phase, f"int8 quality of {RD_IMAGES} images: gpu {int8['gpu']['summary']}; gpu vs cpu "
      f"PSNR max rel {worst['_psnr']:.2e} (tol 1e-3), bpp max rel {worst['_bpp']:.2e} "
      f"(reported); int8_syn's rate the float path's: {syn_rate}")
  if worst["_psnr"] > 1e-3 or not syn_rate:
    failures.append("int8 quality")

  # The basis functions within 1e-3.
  basis = {side: np.load(os.path.join(out, f"basis_{side}.npy")) for side in ("gpu", "cpu")}
  basis_err = float(np.abs(basis["gpu"] - basis["cpu"]).max())
  log(phase, f"basis functions {basis['gpu'].shape}: max|gpu-cpu| {basis_err:.3e} (tol 1e-3), "
      f"max|basis| {float(np.abs(basis['cpu']).max()):.3f}")
  if basis["gpu"].shape != basis["cpu"].shape or basis_err > 1e-3:
    failures.append("basis")

  # The saved-latent eval: bpp, latent bpp and PSNR within rtol 1e-3; the
  # SGA's own last val pass (bf16 transforms) beside it, reported.
  rec = {side: load(os.path.join(sga_copy[side], "metrics.json")) for side in sga_copy}
  with open(os.path.join(paths["itinf_workdir"], "metrics.json")) as f:
    sga_val = json.load(f)
  for g, c, v in zip(rec["gpu"], rec["cpu"], sga_val):
    diffs = {k: rel(g[k], c[k]) for k in ("bpp", "latent_bpp", "psnr")}
    log(phase, f"saved latents of batch {g['batch_id']}: gpu rd_loss {g['rd_loss']:.6f} bpp "
        f"{g['bpp']:.6f} psnr {g['psnr']:.4f}; rel to cpu "
        + ", ".join(f"{k} {x:.2e}" for k, x in diffs.items())
        + f" (tol 1e-3); the SGA's val pass (bf16 transforms) rd_loss {v['rd_loss']:.6f}")
    if max(diffs.values()) > 1e-3:
      failures.append(f"saved latents batch {g['batch_id']}")
  if [m["batch_id"] for m in rec["gpu"]] != list(range(RD_IMAGES)):
    failures.append("saved-latent batches")

  for name, (fd, chain) in RD_LAUNCHES.items():
    got = (counts[name]["final_deconv_phase"], counts[name]["fused_rb_chain"])
    if got != (fd, chain):
      failures.append(f"{name} launched (final_deconv_phase, fused_rb_chain) {got}, not "
                      f"{(fd, chain)}")
  summary["launches_by_process"] = {k: v for k, v in counts.items() if k.endswith("-gpu")}
  check(not failures, f"the R-D tools on the card: {failures}")

  # jpegl_rd's SGA: 3 steps on the card against the CPU.
  cfg = copy.deepcopy(configs.ITINF["model_config"])
  cfg["transform_config"] = copy.deepcopy(configs.JPEGL_RD["transform_config"])
  models = {d: eval_lib.build_model(cfg, init_seed=0, device=d) for d in ("cuda", "cpu")}
  xs = {d: small.to(d) for d in models}
  sga_gpu_against_cpu(phase, models, xs, cfg["optimizer_config"],
                      configs.ITINF["train_eval_config"]["num_steps"])
  del models
  torch.cuda.empty_cache()

  summary["launches"] = launches
  summary["seconds"] = time.time() - t_phase
  log(phase, f"launches in this phase {launches}; {summary['seconds']:.1f} s  [{smi}]")
  return summary


MEASURE_HW = (2048, 1536)  # scripts/spatial_codec_e2e.py's image
MEASURE_STRIPS = (1, 2, 4)
MEASURE_IMAGES = 8  # generated 512x768 dead-leaves PNGs for the codec's latency and batches
MEASURE_SECONDS = 270  # the phase's bound: 1.5x its slowest run, 177 s (its target: ~150 s)
MEASURE_SGA_STEPS = (16, 64)  # itinf_bench's marginal between these (its default 64, 256)


RD_SWEEP_SECONDS = 305  # phase 24's bound: 1.5x its first run with the flagship's point, 203.2 s
RD_SWEEP_ARGS = ["--config", "bls2017_rd", "--hids", "3", "--num_train", "16", "--num_eval",
                 "2", "--skip", "codec_overhead,int8_quality,train_curves,basis",
                 *(f"--train_override=train_eval_config.{k}=20" for k in (
                     "num_steps", "checkpoint_every_steps", "eval_every_steps")),
                 "--train_override=train_eval_config.max_validation_steps=1"]
# The flagship's R-D point as a full R-D run starts it (two_layer_syn_rd.py
# --hid 2, --keep_checkpoints, no basis stage), cut to 20 train steps with a
# checkpoint and a val pass every 10, 2 eval images and 10 SGA steps.
RD_FLAGSHIP_STEPS, RD_FLAGSHIP_EVERY, RD_FLAGSHIP_SGA_STEPS = 20, 10, 10
RD_FLAGSHIP_ARGS = [
    "--config", "two_layer_syn_rd", "--hids", "2", "--keep_checkpoints", "--skip", "basis",
    "--num_train", "16", "--num_eval", "2", "--codec_images", "2",
    f"--train_override=train_eval_config.num_steps={RD_FLAGSHIP_STEPS}",
    *(f"--train_override=train_eval_config.{k}={RD_FLAGSHIP_EVERY}" for k in (
        "checkpoint_every_steps", "eval_every_steps")),
    "--train_override=train_eval_config.max_validation_steps=1",
    f"--sga_override=train_eval_config.num_steps={RD_FLAGSHIP_SGA_STEPS}",
    f"--sga_override=train_eval_config.eval_every_steps={RD_FLAGSHIP_SGA_STEPS}"]
RD_FLAGSHIP_STAGES = ["train", "eval", "codec_overhead", f"int8_quality_step={RD_FLAGSHIP_EVERY}",
                      "int8_quality", "train_curves", "sga", "itinf_to_results", "recompute"]
RD_SWEEP_PATH = ("rd-sweep: scripts/torch_rd_run.py --config two_layer_syn_rd --hids 2 "
                 "--keep_checkpoints at full width, each stage's process counted from 0 (train "
                 "without the chain kernel; eval, codec overhead, the int8 passes with the "
                 "hyper-decoder's saves, SGA and its recompute with it; the train and SGA "
                 "steps each a CUDA graph replayed a step, the CLIs' default)")


def rd_sweep_phase(smi, tmp):
  """Phase 24: rehearsals of the R-D sweep (scripts/torch_rd_run.py) on the
  card, each in a process of its own as a user starts it, the two at once.
  bls2017_rd.py --hid 3 (rd_lambda 0.01, 192 filters) trained 20 steps on
  16 dead-leaves PNGs and evaluated on 2 at 512x768, the stages but train
  and eval skipped. Held: the point's run record and aggregate row; its
  eval JSON against the eval CLI's --device cpu pass on the same workdir
  (PSNR and MSE within phase 13's rtol 1e-3; bpp reported: the sign trick's
  floor, ROADMAP queue 3 entry 2); no kernel launched (the factorized family
  has none); a second invocation (beside the CPU's eval) skips the point,
  makes no data and trains nothing. Beside it the flagship's point as the
  full R-D runs start it (RD_FLAGSHIP_ARGS): every stage in order, the
  kept checkpoint's and the final int8 records with their hyper_ranges, the
  departed step that those records and DEPART_BPP give, the hyper-decoder
  .npz of the final and the departed checkpoint under --root, no other and
  none under --out, the train stage without the chain kernel and
  final_deconv_phase once a forward, the
  chain 7 times a forward in the eval and the int8 passes, the eval finite
  and its aggregate row. The phase within RD_SWEEP_SECONDS."""
  phase = "rd-sweep"
  t_phase = time.time()
  root = os.path.dirname(os.path.abspath(__file__))
  env = dict(os.environ, PYTHONPATH=root)
  for key in ("SNTC_FUSED_RB_CHAIN", "SNTC_FUSED_RESBLOCK", "SNTC_INT8_DECODE",
              "SNTC_INT8_ENCODE"):
    env.pop(key, None)
  script = os.path.join(root, "scripts", "torch_rd_run.py")
  argv = [sys.executable, script, *RD_SWEEP_ARGS, "--root", os.path.join(tmp, "root"), "--out",
          os.path.join(tmp, "out")]
  out = os.path.join(tmp, "out")
  record = os.path.join(out, "bls2017_rd_hid3", "run.json")
  flagship_root, flagship_out = os.path.join(tmp, "flagship_root"), os.path.join(tmp, "flagship")
  flagship_log = open(os.path.join(tmp, "flagship.log"), "w")
  t_flagship = time.time()
  flagship = subprocess.Popen(
      [sys.executable, script, *RD_FLAGSHIP_ARGS, "--root", flagship_root, "--out", flagship_out],
      cwd=tmp, env=env, stdout=flagship_log, stderr=subprocess.STDOUT, start_new_session=True)
  try:

    def drive():
      t = time.time()
      proc = subprocess.run(argv, cwd=tmp, env=env, capture_output=True, text=True, timeout=300)
      if proc.returncode:
        print(proc.stdout[-4000:], proc.stderr[-8000:], file=sys.stderr, flush=True)
        raise RuntimeError(f"torch_rd_run.py exited with {proc.returncode}")
      return time.time() - t, proc.stdout

    runs = [drive()]
    with open(record) as f:
      run = json.load(f)
    with open(os.path.join(out, "aggregate.json")) as f:
      agg = json.load(f)
    launches = {k: sum(step["launches"][k] for step in run["steps"].values())
                for k in run["steps"]["train"]["launches"]}
    train_ms = run["train_step_ms"][-1] if run["train_step_ms"] else float("nan")
    log(phase, f"torch_rd_run.py in {runs[0][0]:.1f} s: {sorted(run['steps'])} to the checkpoint "
        f"of step {run['checkpoint_step']} ({run['train_end']}), {train_ms:.2f} ms a step at the "
        f"last log; stages left out {sorted(run['skipped'])}; the factorized family launches no "
        f"kernel: {launches}")
    check(run["checkpoint_step"] == 20 and set(run["steps"]) == {"train", "eval"}
          and not any(launches.values()), f"the sweep's point: {run}")
    check(sorted(agg) == ["factorized"] and agg["factorized"]["rd_lambda"] == [0.01]
          and agg["factorized"]["num_images"] == [2], f"the aggregate: {agg}")
    (gpu_json,) = glob_lib.glob(os.path.join(out, "json", "factorized-*.json"))
    cpu_dir = os.path.join(tmp, "cpu_json")
    # The CPU's eval of the workdir beside a second invocation of the sweep.
    stamp = os.stat(record).st_mtime_ns
    with concurrent.futures.ThreadPoolExecutor(2) as pool:
      rerun = pool.submit(drive)
      cpu_eval = pool.submit(
          run_counted, phase, tmp, dict(env, SHALLOW_NTC_PROJECT_DIR=os.path.join(tmp, "root")),
          "eval-cpu", "shallow_ntc_tpu_torch.eval",
          ["--workdir", os.path.join(tmp, "root", run["workdir"]), "--dataset",
           "deadleaves_eval", "--results_dir", cpu_dir, "--device", "cpu"])
      runs.append(rerun.result())
      cpu_eval.result()
    with open(gpu_json) as f:
      gpu = json.load(f)
    with open(os.path.join(cpu_dir, os.path.basename(gpu_json))) as f:
      cpu = json.load(f)
    worst = {}
    for g, c in zip(gpu, cpu):
      rel = {k: abs(g[k] - c[k]) / abs(c[k]) for k in ("psnr", "mse", "bpp")}
      worst = {k: max(worst.get(k, 0.0), v) for k, v in rel.items()}
      log(phase, f"eval image {g['instance_id']}: gpu psnr {g['psnr']:.5f} bpp {g['bpp']:.5f}, "
          f"cpu psnr {c['psnr']:.5f} bpp {c['bpp']:.5f}; rel psnr {rel['psnr']:.2e}, mse "
          f"{rel['mse']:.2e} (tol 1e-3), bpp {rel['bpp']:.2e} (reported)")
    check(len(gpu) == len(cpu) == 2 and max(worst["psnr"], worst["mse"]) <= 1e-3,
          f"the sweep's factorized eval, card against CPU: {worst}")
    skipped = ("bls2017_rd_hid3: skipped" in runs[1][1] and "data: not needed" in runs[1][1]
               and os.stat(record).st_mtime_ns == stamp)
    log(phase, f"a second invocation in {runs[1][0]:.1f} s skips the finished point (no data, no "
        f"training, its record untouched): {skipped}")
    check(skipped, f"the second invocation did not skip the point: {runs[1][1][-2000:]}")
  except BaseException:
    stop_group(flagship)
    flagship_log.close()
    raise
  flagship_summary = rd_flagship_check(phase, flagship, flagship_log, t_flagship, flagship_root,
                                       flagship_out)
  summary = dict(seconds=time.time() - t_phase, sweep_s=runs[0][0], rerun_s=runs[1][0],
                 train_step_ms=train_ms, launches=launches, gpu_vs_cpu=worst,
                 flagship=flagship_summary)
  log(phase, f"{summary['seconds']:.1f} s (bound {RD_SWEEP_SECONDS} s)  [{smi}]")
  check(summary["seconds"] <= RD_SWEEP_SECONDS, f"phase 24 took {summary['seconds']:.1f} s")
  return summary


def stop_group(proc):
  """Kill the process group that `proc` leads (a session of its own) and
  reap `proc`: the CLIs it started go with it."""
  try:
    os.killpg(proc.pid, signal.SIGKILL)
  except ProcessLookupError:
    pass
  proc.wait()


def sweep_script():
  """scripts/torch_rd_run.py as a module (it imports the port only inside
  its functions)."""
  import importlib.util

  spec = importlib.util.spec_from_file_location(
      "torch_rd_run", os.path.join(os.path.dirname(os.path.abspath(__file__)), "scripts",
                                   "torch_rd_run.py"))
  mod = importlib.util.module_from_spec(spec)
  spec.loader.exec_module(mod)
  return mod


def rd_flagship_check(phase, proc, log_file, t0, root, out):
  """Wait for phase 24's flagship point (RD_FLAGSHIP_ARGS) and hold its
  records; returns its seconds, stages' seconds and launches."""
  from shallow_ntc_tpu_torch.ops import rb_chain as rb
  from shallow_ntc_tpu_torch.ops import twolayer_final as tl

  try:
    proc.wait(timeout=600)
  finally:
    stop_group(proc)
    log_file.close()
  secs = time.time() - t0
  if proc.returncode:
    with open(log_file.name) as f:
      print(f.read()[-8000:], file=sys.stderr, flush=True)
    raise RuntimeError(f"torch_rd_run.py (the flagship) exited with {proc.returncode}")
  dest = os.path.join(out, "two_layer_syn_rd_hid2")
  with open(os.path.join(dest, "run.json")) as f:
    run = json.load(f)
  steps = run["steps"]
  stage_s = {k: round(v["seconds"], 1) for k, v in steps.items()}
  log(phase, f"flagship --hids 2 --keep_checkpoints in {secs:.1f} s: the checkpoint of step "
      f"{run['checkpoint_step']} ({run['train_end']}); stages {stage_s}; departed "
      f"{run.get('departed_step')}, saves {run.get('hyper_saves')}")
  for name, step in steps.items():
    log(phase, f"flagship {name}: launches {step['launches']}")
  check(run["checkpoint_step"] == RD_FLAGSHIP_STEPS and list(steps) == RD_FLAGSHIP_STAGES
        and run["skipped"] == {"basis": "--skip"}, f"the flagship point: {run}")
  deltas = {}
  for n, name in ((RD_FLAGSHIP_EVERY, f"int8_quality_step={RD_FLAGSHIP_EVERY}.json"),
                  (RD_FLAGSHIP_STEPS, "int8_quality.json")):
    with open(os.path.join(dest, name)) as f:
      record = json.load(f)
    deltas[n] = record["summary"]["bpp"]["all_delta"]
    ranges = record.get("hyper_ranges")
    check(ranges is not None and len(ranges["convs"]) == 3, f"{name} has no hyper_ranges")
  departed = next((n for n in sorted(deltas) if deltas[n] > sweep_script().DEPART_BPP), None)
  saved = {str(n) for n in (departed, RD_FLAGSHIP_STEPS) if n is not None}
  hyper = os.path.join(root, "hyper", "two_layer_syn_rd_hid2")
  log(phase, f"flagship int8_all - float bpp by step {deltas}: departed {departed}; .npz under "
      f"--root {sorted(os.listdir(hyper))}")
  check(run["departed_step"] == departed and set(run["hyper_saves"]) == saved
        and sorted(os.listdir(hyper)) == sorted(f"step={n}.npz" for n in saved)
        and all(os.path.getsize(os.path.join(root, p)) > 0 for p in run["hyper_saves"].values())
        and not glob_lib.glob(os.path.join(out, "**", "*.npz"), recursive=True),
        f"the hyper-decoder saves: {run['hyper_saves']}, departed {run['departed_step']}")
  with open(os.path.join(dest, "val_record.jsonl")) as f:
    val_rows = [json.loads(line) for line in f if line.strip()]
  # Forwards: each train step, each val pass's one image; 2 eval images; the
  # int8 pass's float eval for the z_hat and its 3 arms, of the 2 images.
  forwards = dict(train=RD_FLAGSHIP_STEPS + len(val_rows), eval=2,
                  **{k: 8 for k in RD_FLAGSHIP_STAGES if "int8" in k})
  chains = dict(forwards, train=0)
  got = {k: (steps[k]["launches"][tl.STATS.name], steps[k]["launches"][rb.STATS.name])
         for k in forwards}
  want = {k: (forwards[k], CHAINS_PER_FORWARD * chains[k]) for k in forwards}
  log(phase, f"flagship (final_deconv_phase, fused_rb_chain) launches {got}, expected {want}")
  check(got == want and steps["sga"]["launches"][tl.STATS.name] > 0
        and steps["sga"]["launches"][rb.STATS.name] > 0
        and steps["codec_overhead"]["launches"][rb.STATS.name] > 0,
        f"the flagship point's launches: {got} against {want}")
  with open(os.path.join(out, "aggregate.json")) as f:
    agg = json.load(f)
  (eval_json,) = glob_lib.glob(os.path.join(out, "json", "mshyper-*.json"))
  with open(eval_json) as f:
    rows = json.load(f)
  log(phase, "flagship eval: " + "; ".join(
      f"image {r['instance_id']}: rd_loss {r['rd_loss']:.5f} bpp {r['bpp']:.5f} psnr "
      f"{r['psnr']:.4f}" for r in rows))
  check(len(rows) == 2 and all(np.isfinite(r[k]) for r in rows for k in ("rd_loss", "bpp", "psnr"))
        and agg["mshyper"]["rd_lambda"] == agg["mshyper+sga"]["rd_lambda"] == [0.005],
        f"the flagship's eval {rows} or aggregate {agg}")
  launches = {k: sum(step["launches"][k] for step in steps.values())
              for k in steps["train"]["launches"]}
  return dict(seconds=secs, stage_seconds=stage_s, launches=launches,
              launches_by_stage={k: v["launches"] for k, v in steps.items()},
              train_step_ms=run["train_step_ms"])


def spatial_launches(strips):
  """(final_deconv_phase, fused_rb_chain) launches of one
  scripts/torch_spatial_codec_e2e.py run with the chain on: per setting of
  n strips 2 compresses (the analysis's 7 chains a strip, the
  reconstruction's final deconv a strip), 2 decompresses and 2 evals
  (warm-up and timed); per split setting the cross decodes (the unsplit
  codec's 1, the split codec's n)."""
  fd = sum(6 * n for n in strips) + sum(1 + n for n in strips[1:])
  return fd, sum(4 * CHAINS_PER_FORWARD * n for n in strips)


def measure_phase(smi):
  """Phase 23: the measurement layer (shallow_ntc_tpu_torch/measure.py)
  through its CLIs, each in a process of its own whose launch counts start
  at 0: the 2048x1536 codec and eval on the card unsplit and in 2 and 4
  strips with the chain (every self round trip bit for bit, the cross decodes
  within 1 uint8 at an equal bpp, the split evals at rtol 1e-4, the launches
  of every call, the peak memory); then in-process the card's z and y of
  that image with the chain against the port's CPU pass at phase 5's
  tolerance; codec latency and the per-image / batch codec on 8 generated
  512x768 images; SGA steps at B=1 and B=8; bench_suite --fast; the
  encoder's roofline; SGA and the codec's batches at fewer repeats than
  the CLIs' defaults (the phase's time). Returns the phase's numbers and
  its launches."""
  import torch
  from shallow_ntc_tpu_torch import configs, data as data_lib, deadleaves, eval_lib
  from shallow_ntc_tpu_torch.ops import rb_chain as rb

  phase = "measure"
  t_phase = time.time()
  root = os.path.dirname(os.path.abspath(__file__))
  scripts = os.path.join(root, "scripts")
  tmp = tempfile.mkdtemp(prefix="chip_smoke_measure_")
  env = dict(os.environ, PYTHONPATH=root)
  for key in ("SNTC_FUSED_RB_CHAIN", "SNTC_FUSED_RESBLOCK", "SNTC_INT8_DECODE",
              "SNTC_INT8_ENCODE"):
    env.pop(key, None)
  launches = {"final_deconv_phase": 0, "fused_rb_chain": 0, "fused_resblock": 0,
              "jpegl_synthesize": 0}
  lock = threading.Lock()
  summary = {"nvidia_smi": smi}
  counts, outs, secs = {}, {}, {}
  failures = []

  def run(name, script, args, **extra_env):
    out = os.path.join(tmp, f"{name}.json")
    counts[name], secs[name], _ = run_counted(
        phase, tmp, dict(env, **extra_env), name, os.path.join(scripts, script),
        args + ["--out", out], launches, lock)
    with open(out) as f:
      outs[name] = json.load(f)
    return outs[name]

  try:
    # 1. The 2048x1536 codec and eval, unsplit and in strips, the chain on.
    sc = run("spatial-codec", "torch_spatial_codec_e2e.py",
             ["--mode", "card", "--spatial_devices", str(MEASURE_STRIPS[-1])],
             SNTC_FUSED_RB_CHAIN="1")
    detail = sc["card_detail"]
    for n in MEASURE_STRIPS:
      st, ev = detail["settings"][str(n)], detail["eval"][str(n)]
      log(phase, f"{MEASURE_HW[0]}x{MEASURE_HW[1]} codec on {n} strip(s): bpp {st['bpp']:.6f} "
          f"({st['bytes']} bytes, streams {st['stream_counts']}), PSNR {st['psnr_vs_source']:.4f}"
          f" dB; compress {1e3 * st['encode_wall_s_warm']:.2f} ms, decompress "
          f"{1e3 * st['decode_wall_s_warm']:.2f} ms (warm, host clock; each of 2: "
          f"{[round(1e3 * v, 2) for v in st['encode_wall_s']]} / "
          f"{[round(1e3 * v, 2) for v in st['decode_wall_s']]}); self round trip bit-exact "
          f"{st['roundtrip_bit_exact']}; peak {st['peak_mem_GB']:.3f} GB; launches a call "
          f"{st['launches_per_call']}; eval bpp {ev['bpp']:.6f} PSNR {ev['psnr']:.4f} rd_loss "
          f"{ev['rd_loss']:.5f} in {1e3 * ev['wall_s']:.2f} ms, peak {ev['peak_mem_GB']:.3f} GB, "
          f"rel to unsplit {ev.get('rel_to_unsplit')}  [{smi}]")
      fd_chain = {"compress": (n, CHAINS_PER_FORWARD * n), "decompress": (n, 0)}
      for kind, want in fd_chain.items():
        got = st["launches_per_call"][kind]
        if (got["final_deconv_phase"], got["fused_rb_chain"]) != want:
          failures.append(f"{n} strips {kind} launched {got}, not {want}")
      if (ev["launches"]["final_deconv_phase"], ev["launches"]["fused_rb_chain"]) != (
          n, CHAINS_PER_FORWARD * n):
        failures.append(f"{n}-strip eval launched {ev['launches']}")
    for n, c in detail["cross"].items():
      log(phase, f"across settings, {n} strips vs unsplit: decodes max|d| {c['max_abs']} uint8 "
          f"(tol 1), frac {c['frac_diff']:.2e}; bpp rel {c['bpp_rel']:.2e} (tol 1e-4); "
          f"bitstreams byte-equal {c['bitstreams_equal']} (reported); symbols that differ: z "
          f"{c['z_symbols_differ']}, y {c['y_symbols_differ']} of {c['y_symbols']}")
    failures += detail["failures"]
    want = spatial_launches(MEASURE_STRIPS)
    got = (counts["spatial-codec"]["final_deconv_phase"], counts["spatial-codec"]["fused_rb_chain"])
    if got != want:
      failures.append(f"the spatial codec's process launched {got}, not {want}")
    summary["spatial_codec"] = sc

    # 2. The card's z and y of that image (the chain on) against the CPU pass,
    # while a thread writes the PNGs of part 3 (host work, nothing timed).
    imgs = os.path.join(tmp, "images")
    os.makedirs(imgs)

    def write_images():
      for i in range(MEASURE_IMAGES):
        data_lib.write_png(os.path.join(imgs, f"dle{i:03d}.png"),
                           deadleaves.deadleaves_image(900000 + i, *EVAL_HW))

    writer = concurrent.futures.ThreadPoolExecutor(1)
    written = writer.submit(write_images)
    x = (deadleaves.deadleaves_image(777000, *MEASURE_HW).astype(np.float32) / 255.0
         - 0.5)[None]
    model = eval_lib.build_model(configs.TWO_LAYER_SYN_RD, init_seed=0, device="cuda")
    model_cpu = eval_lib.build_model(configs.TWO_LAYER_SYN_RD, init_seed=0, device="cpu")
    chain0 = rb.STATS.launches
    with switch_on("SNTC_FUSED_RB_CHAIN"), torch.no_grad():
      rv_gpu = model.infer_latent_rvs(torch.from_numpy(x).cuda())
      torch.cuda.synchronize()
      t = time.time()
      rv_cpu = model_cpu.infer_latent_rvs(torch.from_numpy(x))
      cpu_s = time.time() - t
    chain_cpu_pass = rb.STATS.launches - chain0
    launches["fused_rb_chain"] += chain_cpu_pass
    errs = {}
    for name, a, b in zip(("z", "y"), rv_gpu.uq, rv_cpu.uq):
      err = (a.loc.cpu() - b.loc).abs().max().item()
      scale = b.loc.abs().max().item()
      errs[name] = dict(max_abs_err=err, max_abs_cpu=scale)
      log(phase, f"{MEASURE_HW[0]}x{MEASURE_HW[1]} {name} {tuple(b.loc.shape)}: card (chain) vs "
          f"CPU max|err| {err:.3e}, max|cpu| {scale:.3f} (tol 1e-4 * max(1, max|cpu|)); the "
          f"CPU pass took {cpu_s:.1f} s; chain launches on the card {chain_cpu_pass}")
      if err > 1e-4 * max(1.0, scale):
        failures.append(f"the card's {name} at {MEASURE_HW} disagrees with the CPU's")
    if chain_cpu_pass != CHAINS_PER_FORWARD:
      failures.append(f"the card's analysis launched {chain_cpu_pass} chains")
    summary["latents_vs_cpu"] = dict(errs, cpu_seconds=cpu_s, chain_launches=chain_cpu_pass)
    del model, model_cpu, rv_gpu, rv_cpu
    torch.cuda.empty_cache()

    # 3. Codec latency and batches on generated 512x768 images (the default route).
    written.result()
    writer.shutdown()
    lat = run("codec-latency", "torch_codec_latency.py",
              ["--image", os.path.join(imgs, "dle000.png")])
    log(phase, f"codec latency 512x768: {lat['bytes']} bytes, {lat['bpp']:.5f} bpp, streams "
        f"{lat['stream_counts']}; likelihood {lat['likelihood_bpp']:.5f} bpp, overhead "
        f"{lat['overhead_pct']:+.3f}%; decompress {lat['decompress_ms_min']:.2f} ms (median "
        f"{lat['decompress_ms_median']:.2f}); host y decode striped {lat['y_decode_striped_ms']:.2f}"
        f" ms ({lat['y_decode_striped_Msym_per_s']:.1f} Msym/s, {lat['y_streams']} streams), "
        f"single {lat['y_decode_single_ms']:.2f} ms ({lat['y_decode_single_Msym_per_s']:.1f} "
        f"Msym/s); reconstruction equal {lat['reconstruction_equal']}  [{smi}]")
    if not lat["reconstruction_equal"]:
      failures.append("codec latency: the decompress differs")
    e2e = run("codec-e2e", "torch_codec_e2e_bench.py",
              ["--images", os.path.join(imgs, "*.png"), "--num_images", str(MEASURE_IMAGES),
               "--repeats", "2"])
    log(phase, f"codec e2e of {e2e['images']} images: " + ", ".join(
        f"{k} {v:.3f}" if isinstance(v, float) else f"{k} {v}" for k, v in e2e.items()
        if k != "device") + f"  [{smi}]")

    # 4. SGA steps at B=1 and B=8 (TF32 off, as JAX's bench at its precision).
    for b in (1, 8):
      it = run(f"itinf-b{b}", "torch_itinf_bench.py",
               ["--batch", str(b), "--n_lo", str(MEASURE_SGA_STEPS[0]),
                "--n_hi", str(MEASURE_SGA_STEPS[1])])
      log(phase, f"SGA B={b} 512x768: {it['ms_per_step']:.3f} ms a step (marginal, "
          f"{it['n_lo']} -> {it['n_hi']} steps), {it['steps_per_s']:.2f} steps/s, "
          f"{it['image_steps_per_s']:.2f} image-steps/s  [{smi}]")
      summary[f"itinf_b{b}"] = it

    # 5. bench_suite --fast; 6. the encoder's roofline.
    bs = run("bench-suite", "torch_bench_suite.py", ["--fast"])
    log(phase, "bench_suite --fast: " + ", ".join(
        f"{k} {v:.2f}" if isinstance(v, float) else f"{k} {v}" for k, v in bs.items()))
    rf = run("encode-roofline", "torch_encode_roofline.py", ["--batch", "8"])
    for st in rf["stages"]:
      kern = (f"; kernel {st['kernel_ms']:.4f} ms, {st['kernel']['pct_peak_bw']:.2f}% bw, "
              f"{st['kernel']['pct_peak_flops']:.2f}% flops" if "kernel_ms" in st else "")
      log(phase, f"roofline {st['stage']} in {tuple(st['input_shape'])}: {st['ms']:.4f} ms, "
          f"{st['min_GB']:.4f} GB ({st['pct_peak_bw']:.2f}% of 3.35 TB/s), {st['GFLOP']:.2f} "
          f"GFLOP ({st['pct_peak_flops']:.2f}% of 989 TFLOP/s){kern}")
    log(phase, f"roofline: stage sum {rf['sum_stage_ms']:.3f} ms ({rf['Mpx_per_s_stage_sum']:.1f}"
        f" Mpx/s), with the chain kernel {rf['sum_stage_kernel_ms']:.3f} ms  [{smi}]")
    summary.update(codec_latency=lat, codec_e2e=e2e, bench_suite=bs, encode_roofline=rf)
    for name, key in (("codec-latency", "final_deconv_phase"), ("codec-e2e", "final_deconv_phase"),
                      ("itinf-b1", "final_deconv_phase"), ("itinf-b8", "final_deconv_phase"),
                      ("bench-suite", "final_deconv_phase"), ("bench-suite", "fused_rb_chain"),
                      ("encode-roofline", "fused_rb_chain")):
      if counts[name][key] <= 0:
        failures.append(f"{name} launched no {key}")
    if counts["encode-roofline"]["final_deconv_phase"] or any(
        counts[k]["fused_rb_chain"] for k in ("codec-latency", "codec-e2e")):
      failures.append(f"a process launched a kernel off its route: {counts}")
  finally:
    shutil.rmtree(tmp, ignore_errors=True)
  summary["launches_by_process"] = counts
  summary["process_seconds"] = secs
  summary["launches"] = launches
  summary["seconds"] = time.time() - t_phase
  log(phase, f"launches in this phase {launches}; {summary['seconds']:.1f} s (target ~150 s, "
      f"bound {MEASURE_SECONDS} s)  [{smi}]")
  check(not failures, f"the measurement layer on the card: {failures}")
  check(summary["seconds"] <= MEASURE_SECONDS, f"phase 23 took {summary['seconds']:.1f} s")
  return summary


PAR_STEPS, NCCL_STEPS = 3, 2  # the DDP comparison's steps; the NCCL run's
PAR_STATS_MODULES = ("twolayer_final", "rb_chain", "resblock", "jpegl_decode")


def _counted_train_rank(rank, *args):
  """utils/cli.py's _train_rank, which run_train_main spawns for
  --dp_devices N, under measure.deterministic(), with this rank's launch counts
  written beside the experiment at its end: phase 18 swaps it in for the
  spawn."""
  import importlib

  import torch
  from shallow_ntc_tpu_torch import measure
  from shallow_ntc_tpu_torch.utils import cli

  stats = [importlib.import_module(f"shallow_ntc_tpu_torch.ops.{m}").STATS
           for m in PAR_STATS_MODULES]
  for st in stats:
    st.launches = 0
  with measure.deterministic():
    out = cli._train_rank(rank, *args)
  torch.cuda.synchronize()
  with open(os.path.join(args[2].experiments_dir, f"launches_rank{rank}.json"), "w") as f:
    json.dump({st.name: st.launches for st in stats}, f)
  return out


def _unsynced_train_rank(rank, *args):
  """_counted_train_rank with the loss called past DDP (mesh.FrameLoss
  alone), so each rank steps on its own half-batch gradients: the control
  that phase 18's DDP comparison must tell apart from the reference."""
  from shallow_ntc_tpu_torch.parallel import mesh

  mesh.data_parallel = mesh.FrameLoss
  return _counted_train_rank(rank, *args)


def loop_adam_update(opt, grads):
  """train_lib.Adam.update written per parameter, the form it had before the
  multi-tensor update (some 22 host ops a tensor): the reference of the
  "adam" check of phase 8 and the other arm of phase 11's optimizer A/B. It
  lies on no path of the package."""
  import torch

  with torch.no_grad():
    grads = list(grads)
    if opt.global_clipnorm is not None:
      norm = torch.sqrt(sum(torch.sum(g * g) for g in grads))
      keep = norm < opt.global_clipnorm
      grads = [torch.where(keep, g, (g / norm) * opt.global_clipnorm) for g in grads]
    lr = float(opt.lr_fn(opt.count))
    opt.count += 1
    bc1 = float(np.float32(1) - np.power(np.float32(opt.b1), np.float32(opt.count)))
    bc2 = float(np.float32(1) - np.power(np.float32(opt.b2), np.float32(opt.count)))
    for p, g, mu, nu in zip(opt.params, grads, opt.mu, opt.nu):
      mu.copy_((1 - opt.b1) * g + opt.b1 * mu)
      nu.copy_((1 - opt.b2) * (g * g) + opt.b2 * nu)
      direction = (mu / bc1) / (torch.sqrt(nu / bc2) + opt.eps)
      p.add_(-lr * direction)


def adam_check(phase, model_config, opt_cfg):
  """Two Adam updates of the full-width flagship's parameters on the card,
  train_lib.Adam's multi-tensor update against loop_adam_update from the
  same state, on seeded gradients of global norm ~0.5 (kept: params, mu and
  nu bit for bit) and then ~5 (clipped to global_clipnorm 1: within 1e-7
  abs, the norm being summed in another order). Returns the max abs
  difference of each."""
  import torch
  from shallow_ntc_tpu_torch import train_lib

  model, _ = train_lib.build_model(model_config, init_seed=0, device="cuda")
  params = [p.detach() for p in model.parameters()]
  cfg = dict(opt_cfg, warmup_until=0.0)  # a learning rate above 0 from the first update
  multi, _ = train_lib.make_optimizer([p.clone() for p in params], cfg, 30_000)
  loop, _ = train_lib.make_optimizer([p.clone() for p in params], cfg, 30_000)
  scale = 1 / np.sqrt(sum(p.numel() for p in params))
  gen = torch.Generator(device="cuda").manual_seed(0)
  errs = {}
  for what, norm in (("kept", 0.5), ("clipped", 5.0)):
    grads = [torch.randn(p.shape, generator=gen, device="cuda") * (norm * scale)
             for p in params]
    multi.update(grads)
    loop_adam_update(loop, grads)
    torch.cuda.synchronize()
    pairs = list(zip(multi.params + multi.mu + multi.nu, loop.params + loop.mu + loop.nu))
    unequal = sum(int((a != b).sum()) for a, b in pairs)
    errs[what] = max((a - b).abs().max().item() for a, b in pairs)
    log(phase, f"Adam, {len(params)} tensors of the full-width flagship, global norm ~{norm} "
        f"({what}): multi-tensor against per-parameter, {unequal} of "
        f"{3 * sum(p.numel() for p in params)} params, mu and nu elements differ, max|diff| "
        f"{errs[what]:.3e} (tol {'0' if what == 'kept' else '1e-7'})")
    check(unequal == 0 if what == "kept" else errs[what] <= 1e-7,
          f"the multi-tensor Adam update departs from the per-parameter one ({what}): "
          f"{unequal} elements, max|diff| {errs[what]}")
  return errs


def optimizer_ab(torch, state, step_fn, batch):
  """Phase 11's optimizer A/B: the train step with train_lib.Adam's update
  ("multi") and with loop_adam_update ("loop") in 8 turns (multi, loop,
  loop, multi, twice), each the mean of 8 steps by CUDA events after 2
  warm-up steps. Returns {arm: [ms of each turn]}."""
  opt = state.optimizer
  times = {"multi": [], "loop": []}
  for way in ("multi", "loop", "loop", "multi") * 2:
    if way == "loop":
      opt.update = lambda grads: loop_adam_update(opt, grads)
    try:
      times[way].append(cuda_ms(torch, lambda: step_fn(state, batch), iters=8, warmup=2))
    finally:
      opt.__dict__.pop("update", None)
  return times


def _half_batch_train_step(model, optimizer, lr_fn):
  """train_lib.make_train_step's step in one process with the gradient of
  each half of the batch (with its rows of the noise, drawn for the whole
  batch) taken apart and averaged: what two DDP ranks compute. Phase 18
  swaps it in for make_train_step to make the reference of the DDP run."""
  import torch

  params = list(model.parameters())

  def train_step(state, batch, noise=None):
    if noise is None:
      noise = model.training_noise(tuple(batch.shape), state.generator)
    half = batch.shape[0] // 2
    grads, metrics = [], []
    for rows in (slice(0, half), slice(half, None)):
      loss, m, _ = model.end_to_end_frame_loss(batch[rows], training=True, step=state.step,
                                               noise=tuple(n[rows] for n in noise))
      grads.append(torch.autograd.grad(loss, params))
      metrics.append(m)
    # DDP divides each rank's gradient by the world size, then sums.
    optimizer.update([a / 2 + b / 2 for a, b in zip(*grads)])
    state.step += 1
    out = {k: (metrics[0][k].detach() + metrics[1][k].detach()) / 2 for k in metrics[0]}
    out["scheduled_lr"] = torch.tensor(float(lr_fn(state.step - 1)))
    return out

  return train_step


def parallel_phase(image, zero_counts, read_counts, smi, eval_ms_per_image):
  """Phase 18: the multi-device paths on one card, the flagship at full
  width; eval_ms_per_image are phase 4's ms per image of the eval. Returns
  the phase's numbers and its launches by path."""
  import torch
  import torch.nn.functional as F
  from shallow_ntc_tpu_torch import compress as compress_cli
  from shallow_ntc_tpu_torch import configs, data as data_lib, eval_lib, measure, train_lib
  from shallow_ntc_tpu_torch.codec import api as codec_api
  from shallow_ntc_tpu_torch.models import base as models_base
  from shallow_ntc_tpu_torch.ops import metrics_ops
  from shallow_ntc_tpu_torch.ops import twolayer_final as tl
  from shallow_ntc_tpu_torch.parallel import distributed as dist_lib
  from shallow_ntc_tpu_torch.utils import cli
  from shallow_ntc_tpu_torch.utils import config as config_lib

  phase = "parallel"
  t_phase = time.time()
  dev = torch.device("cuda", 0)
  summary = {"nvidia_smi": smi}
  # The launches of the parallel paths, and those of the runs they are
  # held against (the one process, the DDP control, the unsplit codec CLI).
  launches, reference = {}, {}
  x = torch.from_numpy(image[None]).to(dev)

  # 1. MS-SSIM's moment filters: F.conv2d with cuDNN's TF32 on (the code
  # before the repair) beside the repaired _filter2d_valid, on a 512x768
  # pair (the image and a noisy copy, 0..255).
  img255 = (x + 0.5) * 255.0
  noisy = torch.clamp(img255 + 12.0 * torch.randn(img255.shape, device=dev,
                                                  generator=torch.Generator(dev).manual_seed(3)),
                      0, 255)
  pair = metrics_ops._nchw(img255), metrics_ops._nchw(noisy)
  kern = metrics_ops._gaussian_kernel(11, 1.5, dev)

  def tf32_filter(v):  # the two convolutions as they ran before the repair
    c, k = v.shape[1], kern.shape[0]
    v = F.conv2d(v, kern.reshape(1, 1, 1, k).expand(c, 1, 1, k), groups=c)
    return F.conv2d(v, kern.reshape(1, 1, k, 1).expand(c, 1, k, 1), groups=c)

  torch.backends.cudnn.allow_tf32 = True
  try:
    moments = [(p * q) for p in pair for q in pair] + list(pair)
    filt_err = max((tf32_filter(m) - metrics_ops._filter2d_valid(m, kern)).abs().max().item()
                   for m in moments)
    ms_on = metrics_ops.msssim(img255, noisy)
  finally:
    torch.backends.cudnn.allow_tf32 = False
  ms_off = metrics_ops.msssim(img255, noisy)
  summary["msssim_tf32"] = dict(filter_max_abs_err_tf32_vs_fp32=filt_err,
                                msssim_tf32_on=ms_on.item(), msssim_tf32_off=ms_off.item())
  log(phase, f"MS-SSIM filters on a 512x768 pair: F.conv2d under TF32 against the repaired "
      f"filter max|diff| {filt_err:.3e} over the five moments; MS-SSIM with TF32 on "
      f"{ms_on.item():.9f}, off {ms_off.item():.9f}")
  check(torch.equal(ms_on, ms_off), "MS-SSIM depends on the TF32 setting")

  # 2. The height-split eval of one 512x768 image (2 and 4 strips on cuda:0)
  # against the unsplit one: bpp, PSNR and rd_loss within rtol 1e-4; the
  # final deconv once a strip; times by the host clock after a synchronize.
  model = eval_lib.build_model(configs.TWO_LAYER_SYN_RD, init_seed=0, device=dev)
  evals = {}
  for strips in (1, 2, 4):
    devices = None if strips == 1 else [dev] * strips
    list(eval_lib.evaluate_images(model, image[None], devices=devices))  # warm-up
    zero_counts()
    t = time.perf_counter()
    (record,) = eval_lib.evaluate_images(model, image[None], devices=devices)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t
    evals[strips] = dict(record=record, ms=1e3 * secs, launches=read_counts())
  summary["split_eval"] = {k: dict(ms=v["ms"], launches=v["launches"],
                                   **{m: v["record"][m] for m in ("bpp", "latent_bpp",
                                                                  "hyper_latent_bpp", "psnr",
                                                                  "rd_loss")})
                           for k, v in evals.items()}
  for strips in (2, 4):
    rel = {m: abs(evals[strips]["record"][m] - evals[1]["record"][m])
           / abs(evals[1]["record"][m]) for m in ("bpp", "psnr", "rd_loss")}
    summary["split_eval"][strips]["rel_to_unsplit"] = rel
    log(phase, f"eval of a {image.shape[0]}x{image.shape[1]} image on {strips} strips "
        f"({[str(dev)] * strips}): "
        f"{evals[strips]['ms']:.2f} ms against unsplit {evals[1]['ms']:.2f} ms (host clock, "
        f"one image); rel to unsplit {rel}; launches {evals[strips]['launches']}  [{smi}]")
    check(all(r <= 1e-4 for r in rel.values())
          and evals[strips]["launches"][tl.STATS.name] == strips,
          f"the {strips}-strip eval: {summary['split_eval'][strips]}")
  launches["split eval 2 strips"] = evals[2]["launches"]
  launches["split eval 4 strips"] = evals[4]["launches"]

  # 3. Is the eval reproducible? The eval (each image's forward under cuDNN's
  # deterministic algorithms, no autotuning) twice, held bit for bit; the
  # same forward twice under cuDNN's default algorithms, and the first
  # module (in call order) whose output then differs run to run. Then the
  # forward alone both ways by CUDA events, in 40 pairs whose order
  # alternates: the cost is the median of the pairs' differences, beside
  # their spread and phase 4's ms per image of the eval.
  offset = model.prior_quantization_offset()

  def forward(deterministic):
    flags = (torch.backends.cudnn.flags(enabled=True, benchmark=False, deterministic=True,
                                        allow_tf32=torch.backends.cudnn.allow_tf32)
             if deterministic else contextlib.nullcontext())
    with torch.no_grad(), flags:
      return model.frame_loss_given_latent_rvs(x, model.infer_latent_rvs(x), training=False,
                                               frozen_offset=offset)

  def traced(run):
    outs = []
    hooks = [m.register_forward_hook(
        lambda mod, inp, out, name=name: outs.append(
            (name, out.detach().clone() if torch.is_tensor(out) else None)))
        for name, m in model.named_modules() if not list(m.children())]
    try:
      record = run()
    finally:
      for h in hooks:
        h.remove()
    return record, outs

  def same(a, b):  # records equal, NaN equal to NaN
    return a.keys() == b.keys() and all(np.array_equal(a[k], b[k], equal_nan=True) for k in a)

  det = [traced(lambda: list(eval_lib.evaluate_images(model, image[None]))[0])
         for _ in range(2)]
  plain = [traced(lambda: {k: float(v) for k, v in forward(False)[1].items()})
           for _ in range(2)]

  def first_differing(runs):
    return next(((name, (a - b).abs().max().item()) for (name, a), (_, b)
                 in zip(runs[0][1], runs[1][1]) if a is not None and not torch.equal(a, b)),
                None)

  det_equal = same(det[0][0], det[1][0]) and first_differing(det) is None
  plain_equal, first = same(plain[0][0], plain[1][0]), first_differing(plain)

  def forward_ms(deterministic):
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    forward(deterministic)
    end.record()
    end.synchronize()
    return start.elapsed_time(end)

  ms = {False: [], True: []}
  for i in range(40):
    for deterministic in ((True, False) if i % 2 else (False, True)):
      ms[deterministic].append(forward_ms(deterministic))
  diffs = np.subtract(ms[True], ms[False])
  cost_ms = float(np.median(diffs))
  spread = [float(v) for v in np.percentile(diffs, [0, 25, 75, 100])]
  eval_ms = float(np.mean(eval_ms_per_image))
  summary["repeat"] = dict(deterministic_equal=det_equal, plain_equal=plain_equal,
                           first_differing_module=first, modules_traced=len(plain[0][1]),
                           forward_ms_deterministic=float(np.median(ms[True])),
                           forward_ms_default_algorithms=float(np.median(ms[False])),
                           cost_ms_median_of_40_pairs=cost_ms,
                           cost_ms_min_p25_p75_max=spread,
                           eval_ms_per_image_phase4=eval_ms,
                           cost_share_of_eval=cost_ms / eval_ms)
  log(phase, f"the eval twice (deterministic cuDNN, its default): "
      f"{'equal' if det_equal else 'DIFFERS'} in all {len(det[0][1])} modules' outputs; the "
      f"forward twice with cuDNN's default algorithms: {'equal' if plain_equal else 'differs'}, "
      f"first module whose output differs run to run: {first}; the forward of one "
      f"{image.shape[0]}x{image.shape[1]} image (CUDA events, median of 40, order alternating) "
      f"deterministic {np.median(ms[True]):.4f} ms, default algorithms "
      f"{np.median(ms[False]):.4f} ms; cost (median of the 40 pair differences) "
      f"{cost_ms:+.4f} ms, min/p25/p75/max {' / '.join(f'{v:+.4f}' for v in spread)} ms; "
      f"phase 4's eval {eval_ms:.4f} ms an image, so the cost is {cost_ms / eval_ms:+.4%} of "
      f"it  [{smi}]")
  check(det_equal, "two evals under deterministic cuDNN differ")

  with contextlib.ExitStack() as stack:
    tmp = stack.enter_context(tempfile.TemporaryDirectory())
    saved_env = {k: os.environ.get(k) for k in ("SLURM_ARRAY_JOB_ID", "SLURM_ARRAY_TASK_ID",
                                                "SNTC_FUSED_RB_CHAIN")}

    def restore_env():
      for k, v in saved_env.items():
        if v is None:
          os.environ.pop(k, None)
        else:
          os.environ[k] = v

    stack.callback(restore_env)
    os.environ.update(SLURM_ARRAY_TASK_ID="3", SNTC_FUSED_RB_CHAIN="1")
    script = os.path.join(os.path.dirname(os.path.abspath(__file__)), "shallow_ntc_tpu_torch",
                          "mshyper", "configs", "two_layer_syn_rd.py")
    te, td, vd = "--config.train_eval_config.", "--config.train_data_config.", \
        "--config.val_data_config."

    # No warm-up: the flagship's default (2% of 30000 steps) would keep the
    # learning rate near 1e-7 for these steps, where no gradient could move
    # a parameter past the comparison's atol.
    optimizer = dict(config_lib.load_config_module(script).get_config()["model_config"]
                     ["optimizer_config"], warmup_until=0.0)

    def argv(xid, steps):
      return ["--config", script, "--hid", "3", "--matmul_precision", "highest",
              f"--config.model_config.optimizer_config={optimizer!r}",
              "--experiments_dir", os.path.join(tmp, xid), f"{te}num_steps={steps}",
              f"{te}log_metrics_every_steps=1", f"{te}eval_every_steps={steps}",
              f"{te}checkpoint_every_steps={steps}", f"{te}max_validation_steps=1",
              f"{td}dataset=synthetic", f"{td}batchsize={TRAIN_BATCH}",
              f"{td}patchsize={TRAIN_HW}", f"{vd}dataset=synthetic", f"{vd}batchsize=2",
              f"{vd}patchsize={TRAIN_HW}"]

    def rows(workdir, collection="train"):
      with open(os.path.join(workdir, collection, "record.jsonl")) as f:
        return [json.loads(line) for line in f]

    # 4. DDP: two gloo ranks on cuda:0, spawned by the train CLI
    # (--dp_devices 2 --dist_backend gloo), 3 steps at B=8 256x256 with the
    # chain kernel, under measure.deterministic(); each rank reports its launch
    # counts. Then the control: the same run with each rank on its own
    # gradients.
    real_rank = cli._train_rank

    def two_ranks(xid, rank_fn):
      os.environ["SLURM_ARRAY_JOB_ID"] = xid
      cli._train_rank = rank_fn
      try:
        t = time.time()
        _, workdir = cli.run_train_main("mshyper", argv(xid, PAR_STEPS)
                                        + ["--dp_devices", "2", "--dist_backend", "gloo"])
        secs = time.time() - t
      finally:
        cli._train_rank = real_rank
      counts = []
      for r in range(2):
        with open(os.path.join(tmp, xid, f"launches_rank{r}.json")) as f:
          counts.append(json.load(f))
      return workdir, secs, counts

    ddp_dir, ddp_s, ranks = two_ranks("ddp", _counted_train_rank)
    ctl_dir, _, ctl_ranks = two_ranks("ctl", _unsynced_train_rank)
    # 5. The same 3 steps in one process (--dp_devices 1) under
    # measure.deterministic(), on the same global batches and noise: at B=8, and
    # the reference, each half batch's gradient taken apart and averaged.
    # Both issue the eager step (--dispatch eager), as the DDP ranks do.
    def one_process(xid):
      os.environ["SLURM_ARRAY_JOB_ID"] = xid
      zero_counts()
      t = time.time()
      with measure.deterministic():
        _, workdir = cli.run_train_main("mshyper", argv(xid, PAR_STEPS)
                                        + ["--dp_devices", "1", "--dispatch", "eager"])
      return workdir, time.time() - t, read_counts()

    one_dir, one_s, one_counts = one_process("one")
    real_step = train_lib.make_train_step
    train_lib.make_train_step = _half_batch_train_step
    try:
      ref_dir, _, _ = one_process("ref")
    finally:
      train_lib.make_train_step = real_step

    # The parameters after the steps, each run's against the reference's
    # and the B=8 run's: p at tests/test_parallel.py's tolerance (rtol
    # 2e-3, atol 2e-6), bit for bit, and the change from the seeded init
    # (p - p0) as one vector, its L2 distance over its norm.
    with open(os.path.join(one_dir, "config.json")) as f:
      init, _ = train_lib.build_model(json.load(f)["model_config"], 0, dev)
    p0 = {k: v.detach().cpu() for k, v in init.state_dict().items()}
    del init

    def final_params(workdir):
      return train_lib.load_newest_checkpoint(train_lib.checkpoint_dir(workdir))["model"]

    p_one, p_ref = final_params(one_dir), final_params(ref_dir)

    def against(workdir, want):
      p = final_params(workdir)
      over_tol = max(((p[k] - want[k]).abs() / (2e-6 + 2e-3 * want[k].abs())).max().item()
                     for k in want)
      d = torch.cat([(p[k] - p0[k]).flatten() for k in p0])
      d_want = torch.cat([(want[k] - p0[k]).flatten() for k in p0])
      return dict(err_over_tol=over_tol, equal=all(torch.equal(p[k], want[k]) for k in want),
                  change_rel_l2=((d - d_want).norm() / d_want.norm()).item())

    r_ddp, r_one, r_ctl = rows(ddp_dir), rows(one_dir), rows(ctl_dir)
    loss_rel = [abs(a["rd_loss"] - b["rd_loss"]) / abs(b["rd_loss"]) for a, b in zip(r_ddp, r_one)]
    ctl_loss_rel = [abs(a["rd_loss"] - b["rd_loss"]) / abs(b["rd_loss"])
                    for a, b in zip(r_ctl, r_one)]
    vs_ref, vs_one = against(ddp_dir, p_ref), against(ddp_dir, p_one)
    ctl_vs_ref = against(ctl_dir, p_ref)
    ddp_ms = [1e3 / r["steps_per_sec"] for r in r_ddp]
    one_ms = [1e3 / r["steps_per_sec"] for r in r_one]
    max_change = max((p_one[k] - p0[k]).abs().max().item() for k in p0)
    summary["ddp"] = dict(seconds=ddp_s, one_process_seconds=one_s, rd_loss_rel=loss_rel,
                          params_vs_reference=vs_ref, params_vs_one_process=vs_one,
                          one_process_max_abs_change=max_change,
                          reference_vs_one_process=against(ref_dir, p_one),
                          control=dict(rd_loss_rel=ctl_loss_rel, params_vs_reference=ctl_vs_ref,
                                       launches_by_rank=ctl_ranks),
                          step_ms=ddp_ms, one_process_step_ms=one_ms,
                          launches_by_rank=ranks, one_process_launches=one_counts,
                          val=rows(ddp_dir, "val"), one_process_val=rows(one_dir, "val"))
    log(phase, f"DDP, 2 gloo ranks on cuda:0 (train CLI --dp_devices 2), {PAR_STEPS} steps of "
        f"B={TRAIN_BATCH} {TRAIN_HW}x{TRAIN_HW} f32 at lr 1e-4 without warm-up, chain on, "
        f"deterministic, in {ddp_s:.1f} s; one process at B={TRAIN_BATCH} in {one_s:.1f} s "
        f"(max |p - p0| {max_change:.3e}): rd_loss rel {[f'{v:.2e}' for v in loss_rel]} (tol "
        f"1e-4); params against the half-batch reference: max |diff| / (2e-6 + 2e-3 |p|) "
        f"{vs_ref['err_over_tol']:.3f} (<= 1), bit for bit {vs_ref['equal']}, change rel "
        f"{vs_ref['change_rel_l2']:.3e}; against the B={TRAIN_BATCH} run "
        f"{vs_one['err_over_tol']:.3f}, change rel {vs_one['change_rel_l2']:.3e}; the control "
        f"(each rank on its own gradients): rd_loss rel {[f'{v:.2e}' for v in ctl_loss_rel]}, "
        f"params {ctl_vs_ref['err_over_tol']:.3f} (must be > 1), change rel "
        f"{ctl_vs_ref['change_rel_l2']:.3e}; ms a step (record.jsonl) DDP "
        f"{' / '.join(f'{v:.1f}' for v in ddp_ms)}, one process "
        f"{' / '.join(f'{v:.1f}' for v in one_ms)}; launches by rank {ranks}, one process "
        f"{one_counts}  [{smi}]")
    forwards = PAR_STEPS + 1  # 3 steps and 1 val batch, a rank's half of each
    check(len(r_ddp) == len(r_one) == PAR_STEPS and max(loss_rel) <= 1e-4
          and vs_ref["err_over_tol"] <= 1 and ctl_vs_ref["err_over_tol"] > 1
          and all(r[tl.STATS.name] == forwards and r["fused_rb_chain"] == 7 * forwards
                  for r in ranks)
          and one_counts[tl.STATS.name] == PAR_STEPS + 1,
          f"the DDP run against one process: {summary['ddp']}")
    launches["ddp rank 0"], launches["ddp rank 1"] = ranks
    reference["ddp one process"] = one_counts
    reference["ddp control rank 0"], reference["ddp control rank 1"] = ctl_ranks

    # 6. One NCCL rank (world size 1) through the train CLI's --coordinator,
    # 2 steps, in this process (the CLI leaves the group at its end); its
    # checkpoint into the plain eval.
    os.environ["SLURM_ARRAY_JOB_ID"] = "nccl"
    with socket.socket() as s:
      s.bind(("127.0.0.1", 0))
      port = s.getsockname()[1]
    seen = []  # (backend, world size) of the group, read as the CLI leaves it
    real_shutdown = dist_lib.shutdown

    def shutdown():
      seen.append((torch.distributed.get_backend(), torch.distributed.get_world_size()))
      real_shutdown()

    dist_lib.shutdown = shutdown
    zero_counts()
    t = time.time()
    try:
      cli.run_train_main("mshyper", argv("nccl", NCCL_STEPS) + [
          "--coordinator", f"127.0.0.1:{port}", "--num_processes", "1", "--process_id", "0"])
    finally:
      dist_lib.shutdown = real_shutdown
    nccl_s = time.time() - t
    nccl_counts = read_counts()
    nccl_backend = seen[0] if seen else None
    check(not torch.distributed.is_initialized(), "the train CLI left its process group open")
    (nccl_dir,) = glob_lib.glob(os.path.join(tmp, "nccl", "nccl", "wid=3-*"))
    nccl_model, cfg = eval_lib.load_latest_ckpt(nccl_dir, device=dev)
    zero_counts()
    (nccl_eval,) = eval_lib.evaluate_images(nccl_model, image[None])
    nccl_eval_counts = read_counts()
    summary["nccl"] = dict(seconds=nccl_s, launches=nccl_counts, step=cfg["_restored_step"],
                           train=rows(nccl_dir), eval=nccl_eval,
                           backend_seen=nccl_backend)
    log(phase, f"NCCL, world size 1 (train CLI --coordinator), {NCCL_STEPS} steps in "
        f"{nccl_s:.1f} s, group {nccl_backend}, launches {nccl_counts}; its checkpoint (step "
        f"{cfg['_restored_step']}) in the plain eval: bpp {nccl_eval['bpp']:.4f} PSNR "
        f"{nccl_eval['psnr']:.3f}")
    check(nccl_backend == ("nccl", 1) and cfg["_restored_step"] == NCCL_STEPS
          and np.isfinite(nccl_eval["rd_loss"])
          and nccl_counts[tl.STATS.name] == NCCL_STEPS + 1
          and nccl_eval_counts[tl.STATS.name] == 1, f"the NCCL run: {summary['nccl']}")
    launches["nccl train"] = nccl_counts

    # 7. The codec of that workdir on a PNG: the CLI's bitstream
    # (--spatial_devices 1) decoded by a 2-strip codec and by the CLI, and a
    # 2-strip codec's bitstream decoded by the CLI: each pair bit for bit.
    png = os.path.join(tmp, "img.png")
    raw = np.round((image + 0.5) * 255.0).astype(np.uint8)
    data_lib.write_png(png, raw)
    common = ["--workdir", nccl_dir, "--spatial_devices", "1"]
    zero_counts()
    compress_cli.main(["compress", "--input", png, "--output", png + ".sntc"] + common)
    compress_cli.main(["decompress", "--input", png + ".sntc", "--output", png + ".1.png"]
                      + common)
    cli_counts = read_counts()
    split = codec_api.make_codec(nccl_model, devices=[dev, dev])
    zero_counts()
    with open(png + ".sntc", "rb") as f:
      blob_cli = f.read()
    rec_split = split.decompress(blob_cli)
    result = split.compress(models_base.normalize_image(raw.astype(np.float32)))
    split_counts = read_counts()
    with open(png + ".split.sntc", "wb") as f:
      f.write(result.bitstring)
    compress_cli.main(["decompress", "--input", png + ".split.sntc", "--output", png + ".2.png"]
                      + common)
    rec_cli = data_lib.read_png(png + ".1.png")
    rec_cli2 = data_lib.read_png(png + ".2.png")
    diff_a = int(np.abs(rec_split.astype(int) - rec_cli.astype(int)).max())
    diff_b = int(np.abs(result.reconstruction.astype(int) - rec_cli2.astype(int)).max())
    same_a = np.array_equal(rec_split, rec_cli)
    same_b = np.array_equal(result.reconstruction, rec_cli2)
    summary["codec"] = dict(bytes_cli=len(blob_cli), bytes_split=len(result.bitstring),
                            same_blob=blob_cli == result.bitstring,
                            cli_to_split_equal=same_a, cli_to_split_max_diff=diff_a,
                            split_to_cli_equal=same_b, split_to_cli_max_diff=diff_b,
                            cli_launches=cli_counts, split_launches=split_counts)
    log(phase, f"codec of the NCCL workdir on a {raw.shape[0]}x{raw.shape[1]} PNG: CLI "
        f"bitstream ({len(blob_cli)} B) "
        f"decoded by the 2-strip codec {'equal' if same_a else f'max|diff| {diff_a}'} to the "
        f"CLI's decode; 2-strip bitstream ({len(result.bitstring)} B, "
        f"{'the same bytes' if blob_cli == result.bitstring else 'other bytes'}) decoded by the "
        f"CLI {'equal' if same_b else f'max|diff| {diff_b}'} to the encoder's; launches CLI "
        f"{cli_counts}, 2-strip codec {split_counts}")
    check(same_a and same_b and split_counts[tl.STATS.name] == 2 * 2,
          f"split and unsplit bitstreams across: {summary['codec']}")
    reference["codec cli"] = cli_counts
    launches["codec 2 strips"] = split_counts
  summary["launches"] = launches
  summary["reference_launches"] = reference
  summary["seconds"] = time.time() - t_phase
  log(phase, f"{summary['seconds']:.1f} s")
  return summary


IMG_TRAIN_STEPS = 3  # two_layer_syn.py (cocotrain) trained through the CLI
IMG_NATIVE_STEPS = 2  # native-branch batches fed to the flagship's train step
IMG_LOADER_BATCHES = 20  # timed B=8 batches of the loader per thread count
IMG_VAL_IMAGES = 2  # kodak_landscape stand-ins, 512x768 dead leaves, all validated


def header_check():
  """What the host offers an image decoder: zlib's, libjpeg's and libpng's
  headers, the shared libraries the loader could link, and the compiler."""
  headers = {h: os.path.exists(os.path.join("/usr/include", h))
             for h in ("jpeglib.h", "png.h", "zlib.h")}
  try:
    ldconfig = subprocess.run(["ldconfig", "-p"], capture_output=True, text=True,
                              timeout=60).stdout
  except OSError as e:
    ldconfig = f"ldconfig: {e}"
  libs = sorted({line.split()[0] for line in ldconfig.splitlines()
                 if any(k in line for k in ("jpeg", "png", "libz"))})
  cxx = subprocess.run(["g++", "--version"], capture_output=True, text=True, timeout=60)
  return dict(headers=headers, libraries=libs, gxx=cxx.stdout.splitlines()[0])


def image_input_phase(zero_counts, read_counts, smi, train_step_ms):
  """Phase 19: JPEG input. The host's image headers; every committed test
  image decoded twice on the port's native loader, equal to the digests of
  the JAX package's reads (tests/data/jpeg_sha256.json: PIL, and JAX's
  libjpeg/libpng loader); decode_crop_batch with 1 and 8 threads, centre
  crops against the whole decode; the loader's ms per B=8 batch of 256x256
  crops beside the train step's; the paper's flagship config
  (mshyper/configs/two_layer_syn.py, dataset cocotrain) trained through the
  experiment CLI on the JPEGs with the chain kernel on, its checkpoint
  evaluated; a DatasetIterable whose store's cache_limit sends it down the
  native branch, 2 of its batches fed to the flagship's train step.
  Returns the phase's numbers and its launches by path."""
  import hashlib

  import torch
  from shallow_ntc_tpu_torch import data as data_lib
  from shallow_ntc_tpu_torch import dataio, deadleaves, eval_lib, train_lib
  from shallow_ntc_tpu_torch.utils import config as config_lib

  phase = "image-input"
  t_phase = time.time()
  root = os.path.dirname(os.path.abspath(__file__))
  fixtures = os.path.join(root, "tests", "data", "jpeg")
  summary = {"nvidia_smi": smi, "host": header_check()}
  log(phase, f"host: {json.dumps(summary['host'])}")
  launches = {}

  # 1. Every committed image, twice, against the JAX package's reads.
  with open(os.path.join(root, "tests", "data", "jpeg_sha256.json")) as f:
    refs = json.load(f)

  def digest(x):
    return hashlib.sha256(np.ascontiguousarray(x).tobytes()).hexdigest()

  held = {}
  for name, ref in sorted(refs.items()):
    path = os.path.join(fixtures, name)
    if ref["decode_image"] is None and name.endswith(".jpg"):  # CMYK: no RGB decode
      try:
        data_lib.read_png(path)
        held[name] = "decoded"
      except ValueError:
        held[name] = "raises"
      continue
    a, b = dataio.decode_image(path), dataio.decode_image(path)
    whole = data_lib.read_png(path)
    held[name] = (np.array_equal(a, b) and list(whole.shape) == ref["shape"]
                  and digest(whole) == ref["read_png"]
                  and ref["decode_image"] in (None, digest(a)))
  summary["decode_held"] = held
  log(phase, f"{len(refs)} images decoded twice and held to the JAX package's reads: {held}")
  check(all(v is True or v == "raises" for v in held.values()), f"image decodes: {held}")

  coco = sorted(glob_lib.glob(os.path.join(fixtures, "coco_*.jpg")))
  rng = np.random.default_rng(19)
  seeds = rng.integers(0, 2**62, len(coco))
  one = dataio.decode_crop_batch(coco, TRAIN_HW, seeds, threads=1)
  eight = dataio.decode_crop_batch(coco, TRAIN_HW, seeds, threads=8)
  centre = dataio.decode_crop_batch(coco, TRAIN_HW, [-1] * len(coco), threads=8)
  y0, x0 = (480 - TRAIN_HW) // 2, (640 - TRAIN_HW) // 2
  same_centre = all(np.array_equal(c, dataio.decode_image(p)[y0:y0 + TRAIN_HW, x0:x0 + TRAIN_HW])
                    for c, p in zip(centre, coco))
  log(phase, f"decode_crop_batch B={len(coco)} {TRAIN_HW}x{TRAIN_HW}: 1 thread = 8 threads "
      f"{np.array_equal(one, eight)}; centre crops = the whole decode's window {same_centre}")
  check(np.array_equal(one, eight) and same_centre, "decode_crop_batch differs by threads or "
        "from the whole decode")

  # 2. The loader's time per B=8 batch (host), beside the train step's.
  loader_ms = {}
  for threads in (1, 8):
    times = []
    for i in range(IMG_LOADER_BATCHES + 1):
      t = time.perf_counter()
      dataio.decode_crop_batch(coco, TRAIN_HW, seeds + i, threads=threads)
      times.append(1e3 * (time.perf_counter() - t))
    loader_ms[threads] = dict(median=float(np.median(times[1:])), min=float(min(times[1:])),
                              max=float(max(times[1:])), n=IMG_LOADER_BATCHES)
  summary["loader_ms_per_batch"] = loader_ms
  log(phase, f"loader, B={len(coco)} {TRAIN_HW}x{TRAIN_HW} crops of 640x480 JPEGs (host, median "
      f"of {IMG_LOADER_BATCHES}): 1 thread {loader_ms[1]['median']:.2f} ms "
      f"({loader_ms[1]['min']:.2f}-{loader_ms[1]['max']:.2f}), 8 threads "
      f"{loader_ms[8]['median']:.2f} ms ({loader_ms[8]['min']:.2f}-{loader_ms[8]['max']:.2f}); "
      f"the train step (timing, chain off / on): {train_step_ms['off']:.2f} / "
      f"{train_step_ms['on']:.2f} ms  [{smi}]")

  with tempfile.TemporaryDirectory() as tmp:
    # 3. The flagship config script through the experiment CLI, its data
    # names resolved under SHALLOW_NTC_DATA_DIR.
    data_root = os.path.join(tmp, "data")
    os.makedirs(os.path.join(data_root, "coco", "train2017"))
    for p in coco:
      shutil.copy(p, os.path.join(data_root, "coco", "train2017"))
    for i in range(IMG_VAL_IMAGES):
      data_lib.write_png(os.path.join(data_root, "kodak_landscape", f"kodim{i + 1:02d}.png"),
                         deadleaves.deadleaves_image(900_100 + i, *EVAL_HW))
    env = dict(os.environ, PYTHONPATH=root, SHALLOW_NTC_DATA_DIR=data_root,
               SHALLOW_NTC_PROJECT_DIR=tmp, SLURM_ARRAY_JOB_ID="smoke", SLURM_ARRAY_TASK_ID="0",
               SNTC_FUSED_RB_CHAIN="1")
    env.pop("SNTC_FUSED_RESBLOCK", None)
    te = "--config.train_eval_config."
    script = os.path.join(root, "shallow_ntc_tpu_torch", "mshyper", "configs", "two_layer_syn.py")
    xms = os.path.join(tmp, "train_xms")
    counts_path = os.path.join(tmp, "train_counts.json")
    t = time.time()
    proc = subprocess.run(
        [*COUNTED, counts_path, "shallow_ntc_tpu_torch.mshyper.train",
         "--config", script, "--hid", "0", f"{te}num_steps={IMG_TRAIN_STEPS}",
         f"{te}eval_every_steps={IMG_TRAIN_STEPS}",
         f"{te}checkpoint_every_steps={IMG_TRAIN_STEPS}", f"{te}log_metrics_every_steps=1",
         "--matmul_precision", "highest", "--experiments_dir", xms],
        cwd=tmp, env=env, capture_output=True, text=True, timeout=600)
    train_s = time.time() - t
    if proc.returncode:
      print(proc.stdout[-4000:], proc.stderr[-8000:], file=sys.stderr, flush=True)
      raise RuntimeError(f"the train CLI of two_layer_syn.py exited with {proc.returncode}")
    with open(counts_path) as f:
      counts = json.load(f)
    launches["cocotrain CLI"] = counts
    workdirs = glob_lib.glob(os.path.join(xms, "smoke", "wid=0-*"))
    check(len(workdirs) == 1, f"workdirs {workdirs}")
    workdir = workdirs[0]
    with open(os.path.join(workdir, "config.json")) as f:
      saved = json.load(f)
    with open(os.path.join(workdir, "train", "record.jsonl")) as f:
      rows = [json.loads(line) for line in f]
    with open(os.path.join(workdir, "val", "record.jsonl")) as f:
      val_rows = [json.loads(line) for line in f]
    step_ms = [1e3 / r["steps_per_sec"] for r in rows]
    forwards = IMG_TRAIN_STEPS + IMG_VAL_IMAGES
    summary["train"] = dict(workdir=os.path.relpath(workdir, tmp), seconds=train_s,
                            step_ms=step_ms, rd_loss=[r["rd_loss"] for r in rows], val=val_rows,
                            launches=counts)
    log(phase, f"two_layer_syn.py --hid 0 (dataset {saved['train_data_config']['dataset']}) "
        f"through the train CLI in {train_s:.1f} s: workdir {os.path.basename(workdir)}, steps "
        f"{[r['step'] for r in rows]}, ms a step (record.jsonl) "
        f"{' / '.join(f'{x:.1f}' for x in step_ms)}, rd_loss "
        f"{' / '.join(f'{r['rd_loss']:.3f}' for r in rows)}; val {val_rows}; launches {counts}"
        f"  [{smi}]")
    check(saved["train_data_config"]["dataset"] == "cocotrain"
          and saved["model_config"]["transform_config"]["analysis"]["channels"] == [192, 192,
                                                                                    192, 320]
          and [r["step"] for r in rows] == list(range(1, IMG_TRAIN_STEPS + 1))
          and all(np.isfinite(v) for r in rows + val_rows for v in r.values())
          and train_lib.latest_checkpoint_step(workdir) == IMG_TRAIN_STEPS
          and counts["fused_rb_chain"] == CHAINS_PER_FORWARD * forwards
          and counts["final_deconv_phase"] == forwards, f"the train CLI's run: {summary['train']}")

    # The checkpoint, evaluated in this process on the two validation images.
    model, restored = eval_lib.load_latest_ckpt(workdir, device="cuda")
    val_glob = os.path.join(data_root, "kodak_landscape", "*.png")
    records = list(eval_lib.evaluate_images(model, data_lib.get_dataset(val_glob, "test", 1, None),
                                            step=IMG_TRAIN_STEPS))
    del model
    summary["eval"] = [{k: r[k] for k in ("bpp", "psnr", "rd_loss")} for r in records]
    log(phase, f"checkpoint step {restored['_restored_step']} evaluated on {len(records)} "
        f"images: {summary['eval']}")
    check(restored["_restored_step"] == IMG_TRAIN_STEPS and len(records) == IMG_VAL_IMAGES
          and all(np.isfinite(v) for r in summary["eval"] for v in r.values()),
          f"the checkpoint's eval: {summary['eval']}")

  # 4. The native branch in this process: a store whose cache cannot hold
  # the decoded corpus (compressed bytes x 10), its batches fed to the
  # flagship's train step with the chain kernel on.
  limit = sum(os.path.getsize(p) for p in coco) * 10 - 1
  ds = data_lib.DatasetIterable(data_lib.ImageStore(coco, cache_limit_bytes=limit), "train",
                                TRAIN_BATCH, TRAIN_HW, shuffle=True, repeat=True,
                                drop_remainder=True, seed=0)
  check(ds._native_loader_usable(), "the dataset did not take the native branch")
  cfg = config_lib.resolve_config(script, [], 0)
  model, opt_cfg = train_lib.build_model(cfg["model_config"], init_seed=0, device="cuda")
  state, lr_fn = train_lib.create_train_state(model, opt_cfg)
  step = train_lib.make_train_step(model, state.optimizer, lr_fn)
  native_rows = []
  batches = iter(ds)
  zero_counts()
  with switch_on("SNTC_FUSED_RB_CHAIN"):
    for _ in range(IMG_NATIVE_STEPS):
      batch = next(batches)
      metrics = step(state, torch.from_numpy(batch).to("cuda"))
      native_rows.append({k: float(v) for k, v in metrics.items()})
  launches["native branch"] = read_counts()
  batches.close()
  del model, state, step
  summary["native"] = dict(batch_shape=list(batch.shape), metrics=native_rows,
                           launches=launches["native branch"])
  log(phase, f"native branch (cache_limit {limit} bytes < 10x the corpus): "
      f"{IMG_NATIVE_STEPS} batches {list(batch.shape)} {batch.dtype} through the flagship's "
      f"train step: rd_loss {[round(r['rd_loss'], 4) for r in native_rows]}; launches "
      f"{launches['native branch']}")
  check(batch.shape == (TRAIN_BATCH, TRAIN_HW, TRAIN_HW, 3) and batch.dtype == np.float32
        and all(np.isfinite(v) for r in native_rows for v in r.values())
        and launches["native branch"]["fused_rb_chain"] == CHAINS_PER_FORWARD * IMG_NATIVE_STEPS
        and launches["native branch"]["final_deconv_phase"] >= IMG_NATIVE_STEPS,
        f"the native branch's steps: {summary['native']}")
  summary["launches"] = launches
  summary["seconds"] = time.time() - t_phase
  log(phase, f"launches in this phase {launches}; {summary['seconds']:.1f} s")
  return summary


# This slice's path: the counted forwards of phase 20, each counted from 0.
FLOPS_PATH = ("flops: scripts/torch_get_flops.py's table on the card and the counted evals "
              "(flagship chain on, SNTC_FUSED_RESBLOCK=1, JPEGL_K16; phase 20)")
# The __global__ functions of the port's CUDA sources (csrc/*.cu).
KERNEL_SYMBOLS = ("final_deconv_kernel", "resblock_kernel", "jpegl_tiled_kernel",
                  "jpegl_k16_bf16_kernel")


def read_flops_audit():
  """results/flops_audit.csv (the JAX package's XLA count at 512x768):
  {transform: (FLOPs per pixel, params)}; the names hold unquoted commas."""
  with open(os.path.join(os.path.dirname(os.path.abspath(__file__)), "results",
                         "flops_audit.csv")) as f:
    rows = [line.strip().rsplit(",", 2) for line in f if line.strip()]
  return {name: (float(fpp), int(params)) for name, fpp, params in rows[1:]}


def flops_phase(image, zero_counts, read_counts, smi, decode, decode_flops):
  """Phase 20: model FLOPs counted on the card against the CPU; the
  kernels launched in the counted forwards; the decodes' model rates; a
  trace of one decode. Returns the phase's numbers and launches by path."""
  import importlib.util

  import torch
  from shallow_ntc_tpu_torch import configs, eval_lib
  from shallow_ntc_tpu_torch.ops import jpegl_decode as jd
  from shallow_ntc_tpu_torch.ops import rb_chain as rb
  from shallow_ntc_tpu_torch.ops import resblock
  from shallow_ntc_tpu_torch.ops import twolayer_final as tl
  from shallow_ntc_tpu_torch.utils import profiling

  phase = "flops"
  t_phase = time.time()
  summary = {"nvidia_smi": smi}
  launches = {}

  # 1. scripts/torch_get_flops.py's table at 512x768 on the card (its
  # kernels on their routes) and on the CPU, held equal (the counts are
  # integers), beside results/flops_audit.csv (params equal, FLOPs within 2%).
  spec = importlib.util.spec_from_file_location(
      "torch_get_flops", os.path.join(os.path.dirname(os.path.abspath(__file__)), "scripts",
                                      "torch_get_flops.py"))
  script = importlib.util.module_from_spec(spec)
  spec.loader.exec_module(script)
  zero_counts()
  gpu_rows, gpu_s = profiling.with_timing(script.rows)(*EVAL_HW, torch.device("cuda"))
  launches["table"] = read_counts()
  cpu_rows, cpu_s = profiling.with_timing(script.rows)(*EVAL_HW, torch.device("cpu"))
  audit = read_flops_audit()
  summary["table"] = {}
  for (name, fpp, n_params), cpu_row in zip(gpu_rows, cpu_rows):
    csv_fpp, csv_params = audit[name]
    rel = fpp / csv_fpp - 1
    summary["table"][name] = dict(flops_per_pixel=fpp, params=n_params, cpu_equal=cpu_row[1:] == (
        fpp, n_params), rel_to_flops_audit=rel)
    log(phase, f"{name}: {fpp:.1f} FLOPs/px (CPU {cpu_row[1]:.1f}), {n_params} params; "
        f"flops_audit.csv {csv_fpp:.0f} ({rel:+.4%}), {csv_params} params")
    check(cpu_row == (name, fpp, n_params) and n_params == csv_params and abs(rel) <= 0.02,
          f"{name}: card {fpp} / {n_params}, CPU {cpu_row[1:]}, csv {audit[name]}")
  log(phase, f"the table of {len(gpu_rows)} transforms at {EVAL_HW[0]}x{EVAL_HW[1]}: card "
      f"{gpu_s:.2f} s, CPU {cpu_s:.2f} s (host clock); launches on the card {launches['table']}")
  check(launches["table"][tl.STATS.name] >= 1, "the table's TwoLayerResSynthesis launched no "
        "final_deconv_phase")

  # 2. The eval of one 512x768 image counted on the card and on the CPU
  # (plain versions), held equal: the flagship with the chain on and with
  # SNTC_FUSED_RESBLOCK=1, and JPEGL_K16; each kernel launched in the
  # counted forward on the card (the counts zeroed before and read after).
  summary["eval"] = {}
  for name, cfg, env in (("flagship chain", configs.TWO_LAYER_SYN_RD, "SNTC_FUSED_RB_CHAIN"),
                         ("flagship resblock", configs.TWO_LAYER_SYN_RD, "SNTC_FUSED_RESBLOCK"),
                         ("JPEGL_K16", configs.JPEGL_K16, None)):
    counts = {}
    with switch_on(env) if env else contextlib.nullcontext():
      for dev in ("cuda", "cpu"):
        m = eval_lib.build_model(cfg, init_seed=0, device=dev)
        zero_counts()
        counts[dev] = profiling.get_flops(lambda: list(eval_lib.evaluate_images(m, image[None])))
        if dev == "cuda":
          launches[name] = read_counts()
        del m
    summary["eval"][name] = dict(model_flops=counts["cuda"], cpu=counts["cpu"],
                                 flops_per_pixel=counts["cuda"] / (EVAL_HW[0] * EVAL_HW[1]),
                                 launches=launches[name])
    log(phase, f"eval {name} {EVAL_HW[0]}x{EVAL_HW[1]} f32: card {counts['cuda']:.0f} FLOPs "
        f"({counts['cuda'] / (EVAL_HW[0] * EVAL_HW[1]):.1f} a pixel), CPU {counts['cpu']:.0f}; "
        f"launches {launches[name]}")
    check(counts["cuda"] == counts["cpu"] > 0, f"eval {name} counts {counts}")
  check(launches["flagship chain"][rb.STATS.name] == CHAINS_PER_FORWARD
        and launches["flagship chain"][tl.STATS.name] >= 1
        and launches["flagship resblock"][resblock.STATS.name] == BLOCKS_PER_FORWARD
        and launches["flagship resblock"][tl.STATS.name] >= 1
        and launches["JPEGL_K16"][jd.STATS.name] >= 1,
        f"kernels not launched in the counted forwards: {launches}")

  # 3. The B=8 bf16 decodes' model rates (phase 11's times and counts).
  summary["decodes"] = decode_flops
  for name, d in decode_flops.items():
    log(phase, f"decode {name}: {d['model_flops_per_pixel']:.1f} FLOPs/px, {d['tflop_s']:.3f} "
        f"TFLOP/s, {d['share_of_bf16_peak']:.5f} of the bf16 dense peak  [{smi}]")

  # 4. profiling.trace around one flagship decode: a Chrome trace that names
  # the port's kernels.
  with tempfile.TemporaryDirectory(prefix="chip_smoke_trace_") as logdir:
    with profiling.trace(logdir):
      decode()
    traces = glob_lib.glob(os.path.join(logdir, "*.json"))
    text = ""
    for path in traces:
      with open(path) as f:
        text += f.read()
  named = [k for k in KERNEL_SYMBOLS if k in text]
  summary["trace"] = dict(files=len(traces), bytes=len(text), kernels_named=named)
  log(phase, f"trace of one decode: {len(traces)} file(s), {len(text)} bytes, naming {named}")
  check(named, "the trace of a decode names none of the port's kernels")
  summary["seconds"] = time.time() - t_phase
  summary["launches"] = launches
  log(phase, f"done in {summary['seconds']:.1f} s")
  return summary


# This slice's path: the converted full-width flagship's eval of one image
# with the chain on (phase 21), counted from 0.
TF_CKPT_PATH = ("tf-checkpoint: the eval of one 512x768 image by the full-width flagship "
                "converted from TF-layout variables, SNTC_FUSED_RB_CHAIN=1 (phase 21)")


def tf_checkpoint_phase(image, zero_counts, read_counts, smi, reference):
  """Phase 21: the reference's TF checkpoints imported without TensorFlow.
  The committed fixture (tests/data/tf_ckpt/) read and held to the digests
  of TF's reads, converted through the CLI, its workdir evaluated on the card
  against the CPU; the full-width flagship's TF-layout variables (from the
  seeded params, through the inverse layouts) converted, the params bit for
  bit the seeded ones and the converted model's eval of `image` with the
  chain on bit for bit the seeded model's. Returns the phase's numbers and
  its launches."""
  import hashlib

  import torch
  from shallow_ntc_tpu_torch import configs, eval_lib, train_lib
  from shallow_ntc_tpu_torch import convert_tf_checkpoint as convert_lib
  from shallow_ntc_tpu_torch import params as params_lib
  from shallow_ntc_tpu_torch.models import families
  from shallow_ntc_tpu_torch.ops import rb_chain as rb
  from shallow_ntc_tpu_torch.ops import twolayer_final as tl
  from shallow_ntc_tpu_torch.utils import tf_checkpoint, tf_convert

  phase = "tf-checkpoint"
  t_phase = time.time()
  root = os.path.dirname(os.path.abspath(__file__))
  fixture = os.path.join(root, "tests", "data", "tf_ckpt")
  summary = {"nvidia_smi": smi}

  # 1. The fixture read by the port's reader (crc32c held), every numeric
  # variable equal to TF's read of it (tests/data/tf_ckpt_sha256.json).
  with open(os.path.join(root, "tests", "data", "tf_ckpt_sha256.json")) as f:
    digests = json.load(f)
  prefix = tf_checkpoint.latest_checkpoint(os.path.join(fixture, "train", "checkpoints"))
  t = time.time()
  values = tf_checkpoint.read_variables(prefix)
  read_s = time.time() - t
  got = {name: dict(dtype=str(v.dtype), shape=list(v.shape),
                    sha256=hashlib.sha256(v.tobytes()).hexdigest()) for name, v in values.items()}
  differ = sorted(n for n in set(got) | set(digests) if got.get(n) != digests.get(n))
  summary["fixture"] = dict(variables=len(values), read_s=read_s, differ=differ)
  log(phase, f"fixture {os.path.relpath(prefix, root)}: {len(values)} variables read in "
      f"{read_s:.3f} s (host clock), {len(got) - len(differ)} equal to TF's digests, differing "
      f"{differ}")
  check(not differ and len(got) == len(digests), f"the fixture's variables differ: {differ}")

  with tempfile.TemporaryDirectory(prefix="chip_smoke_tf_") as tmp:
    # 2. The CLI (default --device cuda) in its own process, then the GPU eval
    # of the converted workdir against the CPU eval (the 192x256 crop of phase 5).
    out = os.path.join(tmp, "fixture")
    t = time.time()
    proc = subprocess.run([sys.executable, "-m", "shallow_ntc_tpu_torch.convert_tf_checkpoint",
                           "--workdir_tf", fixture, "--out", out], cwd=root, capture_output=True,
                          text=True, timeout=300)
    cli_s = time.time() - t
    log(phase, f"CLI convert ({cli_s:.1f} s): rc {proc.returncode} {proc.stdout.strip()} "
        f"{proc.stderr.strip()[-400:]}")
    check(proc.returncode == 0, "the converter CLI failed")
    model_gpu, _ = eval_lib.load_latest_ckpt(out, device="cuda")
    model_cpu, _ = eval_lib.load_latest_ckpt(out, device="cpu")
    summary["fixture"]["cli_s"] = cli_s
    summary["fixture"]["reference_launches"] = reference(phase, model_gpu, model_cpu)
    del model_gpu, model_cpu

    # 3. The full-width flagship: its seeded params in the reference's TF
    # layout (deconv kernels flipped and transposed back), converted on the
    # card into a workdir.
    model_config = copy.deepcopy(configs.TWO_LAYER_SYN_RD)
    config = dict(model_family="mshyper", model_config=model_config)
    flat = params_lib.init_params(families.build_model(model_config, "mshyper")[0], 0)
    tf_vars = {}
    for rel, (name, deconv) in convert_lib.build_translation(config, "mshyper").items():
      value = flat[name.replace(".", "/")]
      tf_vars[rel] = tf_convert.conv_transpose_kernel_flax_to_tf(value) if deconv else value
    out = os.path.join(tmp, "flagship")
    t = time.time()
    convert_lib.convert_variables(config, tf_vars, out, "mshyper", "cuda")
    convert_s = time.time() - t
    saved = train_lib.load_newest_checkpoint(train_lib.checkpoint_dir(out))["model"]
    differ = sorted(k for k, v in flat.items()
                    if not np.array_equal(saved[k.replace("/", ".")].numpy(), v))
    n_params = sum(v.size for v in flat.values())
    log(phase, f"flagship: {len(tf_vars)} TF variables ({n_params} params) converted and saved "
        f"in {convert_s:.2f} s; params differing from the seeded ones: {differ}")
    check(not differ and len(saved) == len(flat), f"converted params differ: {differ}")

    # 4. Its eval of one 512x768 f32 image with the chain, counted from 0,
    # bit for bit the seeded model's (eval_lib runs the forward under
    # deterministic cuDNN); then its ms an image by CUDA events.
    converted, _ = eval_lib.load_latest_ckpt(out, device="cuda")
    seeded = eval_lib.build_model(model_config, params=flat, device="cuda")
    with switch_on("SNTC_FUSED_RB_CHAIN"):
      zero_counts()
      rec_conv = list(eval_lib.evaluate_images(converted, image[None]))
      launches = read_counts()
      rec_seed = list(eval_lib.evaluate_images(seeded, image[None]))
      ms = cuda_ms(torch, lambda: list(eval_lib.evaluate_images(converted, image[None])),
                   iters=5, warmup=1)
    # The same pass with the residual blocks as cuDNN convs, for scale (each
    # pass also bisects the prior's offset once).
    cudnn_ms = cuda_ms(torch, lambda: list(eval_lib.evaluate_images(converted, image[None])),
                       iters=5, warmup=1)
    r = rec_conv[0]
    same = json.dumps(rec_conv) == json.dumps(rec_seed)  # float reprs, NaN too
    log(phase, f"converted flagship eval {EVAL_HW[0]}x{EVAL_HW[1]} f32, chain on: bpp "
        f"{r['bpp']:.6f} psnr {r['psnr']:.5f} rd_loss {r['rd_loss']:.5f}; equal to the seeded "
        f"model's bit for bit: {same}; launches {launches}; {ms:.4f} ms a one-image pass "
        f"(CUDA events, mean of 5; chain off {cudnn_ms:.4f})  [{smi}]")
    check(same, f"converted {rec_conv} != seeded {rec_seed}")
    check(all(np.isfinite(r[k]) for k in ("bpp", "psnr", "rd_loss")), "eval not finite")
    check(launches[tl.STATS.name] == 1 and launches[rb.STATS.name] == CHAINS_PER_FORWARD,
          f"the converted eval's launches {launches}")
  summary["flagship"] = dict(params=n_params, convert_s=convert_s, eval=r, eval_ms=ms,
                             eval_ms_chain_off=cudnn_ms, launches=launches)
  summary["launches"] = launches
  summary["seconds"] = time.time() - t_phase
  log(phase, f"done in {summary['seconds']:.1f} s")
  return summary


GRAPH_SGA_CASES = (  # (name, itinf config, transforms dtype, B, steps, timed by default too)
    ("flagship f32 B=1", "itinf", "float32", 1, 200, True),
    ("flagship bf16 B=1", "itinf", "bfloat16", 1, 200, True),
    ("flagship f32 B=8", "itinf", "float32", DECODE_BATCH, 50, False),
    ("factorized f32 B=1", "itinf_factorized", "float32", 1, 200, False))
GRAPH_TRAIN_STEPS = 10
GRAPH_TOL = 1e-5


def graphs_phase(smi):
  """Phase 25: the captured steps (shallow_ntc_tpu_torch/step_graph.py)
  against the eager loops on the card, at full width with seeded weights,
  through measure.sga_dispatch_runs and train_dispatch_runs (each run's
  launch counts start from its own snapshot): SGA of seeded 512x768 images
  (GRAPH_SGA_CASES, TF32 off) and GRAPH_TRAIN_STEPS flagship train steps at
  B=8 256x256 (TF32 on, the train CLI's setting), chain off and on.

  Held under deterministic algorithms (measure.deterministic(): cuDNN's default
  backward-data algorithms sum in any order, so two eager runs differ
  too): the latents, or the params and Adam's moments, bit for bit or
  within GRAPH_TOL; each graph's launches per replay (final_deconv_phase
  once, the chain 7 times when on) and the run's counts equal to the eager
  run's. Timed with the default algorithms, as the CLIs run (the flagship's
  B=1 SGA and the train step without the chain; the others' times are under
  deterministic algorithms): ms a step both ways by CUDA events, the first
  3 steps (warm-up and capture among them) untimed, and the departure of
  graph from eager and of eager from a second eager run. Then a capture
  that cannot run (a .item() in the step) must raise, in a process of its
  own. Returns the numbers."""
  import torch
  from shallow_ntc_tpu_torch import configs, eval_lib, measure, step_graph
  from shallow_ntc_tpu_torch.itinf_lib import TRANSFORMS_DTYPES
  from shallow_ntc_tpu_torch.ops import rb_chain as rb
  from shallow_ntc_tpu_torch.ops import twolayer_final as tl

  phase = "graphs"
  rng = np.random.default_rng(25)
  images = (rng.integers(0, 256, (DECODE_BATCH,) + EVAL_HW + (3,)) / 255.0 - 0.5).astype(
      np.float32)
  out = {"sga": {}, "train": {}}

  def max_diff(a, b):
    return max(float((x.float() - y.float()).abs().max()) for x, y in zip(a, b))

  def held(name, state, runs, expected):
    """Check the deterministic runs' graph against eager; their numbers."""
    got, want = state(runs["graph"]), state(runs["eager"])
    unequal = sum(int((a != b).sum()) for a, b in zip(got, want))
    diff = max_diff(got, want)
    g, e = runs["graph"], runs["eager"]
    log(phase, f"{name}, deterministic algorithms: graph against eager, {unequal} of "
        f"{sum(t.numel() for t in got)} elements differ, max|diff| {diff:.3e} (tol "
        f"{GRAPH_TOL:g}); ms a step eager {e['ms']:.3f}, graph {g['ms']:.3f}; a replay "
        f"launches {g['launches_per_replay']}; the run {g['launches']} (eager "
        f"{e['launches']})  [{smi}]")
    check(diff <= GRAPH_TOL, f"{name}: the captured step departs from the eager one by {diff}")
    check(g["launches_per_replay"] == expected,
          f"{name}: a replay launches {g['launches_per_replay']}, not {expected}")
    check(g["launches"] == e["launches"], f"{name}: the graph run's launches "
          f"{g['launches']} are not the eager run's {e['launches']}")
    return dict(unequal=unequal, max_abs_diff=diff, det_eager_ms=e["ms"], det_graph_ms=g["ms"],
                launches_per_replay=g["launches_per_replay"], launches=g["launches"])

  def timed(name, state, runs):
    """The default-algorithm runs: ms a step, and how far they depart."""
    g, e, e2 = runs["graph"], runs["eager"], runs["eager again"]
    res = dict(eager_ms=e["ms"], graph_ms=g["ms"],
               default_graph_vs_eager=max_diff(state(g), state(e)),
               default_eager_vs_eager=max_diff(state(e2), state(e)))
    log(phase, f"{name}, default algorithms: ms a step eager {e['ms']:.3f}, graph "
        f"{g['ms']:.3f} ({e['ms'] / g['ms']:.2f}x); max|diff| graph against eager "
        f"{res['default_graph_vs_eager']:.3e}, eager against eager "
        f"{res['default_eager_vs_eager']:.3e}  [{smi}]")
    return res

  def latents(r):
    return r["latents"]

  def trained(r):
    return r["params"] + r["mu"] + r["nu"]

  for name, cfg_name, dtype, b, steps, time_default in GRAPH_SGA_CASES:
    config = configs.itinf_config(cfg_name)
    model = eval_lib.build_model(
        dict(config["model_config"], transforms_dtype=TRANSFORMS_DTYPES[dtype]), init_seed=0,
        device="cuda", family=config["model_family"])
    opt_cfg = config["model_config"]["optimizer_config"]
    with measure.deterministic():
      runs = measure.sga_dispatch_runs(model, images[:b], steps, opt_cfg)
    expected = {} if config["model_family"] == "factorized" else {tl.STATS.name: 1}
    label = f"SGA {name}, {steps} steps"
    out["sga"][name] = dict(steps=steps, **held(label, latents, runs, expected))
    if time_default:
      runs = measure.sga_dispatch_runs(model, images[:b], steps, opt_cfg)
      runs["eager again"] = measure.sga_dispatch_runs(model, images[:b], steps, opt_cfg,
                                                      dispatches=("eager",))["eager"]
      out["sga"][name].update(timed(label, latents, runs))
    del model, runs
    torch.cuda.empty_cache()

  batch_rng = np.random.default_rng(26)
  batches = [batch_rng.uniform(-0.5, 0.5, (TRAIN_BATCH, TRAIN_HW, TRAIN_HW, 3)).astype(np.float32)
             for _ in range(GRAPH_TRAIN_STEPS)]
  model_config = configs.TRAIN_CONFIGS["two_layer_syn_rd"]["model_config"]
  tf32 = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
  torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = True
  try:
    for chain in (False, True):
      name = f"train chain {'on' if chain else 'off'}"
      label = f"{name}, B={TRAIN_BATCH} {TRAIN_HW}x{TRAIN_HW}, TF32 on, {GRAPH_TRAIN_STEPS} steps"
      expected = {tl.STATS.name: 1, **({rb.STATS.name: CHAINS_PER_FORWARD} if chain else {})}
      with switch_on("SNTC_FUSED_RB_CHAIN") if chain else contextlib.nullcontext():
        with measure.deterministic():
          runs = measure.train_dispatch_runs(model_config, batches, "cuda")
        out["train"][name] = dict(steps=GRAPH_TRAIN_STEPS, **held(label, trained, runs, expected))
        if not chain:
          runs = measure.train_dispatch_runs(model_config, batches, "cuda")
          runs["eager again"] = measure.train_dispatch_runs(model_config, batches, "cuda",
                                                            dispatches=("eager",))["eager"]
          out["train"][name].update(timed(label, trained, runs))
      del runs
      torch.cuda.empty_cache()
  finally:
    torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = tf32

  proc = step_graph.run_capture_failure(os.path.dirname(os.path.abspath(__file__)))
  log(phase, f"a step that waits for the card (.item()) under capture: exit {proc.returncode}, "
      f"{(proc.stdout.strip() or proc.stderr.strip()[-400:])}")
  check(proc.returncode == 0 and proc.stdout.startswith("raised:"),
        "a capture that cannot run did not raise")
  out["capture_failure"] = proc.stdout.strip()
  return out


def main():
  import torch
  if not torch.cuda.is_available():
    print("chip_smoke: CUDA is not available", file=sys.stderr)
    return 1
  try:
    from shallow_ntc_tpu_torch import configs, eval_lib, train_lib
    from shallow_ntc_tpu_torch import dataio
    from shallow_ntc_tpu_torch.codec import bindings as rans
    from shallow_ntc_tpu_torch.ops import cuda_build
    from shallow_ntc_tpu_torch.ops import fast_deconv as fd
    from shallow_ntc_tpu_torch.ops import jpegl_decode as jd
    from shallow_ntc_tpu_torch.ops import rb_chain as rb
    from shallow_ntc_tpu_torch.ops import resblock
    from shallow_ntc_tpu_torch.ops import twolayer_final as tl
    from shallow_ntc_tpu_torch.utils import profiling
  except ImportError as e:
    print(f"chip_smoke: the port is not beside this script ({e})", file=sys.stderr)
    return 1
  import torch.nn.functional as F

  # --- 1. build ------------------------------------------------------------
  t = time.time()
  sources = sorted({tl.SOURCE, rb.SOURCE, resblock.SOURCE, jd.SOURCE})
  with concurrent.futures.ThreadPoolExecutor(len(sources) + 2) as pool:
    librans = pool.submit(rans.build)
    libloader = pool.submit(dataio.build)
    built = list(pool.map(cuda_build.build, sources))
    built += [librans.result(), libloader.result()]
  for source, so in zip(sources + ["codec/rans.cc (g++)", "dataio/loader.cc (g++)"], built):
    log("build", f"{source} -> {so}")
  log("build", f"{len(sources)} CUDA sources, the rANS coder and the image loader built in "
      f"parallel in {time.time() - t:.1f}s")
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

  # fused_rb_chain_padded(keep_pad=True), through the public entry, at the
  # encoder's first-stage shape and at H != W with N=2 (a residual read at
  # the padded index would show): the interior bit for bit the dense
  # kernel's output and within the chain's tolerance of the plain version
  # (the dense chain, zero-padded), the pad columns 0, one launch a chain;
  # keep_pad=False the dense kernel's output bit for bit. A generator of its
  # own, so that the later phases draw their data as before.
  pad_launches = 0
  for case in (rb_train, (2, 17, 9, 192, 2)):
    b, h, w, c, n = case
    params = rb_params(n, c, seed=sum(case))
    x32 = torch.from_numpy(np.random.default_rng(sum(case) + 1).standard_normal(
        (b, h, w, c), np.float32)).to(dev)
    for dtype in (torch.float32, torch.bfloat16):
      x = x32.to(dtype)
      torch.cuda.synchronize()
      before = rb.STATS.launches
      out = rb.fused_rb_chain_padded(x, params, True)
      torch.cuda.synchronize()
      launched = rb.STATS.launches - before
      pad_launches += launched
      dense = rb.rb_chain_cuda(x, params)
      plain = rb.pad_width(rb.dense_rb_chain(x, params), n)
      torch.cuda.synchronize()
      inner = out[:, :, n : n + w]
      err = (out.float() - plain.float()).abs().max().item()
      scale = plain.float().abs().max().item()
      tol = (1e-4 if dtype == torch.float32 else 2e-2) * scale
      zeros = not out[:, :, :n].any().item() and not out[:, :, n + w :].any().item()
      same, unpadded = torch.equal(inner, dense), torch.equal(
          rb.fused_rb_chain_padded(x, params, False), dense)
      log("kernels", f"fused_rb_chain_padded keep_pad B={b} {h}x{w} C={c} N={n} {dtype}: "
          f"{tuple(out.shape)}, max|err| {err:.3e} (tol {tol:.3e}, max|y| {scale:.3f}); pad "
          f"columns zero {zeros}; interior bit for bit the dense kernel's {same}; "
          f"keep_pad=False bit for bit {unpadded}; launches {launched}")
      check(out.shape == plain.shape and err <= tol and zeros and same and unpadded
            and launched == 1, f"fused_rb_chain_padded disagrees at {case} {dtype}")
      errs[("fused_rb_chain_padded", case, dtype)] = err

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
  adam_errs = adam_check("train-reference", train_cfg["model_config"], opt_cfg)

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
  # The full-width train step, chain kernel off and on, in 8 turns (off, on,
  # on, off, twice), each the mean of 8 steps by CUDA events after 2 warm-up
  # steps; at TF32 off, then at TF32 on (cuDNN's and the matmuls', as the train
  # CLI's default --matmul_precision sets them), the flags restored after.
  t_model, _ = train_lib.build_model(train_cfg["model_config"], init_seed=0, device="cuda")
  t_state, lr_fn = train_lib.create_train_state(t_model, opt_cfg)
  t_step = train_lib.make_train_step(t_model, t_state.optimizer, lr_fn)
  t_batch = torch.from_numpy((rng.integers(0, 256, (TRAIN_BATCH, TRAIN_HW, TRAIN_HW, 3))
                              / 255.0 - 0.5).astype(np.float32)).to(dev)
  step_ms = {"off": [], "on": []}
  step_ms_tf32 = {"off": [], "on": []}
  tf32_flags = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
  for tf32, times in ((False, step_ms), (True, step_ms_tf32)):
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = tf32
    try:
      for way in ("off", "on", "on", "off") * 2:
        with switch_on("SNTC_FUSED_RB_CHAIN") if way == "on" else contextlib.nullcontext():
          times[way].append(cuda_ms(torch, lambda: t_step(t_state, t_batch), iters=8, warmup=2))
    finally:
      torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = tf32_flags
  zero_counts()
  with switch_on("SNTC_FUSED_RB_CHAIN"):
    t_step(t_state, t_batch)
  step_counts = read_counts()
  check(step_counts[rb.STATS.name] == CHAINS_PER_FORWARD and step_counts[tl.STATS.name] >= 1,
        f"one train step launched {step_counts}")
  train_step_ms = {k: float(np.mean(v)) for k, v in step_ms.items()}
  train_step_ms_tf32 = {k: float(np.mean(v)) for k, v in step_ms_tf32.items()}
  for what, times in (("f32, TF32 off", step_ms), ("f32, TF32 on", step_ms_tf32)):
    log("timing", f"train step B={TRAIN_BATCH} {TRAIN_HW}x{TRAIN_HW} {what}: chain kernel off "
        + " / ".join(f"{x:.3f}" for x in times["off"]) + " ms, on "
        + " / ".join(f"{x:.3f}" for x in times["on"]) + f" ms (off {np.mean(times['off']):.3f}, "
        f"on {np.mean(times['on']):.3f}: on/off {np.mean(times['on']) / np.mean(times['off']):.4f}; "
        f"spread max/min off {max(times['off']) / min(times['off']):.4f}, on "
        f"{max(times['on']) / min(times['on']):.4f})  [{smi}]")
  log("timing", f"one step launches {step_counts}")
  # The optimizer A/B at the train CLI's TF32 on, chain off (how
  # scripts/torch_rd_run.py trains): train_lib.Adam's multi-tensor update
  # against the per-parameter loop it replaced.
  torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = True
  try:
    adam_ms = optimizer_ab(torch, t_state, t_step, t_batch)
  finally:
    torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = tf32_flags
  train_step_ms_adam = {k: float(np.mean(v)) for k, v in adam_ms.items()}
  log("timing", f"train step B={TRAIN_BATCH} {TRAIN_HW}x{TRAIN_HW} f32, TF32 on, chain kernel "
      "off: Adam multi-tensor " + " / ".join(f"{x:.3f}" for x in adam_ms["multi"])
      + " ms, per-parameter " + " / ".join(f"{x:.3f}" for x in adam_ms["loop"])
      + f" ms (multi {train_step_ms_adam['multi']:.3f}, per-parameter "
      f"{train_step_ms_adam['loop']:.3f}: multi/per-parameter "
      f"{train_step_ms_adam['multi'] / train_step_ms_adam['loop']:.4f}; spread max/min multi "
      f"{max(adam_ms['multi']) / min(adam_ms['multi']):.4f}, per-parameter "
      f"{max(adam_ms['loop']) / min(adam_ms['loop']):.4f})  [{smi}]")
  del t_model, t_state, t_step, t_batch

  def time_rb(case, dtype, keep_pad=False, gen=None):
    b, h, w, c, n = case
    params = rb_params(n, c, seed=sum(case))
    x = torch.from_numpy((gen or rng).standard_normal((b, h, w, c), np.float32)).to(dev, dtype)
    pad = n if keep_pad else 0
    fn = ((lambda: resblock.fused_resblock_cuda(x, *params[0])) if n == 1
          else (lambda: rb.rb_chain_cuda(x, params, keep_pad)))
    ms = cuda_ms(torch, fn, iters=10, warmup=2, host_ahead=True)
    plain = cuda_ms(torch, lambda: rb.pad_width(rb.dense_rb_chain(x, params), pad), iters=10,
                    warmup=2, host_ahead=True)
    bound, by = rb_chain_bound_ms(x, n, str(dtype).split(".")[-1], pad)
    name = ("fused_resblock" if n == 1 else "fused_rb_chain_padded" if keep_pad
            else "fused_rb_chain")
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
  pad_gen = np.random.default_rng(25)
  pad_t = {k: time_rb(rb_train, dtype, keep_pad=True, gen=pad_gen) for k, dtype in (
      ("train f32", torch.float32), ("train bf16", torch.bfloat16))}

  pixels = DECODE_BATCH * EVAL_HW[0] * EVAL_HW[1]
  decode_ms = cuda_ms(torch, decode, iters=20, warmup=3)
  log("timing", f"decode B={DECODE_BATCH} {EVAL_HW[0]}x{EVAL_HW[1]} bf16: {decode_ms:.4f} ms, "
      f"{pixels / decode_ms / 1e3:.2f} Mpx/s  [{smi}]")
  decode_flops = {}

  def model_rate(name, fn, ms):
    """The decode's model FLOPs (profiling.get_flops of one call, on the
    card) and their rate at `ms` a decode, beside the bf16 dense peak."""
    flops = profiling.get_flops(fn)
    rate = flops / (ms * 1e-3)
    decode_flops[name] = dict(ms=ms, model_flops=flops, model_flops_per_pixel=flops / pixels,
                              tflop_s=rate / 1e12,
                              share_of_bf16_peak=rate / H100_PEAK_FLOPS["bfloat16"])
    log("timing", f"decode {name} B={DECODE_BATCH} {EVAL_HW[0]}x{EVAL_HW[1]} bf16: "
        f"{flops / 1e9:.4f} model GFLOP ({flops / pixels:.1f} a pixel) in {ms:.4f} ms: "
        f"{rate / 1e12:.3f} TFLOP/s, {rate / H100_PEAK_FLOPS['bfloat16']:.5f} of the "
        f"{H100_PEAK_FLOPS['bfloat16'] / 1e12:.0f} TFLOP/s bf16 dense peak  [{smi}]")

  model_rate("two_layer_syn_rd", decode, decode_ms)

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
    model_rate(name, decode_jpegl, jl_decode_ms[name])
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
    model_rate(name, fn, ms)
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

  # --- 17. experiments: the config-script CLIs, warm start, PNGs, eval -----
  # Its directory stays until phase 22 has read its workdirs.
  exp_tmp = tempfile.TemporaryDirectory()
  experiments = experiments_phase(smi, exp_tmp.name)

  # --- 18. parallel: DDP (gloo, NCCL), the height-split eval and codec -----
  parallel = parallel_phase(images[0], zero_counts, read_counts, smi,
                            eval_ways["once per pass"])

  # --- 19. image-input: JPEG decode, the native loader, cocotrain ----------
  image_input = image_input_phase(zero_counts, read_counts, smi, train_step_ms)

  # --- 20. flops: model FLOPs counted on the card, the decodes' rates -----
  flops = flops_phase(images[0], zero_counts, read_counts, smi, decode, decode_flops)

  # --- 21. tf-checkpoint: the reference's TF checkpoints, no TensorFlow ---
  tf_ckpt = tf_checkpoint_phase(images[0], zero_counts, read_counts, smi, reference)

  # --- 22. rd-pipeline: the R-D result tools on phase 17's workdirs -------
  rd = rd_pipeline_phase(experiments, small, smi)
  exp_tmp.cleanup()

  # --- 23. measure: the measurement CLIs, the 2048x1536 codec -------------
  meas = measure_phase(smi)
  # The kernels at this slice's new shapes against their plain versions,
  # then timed: final_deconv_phase at the 2048x1536 codec's B=1 f32 mid and
  # at SGA's B=8 f32 step (phase 12's 512x768 at B=8), the chain at the
  # 2048x1536 analysis's first stage (B=1 1024x768 C=192 N=3 f32).
  fd_codec_hr = (1, MEASURE_HW[0] // 16, MEASURE_HW[1] // 16, torch.float32, 5, 12, 3)
  fd_itinf_b8 = (DECODE_BATCH, mh, mw, torch.float32, 5, 12, 3)
  rb_codec_hr = (1, MEASURE_HW[0] // 2, MEASURE_HW[1] // 2, 192, 3)
  hr_rng = np.random.default_rng(23)
  for case in (fd_codec_hr, fd_itinf_b8):
    mid, kern, bias = final_inputs(*case, gen=hr_rng)
    out = tl.final_deconv_cuda(mid, kern, bias, 12)
    ref = tl.final_deconv_plain(mid, kern, bias, 12)
    torch.cuda.synchronize()
    err = (out - ref).abs().max().item()
    log("measure", f"final_deconv_phase B={case[0]} {case[1]}x{case[2]} f32: max|err| {err:.3e} "
        f"(tol 1e-4), {mid.numel()} mid values (the wrapper refuses 2**31)")
    check(out.shape == ref.shape and err <= 1e-4, f"final_deconv_phase disagrees: {err}")
    errs[("final_deconv_phase", case)] = err
  params_hr = rb_params(3, 192, seed=sum(rb_codec_hr))
  x_hr = torch.from_numpy(hr_rng.standard_normal(rb_codec_hr[:4], np.float32)).to(dev)
  out = rb.rb_chain_cuda(x_hr, params_hr)
  ref = rb.dense_rb_chain(x_hr, params_hr)
  torch.cuda.synchronize()
  err = (out - ref).abs().max().item()
  scale = ref.abs().max().item()
  log("measure", f"fused_rb_chain B=1 {rb_codec_hr[1]}x{rb_codec_hr[2]} C=192 N=3 f32: max|err| "
      f"{err:.3e} (tol {1e-4 * scale:.3e}, max|y| {scale:.3f}); "
      f"{rb_codec_hr[0] * -(-rb_codec_hr[1] // 8) * -(-rb_codec_hr[2] // 8)} CTAs of 8x8 pixels")
  check(out.shape == ref.shape and err <= 1e-4 * scale, f"fused_rb_chain disagrees: {err}")
  errs[("fused_rb_chain", rb_codec_hr, torch.float32)] = err
  del x_hr, out, ref
  # The chain at the encode's three chain stages in bench_suite and the
  # roofline (B=8 512x768 bf16: 256x384, 128x192 and 64x96 at C=192), at
  # phase 3's bf16 tolerance.
  rb_encode = [(DECODE_BATCH, EVAL_HW[0] // s, EVAL_HW[1] // s, 192, 3) for s in (2, 4, 8)]
  for case in rb_encode:
    params = rb_params(3, 192, seed=sum(case))
    x = torch.from_numpy(hr_rng.standard_normal(case[:4], np.float32)).to(dev, torch.bfloat16)
    out = rb.rb_chain_cuda(x, params)
    ref = rb.dense_rb_chain(x, params)
    torch.cuda.synchronize()
    err = (out.float() - ref.float()).abs().max().item()
    scale = ref.float().abs().max().item()
    log("measure", f"fused_rb_chain B={case[0]} {case[1]}x{case[2]} C=192 N=3 bf16 (encode): "
        f"max|err| {err:.3e} (tol {2e-2 * scale:.3e}, max|y| {scale:.3f})")
    check(out.shape == ref.shape and err <= 2e-2 * scale, f"fused_rb_chain disagrees: {err}")
    errs[("fused_rb_chain", case, torch.bfloat16)] = err
  del x, out, ref
  torch.cuda.empty_cache()
  codec_hr_t = dict(time_final(*fd_codec_hr[:4]), max_abs_err=errs[("final_deconv_phase",
                                                                     fd_codec_hr)])
  itinf_b8_t = dict(time_final(*fd_itinf_b8[:4]), max_abs_err=errs[("final_deconv_phase",
                                                                     fd_itinf_b8)])
  chain_t[f"codec {rb_codec_hr[1]}x{rb_codec_hr[2]} C=192 f32"] = time_rb(rb_codec_hr,
                                                                         torch.float32)
  chain_t[f"encode {rb_encode[0][1]}x{rb_encode[0][2]} C=192 bf16"] = time_rb(rb_encode[0],
                                                                             torch.bfloat16)

  # --- 24. rd-sweep: the R-D sweep script, a factorized and a flagship point
  with tempfile.TemporaryDirectory() as sweep_tmp:
    sweep = rd_sweep_phase(smi, sweep_tmp)
  by_stage = sweep["flagship"]["launches_by_stage"]

  # --- 25. graphs: the captured SGA and train steps against the eager ones -
  graphs = graphs_phase(smi)

  codec_fd = sum(codec_counts[k][tl.STATS.name]
                 for k in ("flagship_compress", "flagship_decompress"))
  codec_k16 = sum(codec_counts[k][jd.STATS.name] for k in ("k16_compress", "k16_decompress"))
  itinf_fd = itinf["launches"][tl.STATS.name]
  kernels = [dict(
      name=tl.STATS.name, route="cuda",
      source="shallow_ntc_tpu_torch/csrc/final_deconv.cu",
      replaces="shallow_ntc_tpu/ops/pallas/twolayer_final.py:273",
      launches=sweep["flagship"]["launches"][tl.STATS.name], path=RD_SWEEP_PATH,
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
      codec_2048x1536_shape=dict(
          shape=f"B=1 mid {fd_codec_hr[1]}x{fd_codec_hr[2]}x768 f32 (the 2048x1536 codec)",
          **codec_hr_t),
      itinf_b8_f32_shape=dict(shape=f"B={DECODE_BATCH} mid {mh}x{mw}x768 f32 (SGA step at B=8)",
                              **itinf_b8_t),
      decode_mpx_per_s=pixels / decode_ms / 1e3)]
  # Launches: this slice's path is the flagship R-D point's stages (phase
  # 24, each process counted from 0): "launches" of final_deconv_phase and
  # fused_rb_chain. fused_resblock and jpegl_synthesize, which it does not
  # run, keep phase 20's counted forwards ("path" says which). The earlier
  # slices' paths beside them: the measurement CLIs' GPU processes (phase
  # 23, "measure <process>"), the R-D result tools' GPU processes (phase 22,
  # "rd-pipeline <process>"), the converted full-width flagship's eval with
  # the chain (phase 21, "tf-checkpoint <path>"), phase 20's counted
  # forwards ("flops <path>"), the image input (phase
  # 19: the train CLI of two_layer_syn.py on JPEGs, in its own process, and
  # the native branch's train steps, "image-input <path>"), the multi-device paths (phase
  # 18: the split evals, both DDP ranks, the NCCL rank and the 2-strip
  # codec as "parallel <path>"; the runs they are held against (the
  # one-process run of the same steps, the DDP control, the codec CLI at
  # --spatial_devices 1) as "reference <run>"), the experiment workflow (phase
  # 17, each CLI in its own process), the int8 decode and eval (phase 15)
  # and ElicSynthesis with the chain on (phase 16), SGA (phase 12), the
  # codec of phase 6 (one compress and one decompress of image 0, a compress
  # with the chain, the JPEGL_K16 round trip), the training run of phase 7
  # (4 steps and the final eval), the eval of image 0 with
  # SNTC_FUSED_RESBLOCK=1 (fused_resblock's own path, phase 4), the K16 eval
  # of phase 9. The chain's times are at train stage 1 in f32.
  kernels[0]["launches_by_path"] = {
      **{f"rd-sweep flagship {k}": v[tl.STATS.name] for k, v in by_stage.items()},
      **{f"measure {k}": v[tl.STATS.name] for k, v in meas["launches_by_process"].items()},
      **{f"rd-pipeline {k}": v[tl.STATS.name] for k, v in rd["launches_by_process"].items()},
      "tf-checkpoint flagship eval": tf_ckpt["launches"][tl.STATS.name],
      "tf-checkpoint fixture GPU eval": tf_ckpt["fixture"]["reference_launches"][tl.STATS.name],
      **{f"flops {k}": v[tl.STATS.name] for k, v in flops["launches"].items()},
      **{f"image-input {k}": v[tl.STATS.name] for k, v in image_input["launches"].items()},
      **{f"experiments {k}": v[tl.STATS.name] for k, v in (
          ("train", experiments["train"]["launches"]), ("itinf", experiments["itinf"]["launches"]),
          ("eval", experiments["eval"]["launches"]))},
      "int8": int8["final_deconv_launches"],
      "itinf": itinf_fd, "itinf bf16": itinf["bf16_launches"][tl.STATS.name],
      "codec": codec_fd, "eval+decode": launches, "train": train_counts[tl.STATS.name],
      **{f"two_layer_syn2 {k}": v for k, v in fam_launches["two_layer_syn2"].items()},
      **{f"parallel {k}": v[tl.STATS.name] for k, v in parallel["launches"].items()},
      **{f"reference {k}": v[tl.STATS.name] for k, v in parallel["reference_launches"].items()},
      **{f"graphs {k}": v["launches"].get(tl.STATS.name, 0)
         for k, v in {**graphs["sga"], **graphs["train"]}.items()}}
  kernels[0]["family_decodes"] = fam_decode
  kernels[0]["factorized"] = fact
  kernels[0]["int8"] = int8
  kernels[0]["inference_extras"] = extras
  kernels[0]["experiments"] = experiments
  kernels[0]["parallel"] = parallel
  kernels[0]["image_input"] = image_input
  kernels[0]["flops"] = flops
  kernels[0]["tf_checkpoint"] = tf_ckpt
  kernels[0]["rd_pipeline"] = rd
  kernels[0]["measure"] = meas
  kernels[0]["rd_sweep"] = sweep
  kernels[0]["graphs"] = graphs
  kernels.append(dict(
      name=rb.STATS.name, route="cuda", source="shallow_ntc_tpu_torch/csrc/rb_chain.cu",
      replaces="shallow_ntc_tpu/ops/pallas/rb_chain.py:263",
      launches=sweep["flagship"]["launches"][rb.STATS.name], path=RD_SWEEP_PATH,
      launches_by_path={**{f"rd-sweep flagship {k}": v[rb.STATS.name]
                           for k, v in by_stage.items()},
                        **{f"measure {k}": v[rb.STATS.name]
                           for k, v in meas["launches_by_process"].items()},
                        "measure latents vs cpu": meas["latents_vs_cpu"]["chain_launches"],
                        **{f"graphs {k}": v["launches"].get(rb.STATS.name, 0)
                           for k, v in graphs["train"].items()},
                        **{f"rd-pipeline {k}": v[rb.STATS.name]
                           for k, v in rd["launches_by_process"].items()},
                        "tf-checkpoint flagship eval": tf_ckpt["launches"][rb.STATS.name],
                        **{f"flops {k}": v[rb.STATS.name] for k, v in flops["launches"].items()},
                        **{f"image-input {k}": v[rb.STATS.name]
                           for k, v in image_input["launches"].items()},
                        "experiments train": experiments["launches"][rb.STATS.name],
                        "ElicSynthesis": extras["chain_launches"],
                        "int8 encode precedence": int8["chain_launches"],
                        "itinf": itinf["launches"][rb.STATS.name],
                        "codec": codec_counts["chain_compress"][rb.STATS.name],
                        "train": train_counts[rb.STATS.name],
                        **{f"parallel {k}": v[rb.STATS.name]
                           for k, v in parallel["launches"].items()},
                        **{f"reference {k}": v[rb.STATS.name]
                           for k, v in parallel["reference_launches"].items()}},
      **chain_t["train f32"], other_shapes={k: v for k, v in chain_t.items() if k != "train f32"}))
  kernels.append(dict(
      name=resblock.STATS.name, route="cuda", source="shallow_ntc_tpu_torch/csrc/rb_chain.cu",
      replaces="shallow_ntc_tpu/ops/pallas/resblock.py:202",
      launches=sum(v[resblock.STATS.name] for v in flops["launches"].values()), path=FLOPS_PATH,
      launches_by_path={**{f"flops {k}": v[resblock.STATS.name]
                           for k, v in flops["launches"].items()},
                        "eval image 0": ways["resblock"][1][resblock.STATS.name]},
      **block_t["train f32"], other_shapes={"train bf16": block_t["train bf16"]}))
  kernels[1]["train_step_ms"] = train_step_ms
  kernels[1]["train_step_ms_tf32"] = train_step_ms_tf32
  kernels[0]["train_step_ms_adam"] = train_step_ms_adam
  kernels[0]["adam_max_abs_diff"] = adam_errs
  kernels[0]["itinf_step_ms"] = itinf["step_ms"]
  # jpegl_synthesize's times at the decode shape (B=8 bf16), the eval shape
  # beside them. ms is the device time of the kernel alone: weights and bias
  # in z's type.
  kernels.append(dict(
      name=jd.STATS.name, route="cuda", source="shallow_ntc_tpu_torch/csrc/jpegl_decode.cu",
      replaces="shallow_ntc_tpu/ops/pallas/jpegl_decode.py:75",
      launches=sum(v[jd.STATS.name] for v in flops["launches"].values()), path=FLOPS_PATH,
      max_abs_err=errs[("jpegl_synthesize", jl_decode)], **jl_decode_t,
      shape=f"B={DECODE_BATCH} z {mh}x{mw}x320 bf16 (decode)",
      eval_shape=dict(shape=f"B=1 z {mh}x{mw}x320 f32 (eval)",
                      max_abs_err=errs[("jpegl_synthesize", jl_eval)], **jl_eval_t),
      launches_by_path={**{f"flops {k}": v[jd.STATS.name] for k, v in flops["launches"].items()},
                        "codec K16": codec_k16, "eval K16": jpegl_eval_launches,
                        "decode K16": jl_decode_launches["JPEGL_K16"]},
      decode_mpx_per_s={k: pixels / v / 1e3 for k, v in jl_decode_ms.items()}))
  # fused_rb_chain_padded(keep_pad=True): the same kernel, its last block
  # storing into the padded output. No path of the port calls it (nor of the
  # JAX package: its only caller is tests/test_pallas.py), so its launches
  # are those of phase 3's check through the public entry, one a chain.
  kernels.append(dict(
      name="fused_rb_chain_padded", route="cuda", source="shallow_ntc_tpu_torch/csrc/rb_chain.cu",
      replaces="shallow_ntc_tpu/ops/pallas/rb_chain.py:263",
      function="shallow_ntc_tpu/ops/pallas/rb_chain.py:175 (keep_pad=True)",
      launches=pad_launches, path="kernels: fused_rb_chain_padded(x, params, True) at B=8 "
      "128x128 C=192 N=3 and B=2 17x9 C=192 N=2, f32 and bf16 (no model path calls keep_pad)",
      **pad_t["train f32"], other_shapes={"train bf16": pad_t["train bf16"]}))
  print(json.dumps({"kernels": kernels}), flush=True)
  print(smi, flush=True)
  print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                           "count": torch.cuda.device_count()}}), flush=True)
  return 0


if __name__ == "__main__":
  sys.exit(main())
