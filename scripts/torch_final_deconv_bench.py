#!/usr/bin/env python3
"""The final-deconv kernel (csrc/final_deconv.cu) alone on one NVIDIA GPU.

  python3 scripts/torch_final_deconv_bench.py [--quick | --time_only]

Builds the source with nvcc (printing ptxas's registers, shared memory and
spills per instantiation), holds the kernel against the plain version
(final_deconv_plain) at ragged shapes, both dtypes, and times it at the
main paths' shapes: the flagship decode (B=8 mid 32x48 bf16), eval (B=1
mid 32x48 f32) and training (B=8 mid 16x16 f32). Device time by CUDA
events, the device held busy (torch.cuda._sleep) until the host has queued
every call; the time of a call as a caller waits for it beside it. The
timed calls pass weights and bias in the input's type, as the model's
parameters are. --quick stops after the checks; --time_only skips the
ptxas report and the checks. Run from another checkout's root (a copy of
this script beside its package), it times that checkout's kernel. One JSON
line of the times at the end, beside the card's name and power limit from
nvidia-smi.
"""

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
from shallow_ntc_tpu_torch.ops import cuda_build  # noqa: E402
from shallow_ntc_tpu_torch.ops import twolayer_final as tl  # noqa: E402

H100_BYTES_PER_S = 3.35e12  # HBM3, NVIDIA data sheet (SXM)
# (B, H, W, dtype, k, c_in, c_out): W no multiple of the kernel's 8 phase
# columns, W = 1, H = 1, B = 1, k = 3, 5 and 7 (the d = -2 halo), c_in 12, 5
# (bf16 in 2-byte pieces), 6 and 16, c_out 3, 4, 5 and 8 (two GEMM passes).
CHECKS = ((1, 32, 48, torch.float32, 5, 12, 3), (8, 32, 48, torch.bfloat16, 5, 12, 3),
          (3, 5, 7, torch.float32, 5, 12, 3), (2, 3, 4, torch.float32, 7, 12, 3),
          (1, 1, 1, torch.bfloat16, 5, 12, 3), (2, 3, 9, torch.bfloat16, 7, 12, 3),
          (1, 2, 11, torch.float32, 3, 12, 3), (2, 3, 5, torch.float32, 5, 5, 5),
          (2, 3, 5, torch.bfloat16, 5, 5, 5), (1, 2, 10, torch.bfloat16, 3, 16, 8),
          (3, 1, 17, torch.float32, 7, 16, 3), (2, 2, 9, torch.bfloat16, 5, 6, 4),
          (1, 2, 9, torch.float32, 5, 6, 4), (8, 16, 16, torch.float32, 5, 12, 3))
TIMES = (("decode", 8, 32, 48, torch.bfloat16), ("eval", 1, 32, 48, torch.float32),
         ("train", 8, 16, 16, torch.float32))


def device_ms(fn, iters=50, warmup=5):
  for _ in range(warmup):
    fn()
  torch.cuda.synchronize()
  t = time.time()
  fn()
  torch.cuda.synchronize()
  torch.cuda._sleep(int(((time.time() - t) * iters * 1.5 + 2e-3) * 2e9))
  start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
  start.record()
  for _ in range(iters):
    fn()
  end.record()
  end.synchronize()
  return start.elapsed_time(end) / iters


def call_ms(fn, iters=50, warmup=5):
  for _ in range(warmup):
    fn()
  torch.cuda.synchronize()
  start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
  start.record()
  for _ in range(iters):
    fn()
  end.record()
  end.synchronize()
  return start.elapsed_time(end) / iters


def inputs(rng, b, h, w, dtype, k=5, c_in=12, c_out=3, dev="cuda"):
  mid = torch.from_numpy(rng.standard_normal((b, h, w, 64 * c_in), np.float32))
  kern = torch.from_numpy(rng.standard_normal((k, k, c_in, c_out), np.float32) * 0.1)
  bias = torch.from_numpy(rng.standard_normal((c_out,), np.float32) * 0.1)
  return mid.to(dev, dtype), kern.to(dev, dtype), bias.to(dev)


def main():
  ap = argparse.ArgumentParser()
  ap.add_argument("--quick", action="store_true")
  ap.add_argument("--time_only", action="store_true",
                  help="skip the ptxas report and the checks (A/B runs)")
  args = ap.parse_args()
  if not torch.cuda.is_available():
    print("needs an NVIDIA GPU", file=sys.stderr)
    return 1
  torch.backends.cudnn.allow_tf32 = False
  torch.backends.cuda.matmul.allow_tf32 = False
  smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                       capture_output=True, text=True).stdout.strip()
  print(f"{torch.cuda.get_device_name(0)}; nvidia-smi: {smi}; torch {torch.__version__}",
        flush=True)
  t = time.time()
  if not args.time_only:
    with tempfile.TemporaryDirectory() as tmp:
      probe = subprocess.run([cuda_build.find_nvcc(), *cuda_build.NVCC_FLAGS, "-Xptxas", "-v",
                              "-o", os.path.join(tmp, "probe.so"),
                              os.path.join(cuda_build.CSRC_DIR, tl.SOURCE)],
                             capture_output=True, text=True)
    for line in probe.stderr.splitlines():
      if "registers" in line or "spill" in line or "Compiling entry" in line:
        print("ptxas:", line.strip())
    if probe.returncode:
      print(probe.stderr, file=sys.stderr)
      return 1
  cuda_build.load(tl.SOURCE)
  print(f"build {time.time() - t:.1f}s", flush=True)

  ok = True
  rng = np.random.default_rng(0)
  for b, h, w, dtype, k, c_in, c_out in () if args.time_only else CHECKS:
    mid, kern, bias = inputs(rng, b, h, w, dtype, k, c_in, c_out)
    out = tl.final_deconv_cuda(mid, kern, bias, c_in)
    ref = tl.final_deconv_plain(mid, kern, bias, c_in)
    torch.cuda.synchronize()
    err = (out.float() - ref.float()).abs().max().item()
    scale = ref.float().abs().max().item()
    tol = 1e-4 if dtype == torch.float32 else 2e-2 * scale
    good = out.shape == ref.shape and err <= tol
    ok &= good
    print(f"check B={b} {h}x{w} k={k} c_in={c_in} c_out={c_out} {dtype}: max|err| {err:.3e} "
          f"(tol {tol:.3e}, max|y| {scale:.3f}) {'ok' if good else 'FAIL'}", flush=True)
  if not ok or args.quick:
    return 0 if ok else 1

  times = {}
  for name, b, h, w, dtype in TIMES:
    mid, kern, bias = inputs(rng, b, h, w, dtype)
    bias = bias.to(dtype)  # weights and bias in the input's type, as the model's are
    n_bytes = mid.element_size() * (2 * mid.numel() + kern.numel() + 3)  # out has mid's size
    ms = device_ms(lambda: tl.final_deconv_cuda(mid, kern, bias, 12))
    call = call_ms(lambda: tl.final_deconv_cuda(mid, kern, bias, 12))
    bound = n_bytes / H100_BYTES_PER_S * 1e3
    key = f"{name} B={b} mid {h}x{w} {str(dtype).split('.')[-1]}"
    times[key] = dict(ms=ms, call_ms=call, bytes_bound_ms=bound)
    print(f"time {key}: kernel {ms:.5f} ms (a call {call:.5f} ms), bytes bound {bound:.5f} ms "
          f"({bound / ms:.1%} of it)  [{smi}]", flush=True)
  print(json.dumps({"final_deconv_ms": times, "device": smi}), flush=True)
  return 0


if __name__ == "__main__":
  sys.exit(main())
