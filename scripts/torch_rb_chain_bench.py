#!/usr/bin/env python3
"""The residual-block kernel (csrc/rb_chain.cu) alone on one NVIDIA GPU.

  python3 scripts/torch_rb_chain_bench.py [--quick | --time_only]

Builds the source with nvcc (printing ptxas's registers and spills per
instantiation), holds the kernel against the plain version (dense_rb_chain)
at odd shapes, f32 and bf16, and times the chain at the flagship's train and
eval stages: device time by CUDA events, the device held busy
(torch.cuda._sleep) until the host has queued every call. --quick stops
after the checks; --time_only skips the ptxas report and the checks. Run
from another checkout's root (a copy of this script beside its package), it
times that checkout's kernel. One JSON line of the times at the end, beside
the card's name and power limit from nvidia-smi.
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
from shallow_ntc_tpu_torch.ops import rb_chain as rb  # noqa: E402


def device_ms(fn, iters=10, warmup=2):
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


def params(n, c, seed, dev):
  r = np.random.default_rng(seed)
  ch = c // 2

  def mk(*shape):
    fan_in = int(np.prod(shape[:-1])) if len(shape) > 1 else 1
    return torch.from_numpy((r.standard_normal(shape) / np.sqrt(fan_in)).astype(np.float32))

  return [tuple(t.to(dev) for t in (mk(c, ch), mk(ch) * 0.1, mk(3, 3, ch, ch), mk(ch) * 0.1,
                                    mk(ch, c), mk(c) * 0.1)) for _ in range(n)]


def chain(x, ps):
  for p in ps:
    x = rb.block_cuda(x, *p)
  return x


def main():
  ap = argparse.ArgumentParser()
  ap.add_argument("--quick", action="store_true")
  ap.add_argument("--time_only", action="store_true",
                  help="skip the ptxas report and the checks (A/B runs, ablated copies)")
  args = ap.parse_args()
  if not torch.cuda.is_available():
    print("needs an NVIDIA GPU", file=sys.stderr)
    return 1
  dev = torch.device("cuda")
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
                              os.path.join(cuda_build.CSRC_DIR, rb.SOURCE)],
                             capture_output=True, text=True)
    for line in probe.stderr.splitlines():
      if "registers" in line or "spill" in line or "Compiling entry" in line:
        print("ptxas:", line.strip())
    if probe.returncode:
      print(probe.stderr, file=sys.stderr)
      return 1
  cuda_build.load(rb.SOURCE)
  print(f"build {time.time() - t:.1f}s", flush=True)

  ok = True
  rng = np.random.default_rng(0)
  checks = ((2, 17, 9, 192, 2), (3, 7, 5, 20, 2), (2, 9, 17, 320, 1), (2, 32, 32, 192, 3),
            (1, 33, 20, 62, 1))
  for b, h, w, c, n in () if args.time_only else checks:
    ps = params(n, c, b + h + w + c + n, dev)
    x32 = torch.from_numpy(rng.standard_normal((b, h, w, c), np.float32)).to(dev)
    for dtype in (torch.float32, torch.bfloat16):
      x = x32.to(dtype)
      ref = rb.dense_rb_chain(x, ps).float()
      scale = ref.abs().max().item()
      tol = (1e-4 if dtype == torch.float32 else 2e-2) * scale
      err = (chain(x, ps).float() - ref).abs().max().item()
      good = err <= tol
      ok &= good
      print(f"check B={b} {h}x{w} C={c} N={n} {dtype}: max|err| {err:.3e} (tol {tol:.3e}) "
            f"{'ok' if good else 'FAIL'}", flush=True)
  if not ok or args.quick:
    return 0 if ok else 1

  times = {}
  for b, h, w, c in ((8, 128, 128, 192), (1, 256, 384, 192), (8, 64, 64, 192),
                     (8, 32, 32, 192), (8, 16, 16, 320)):
    ps = params(3, c, c, dev)
    x32 = torch.from_numpy(rng.standard_normal((b, h, w, c), np.float32)).to(dev)
    for dtype in (torch.float32, torch.bfloat16):
      x = x32.to(dtype)
      key = f"B={b} {h}x{w} C={c} N=3 {str(dtype).split('.')[-1]}"
      times[key] = device_ms(lambda: chain(x, ps))
      print(f"time {key}: {times[key]:.5f} ms  [{smi}]", flush=True)
  print(json.dumps({"rb_chain_ms": times, "device": smi}), flush=True)
  return 0


if __name__ == "__main__":
  sys.exit(main())
