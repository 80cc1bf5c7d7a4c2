#!/usr/bin/env python3
"""The JPEG-like decode kernel (csrc/jpegl_decode.cu) alone on one NVIDIA GPU.

  python3 scripts/torch_jpegl_bench.py [--quick | --time_only]

Builds the source with nvcc (printing ptxas's registers, shared memory and
spills per instantiation), holds jpegl_synthesize against its plain version
(jpegl_synthesize_plain) at ragged shapes, both dtypes, and times it at the
main paths' shapes: JPEGL_K16's decode (B=8 z 32x48x320 bf16) and eval (B=1
f32), with weights and bias in z's dtype, as the model's parameters are.
Device time by CUDA events, the device held busy (torch.cuda._sleep) until
the host has queued every call; beside it the time of a call as a caller
waits for it, conv_transpose2d's time on the same inputs, the bound, and the
number of CUDA kernels one call launches (torch.profiler). --quick stops
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
import torch.nn.functional as F
from torch.profiler import ProfilerActivity, profile

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
from shallow_ntc_tpu_torch.ops import cuda_build  # noqa: E402
from shallow_ntc_tpu_torch.ops import jpegl_decode as jd  # noqa: E402
from torch_final_deconv_bench import H100_BYTES_PER_S, call_ms, device_ms  # noqa: E402

# Dense peaks; float32 at the 3xTF32 rate (495 TFLOP/s / 3), as chip_smoke.py.
H100_PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 495e12 / 3}
BF16, F32 = torch.bfloat16, torch.float32
# (B, H_l, W_l, C, k, z dtype, bias, parameter dtype or None for float32,
# kernel misaligned): the decode and eval shapes; M no multiple of the
# 64-latent tile (B=1 3x5, B=3 5x7), fewer tiles than the K16 kernel's
# walkers, and tiles that cross a latent row (W_l = 48, 5 and 7); C = 320,
# 321 (the offset channel, no bias: 4-byte or 2-byte pieces), 40 (a partial
# chunk) and 16; k = 16, 8 and 5 (N = 75: a partial column tile, no whole
# patch rows); the bias in float32 and bfloat16; a K16 kernel that is not
# 16-byte aligned (the tiled route at K16's geometry).
CHECKS = ((8, 32, 48, 320, 16, BF16, True, BF16, False),
          (1, 32, 48, 320, 16, F32, True, None, False),
          (1, 3, 5, 320, 16, BF16, True, BF16, False), (1, 3, 5, 320, 16, F32, True, None, False),
          (3, 5, 7, 320, 16, BF16, False, None, False), (3, 5, 7, 320, 16, F32, False, None, False),
          (2, 3, 48, 320, 16, BF16, True, None, False), (2, 3, 48, 320, 16, F32, True, None, False),
          (3, 5, 7, 321, 16, BF16, False, None, False), (3, 5, 7, 321, 16, F32, False, None, False),
          (2, 3, 5, 40, 16, BF16, True, BF16, False), (2, 3, 5, 40, 16, F32, True, None, False),
          (1, 3, 5, 16, 8, BF16, True, None, False), (1, 3, 5, 16, 8, F32, True, None, False),
          (2, 3, 5, 40, 5, BF16, True, None, False), (2, 3, 5, 40, 5, F32, True, None, False),
          (2, 3, 48, 320, 16, BF16, True, BF16, True), (1, 4, 9, 320, 8, F32, True, None, False))
TIMES = (("decode", 8, 32, 48, BF16), ("eval", 1, 32, 48, F32))


def kernels_per_call(fn):
  """CUDA kernels (and copies) one call of fn launches, under torch.profiler."""
  fn()
  torch.cuda.synchronize()
  with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
    fn()
    torch.cuda.synchronize()
  return sum(e.count for e in prof.key_averages() if e.device_type.name == "CUDA")


def inputs(rng, b, hl, wl, c, k, dtype, use_bias=True, param_dtype=None, misalign=False):
  """z ~ N(0, 3); weights at a glorot scale, asymmetric (a missed flip shows)."""
  z = torch.from_numpy(rng.normal(0, 3, (b, hl, wl, c)).astype(np.float32)).cuda().to(dtype)
  kern = torch.from_numpy((rng.normal(0, 0.1, (k, k, c, 3)) / np.sqrt(c / 32))
                          .astype(np.float32)).cuda().to(param_dtype or F32)
  if misalign:  # the same values one element into a buffer: 2 bytes off 16-byte alignment
    buf = torch.empty(kern.numel() + 1, dtype=kern.dtype, device="cuda")
    buf[1:] = kern.flatten()
    kern = buf[1:].view(kern.shape)
  bias = (torch.from_numpy(rng.normal(0, 0.1, (3,)).astype(np.float32)).cuda()
          .to(param_dtype or F32) if use_bias else None)
  return z, kern, bias


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
                              os.path.join(cuda_build.CSRC_DIR, jd.SOURCE)],
                             capture_output=True, text=True)
    for line in probe.stderr.splitlines():
      if "registers" in line or "spill" in line or "Compiling entry" in line:
        print("ptxas:", line.strip())
    if probe.returncode:
      print(probe.stderr, file=sys.stderr)
      return 1
  cuda_build.load(jd.SOURCE)
  print(f"build {time.time() - t:.1f}s", flush=True)

  ok = True
  rng = np.random.default_rng(0)
  for b, hl, wl, c, k, dtype, use_bias, pdt, mis in () if args.time_only else CHECKS:
    z, kern, bias = inputs(rng, b, hl, wl, c, k, dtype, use_bias, pdt, mis)
    out = jd.jpegl_synthesize_cuda(z, kern, bias)
    ref = jd.jpegl_synthesize_plain(z, kern, bias)
    torch.cuda.synchronize()
    err = (out.float() - ref.float()).abs().max().item()
    scale = ref.float().abs().max().item()
    tol = 1e-4 * max(1.0, scale) if dtype == F32 else 1e-2 * scale
    good = out.shape == ref.shape and out.dtype == dtype and err <= tol
    ok &= good
    print(f"check B={b} {hl}x{wl} C={c} k={k} {dtype}{'' if use_bias else ' no bias'} "
          f"params {pdt or F32}{' misaligned' if mis else ''}: max|err| {err:.3e} "
          f"(tol {tol:.3e}, max|y| {scale:.3f}) {'ok' if good else 'FAIL'}", flush=True)
  if not ok or args.quick:
    return 0 if ok else 1

  times = {}
  for name, b, hl, wl, dtype in TIMES:
    z, kern, bias = inputs(rng, b, hl, wl, 320, 16, dtype, True, dtype)
    out = jd.jpegl_synthesize_cuda(z, kern, bias)
    zn = z.permute(0, 3, 1, 2)  # NCHW view of the NHWC latents
    weight = kern.flip(0, 1).permute(2, 3, 0, 1).contiguous()
    ms = device_ms(lambda: jd.jpegl_synthesize_cuda(z, kern, bias))
    call = call_ms(lambda: jd.jpegl_synthesize_cuda(z, kern, bias))
    lib = device_ms(lambda: F.conv_transpose2d(zn, weight, bias, stride=16))
    n_kernels = kernels_per_call(lambda: jd.jpegl_synthesize_cuda(z, kern, bias))
    n_bytes = (z.numel() + out.numel() + kern.numel() + bias.numel()) * z.element_size()
    flops = 2 * 320 * out.numel()
    t_bytes, t_ops = n_bytes / H100_BYTES_PER_S * 1e3, flops / H100_PEAK_FLOPS[dtype] * 1e3
    bound, by = max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"
    key = f"{name} B={b} z {hl}x{wl}x320 {str(dtype).split('.')[-1]}"
    times[key] = dict(ms=ms, call_ms=call, library_ms=lib, bound_ms=bound, bound_by=by,
                      kernels_per_call=n_kernels)
    print(f"time {key}: kernel {ms:.5f} ms (a call {call:.5f} ms, {n_kernels} CUDA kernel(s) "
          f"per call), conv_transpose2d {lib:.5f} ms, bound {bound:.5f} ms ({by}, "
          f"{bound / ms:.1%} of it)  [{smi}]", flush=True)
  print(json.dumps({"jpegl_synthesize_ms": times, "device": smi}), flush=True)
  return 0


if __name__ == "__main__":
  sys.exit(main())
