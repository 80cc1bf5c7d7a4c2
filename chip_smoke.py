#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (shallow_ntc_tpu_torch) on one NVIDIA GPU.

  python3 chip_smoke.py

Phases, one flushed line each with its seconds:
  1. build     nvcc builds every CUDA kernel of the main path (csrc/*.cu).
  2. device    the card's name, and its name and power limit from nvidia-smi.
  3. kernels   each kernel against its plain PyTorch version on the card, at
               the main path's shapes plus odd ones, TF32 off; fails on a miss.
  4. eval      the main path: per-image eval of the flagship mshyper model at
               full width (ELIC 192/192/192/320, synthesis (12, 3)), seeded
               random weights, three 512x768 images, f32; then one batch
               decode (hyper_synthesize + synthesize) at B=8 in bf16. Kernel
               launch counts are zeroed before and read after.
  5. reference the GPU eval against the port's CPU eval (plain versions) on a
               192x256 crop with the same weights: latents and prior logits
               to float tolerance, then the rest of the path from the same
               latents (latent rate, PSNR, reconstruction).
  6. timing    the B=8 bf16 decode in Mpx/s; each kernel, its plain version and
               one PyTorch library call computing the same function, by CUDA events.
Then one JSON line of kernels, the nvidia-smi line, and the last line
{"ok": true, "device": {...}}. Any failed phase exits non-zero before that
line. Without CUDA, or without the port beside this script, it exits 1.
"""

import json
import subprocess
import sys
import time

import numpy as np

T0 = time.time()
H100_BYTES_PER_S = 3.35e12  # HBM3, NVIDIA data sheet (SXM)
H100_PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}  # dense; f32 off the tensor cores
EVAL_HW = (512, 768)
DECODE_BATCH = 8


def log(phase, msg):
  print(f"[{phase} {time.time() - T0:7.1f}s] {msg}", flush=True)


def check(ok, msg):
  if not ok:
    raise RuntimeError(msg)


def cuda_ms(torch, fn, iters=50, warmup=5):
  """Mean device time of fn() over `iters` back-to-back calls, by CUDA events."""
  for _ in range(warmup):
    fn()
  torch.cuda.synchronize()
  start = torch.cuda.Event(enable_timing=True)
  end = torch.cuda.Event(enable_timing=True)
  start.record()
  for _ in range(iters):
    fn()
  end.record()
  end.synchronize()
  return start.elapsed_time(end) / iters


def final_deconv_bound_ms(mid_p, out, kernel, dtype_name):
  """Least time for final_deconv_phase on these inputs: bytes or operations.

  Bytes: mid read once, output written once, float32 weights and bias once.
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
             + 4 * (kernel.numel() + c_out))
  flops = 2 * c_in * c_out * b * taps(8 * h) * taps(8 * w)
  t_bytes = n_bytes / H100_BYTES_PER_S * 1e3
  t_ops = flops / H100_PEAK_FLOPS[dtype_name] * 1e3
  return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def main():
  import torch
  if not torch.cuda.is_available():
    print("chip_smoke: CUDA is not available", file=sys.stderr)
    return 1
  try:
    from shallow_ntc_tpu_torch import configs, eval_lib
    from shallow_ntc_tpu_torch.latents import LatentRVCollection, UQLatentRV
    from shallow_ntc_tpu_torch.ops import cuda_build
    from shallow_ntc_tpu_torch.ops import fast_deconv as fd
    from shallow_ntc_tpu_torch.ops import twolayer_final as tl
  except ImportError as e:
    print(f"chip_smoke: the port is not beside this script ({e})", file=sys.stderr)
    return 1
  import torch.nn.functional as F

  # --- 1. build ------------------------------------------------------------
  t = time.time()
  so = cuda_build.build(tl.SOURCE)
  log("build", f"{tl.SOURCE} -> {so} in {time.time() - t:.1f}s")

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

  def final_inputs(b, h, w, dtype, k=5, c_in=12, c_out=3):
    mid = torch.from_numpy(rng.standard_normal((b, h, w, 64 * c_in), np.float32))
    kern = torch.from_numpy(rng.standard_normal((k, k, c_in, c_out), np.float32) * 0.1)
    bias = torch.from_numpy(rng.standard_normal((c_out,), np.float32) * 0.1)
    return mid.to(dev, dtype), kern.to(dev, dtype), bias.to(dev)

  mh, mw = EVAL_HW[0] // 16, EVAL_HW[1] // 16
  cases = [(1, mh, mw, torch.float32, 5), (DECODE_BATCH, mh, mw, torch.bfloat16, 5),
           (3, 5, 7, torch.float32, 5), (2, 3, 4, torch.float32, 7)]
  errs = {}
  for b, h, w, dtype, k in cases:
    mid, kern, bias = final_inputs(b, h, w, dtype, k)
    out = tl.final_deconv_cuda(mid, kern, bias, 12)
    ref = tl.final_deconv_plain(mid, kern, bias, 12)
    torch.cuda.synchronize()
    err = (out.float() - ref.float()).abs().max().item()
    scale = ref.float().abs().max().item()
    tol = 1e-4 if dtype == torch.float32 else 2e-2 * scale
    log("kernels", f"final_deconv_phase B={b} {h}x{w} k={k} {dtype}: max|err| {err:.3e} "
        f"(tol {tol:.3e}, max|y| {scale:.3f})")
    check(out.shape == ref.shape and err <= tol, f"final_deconv_phase disagrees: {err} > {tol}")
    errs[(b, dtype)] = err
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
  check(all(np.isfinite(r[k]) for r in records for k in ("bpp", "psnr", "msssim", "rd_loss")),
        "eval metrics not finite")
  check(eval_launches >= 3, f"eval launched final_deconv_phase {eval_launches} times, not >= 3")
  check(launches > eval_launches, "the decode did not launch final_deconv_phase")
  check(rec.shape == (DECODE_BATCH,) + EVAL_HW + (3,) and torch.isfinite(rec).all().item()
        and mu.shape == y_hat.shape and torch.isfinite(idx).all().item(),
        "decode output has the wrong shape or is not finite")

  # --- 5. reference: the GPU path against the port's CPU path -------------
  # Continuous tensors are held to float tolerance, and the rest of the path
  # starts from the same latents on both devices, so that no float
  # difference flips a rounded symbol. The hyper-latent rate is held through
  # the prior's CDF logits: where those of z_hat -/+ .5 sum to exactly zero,
  # the reference's sign trick (shallow_ntc_tpu/ops/entropy.py:164) takes
  # p = 0 and the 1e-9 floor, so which of those elements hit the floor
  # depends on the last bit of each device's arithmetic.
  t = time.time()
  model_cpu = eval_lib.build_model(configs.TWO_LAYER_SYN_RD, init_seed=0, device="cpu")
  small = torch.from_numpy(images[:1, :192, :256])
  failures = []

  def compare(name, gpu_t, cpu_t):
    err = (gpu_t.cpu() - cpu_t).abs().max().item()
    scale = cpu_t.abs().max().item()
    log("reference", f"192x256 {name}: max|gpu-cpu| {err:.3e}, max|cpu| {scale:.3f} "
        f"(tol 1e-4 * max(1, max|cpu|))")
    if err > 1e-4 * max(1.0, scale):
      failures.append(name)

  with torch.no_grad():
    rv_cpu = model_cpu.infer_latent_rvs(small)
    rv_gpu = model.infer_latent_rvs(small.to(dev))
    for name, a, b in zip(("z", "y"), rv_gpu.uq, rv_cpu.uq):
      compare(name, a.loc, b.loc)
    z_off = model_cpu.prior_quantization_offset()
    z_q = torch.round(rv_cpu.uq[0].loc - z_off) + z_off
    for name, shift in (("prior logits at z_hat-.5", -0.5), ("prior logits at z_hat+.5", 0.5)):
      compare(name, model._prior.logits_cdf(z_q.to(dev) + shift),
              model_cpu._prior.logits_cdf(z_q + shift))
    same = LatentRVCollection(uq=tuple(UQLatentRV(loc=r.loc.to(dev)) for r in rv_cpu.uq))
    _, m_gpu, rec_gpu = model.frame_loss_given_latent_rvs(small.to(dev), same)
    _, m_cpu, rec_cpu = model_cpu.frame_loss_given_latent_rvs(small, rv_cpu)
  for key in ("latent_bpp", "psnr", "hyper_latent_bpp", "bpp"):
    gpu_v, cpu_v = float(m_gpu[key]), float(m_cpu[key])
    rel = abs(gpu_v - cpu_v) / abs(cpu_v)
    held = key in ("latent_bpp", "psnr")
    log("reference", f"192x256 {key}: gpu {gpu_v:.6f} cpu {cpu_v:.6f} rel {rel:.2e} "
        + ("(tol 1e-3)" if held else "(reported: includes the floored elements)"))
    if held and rel > 1e-3:
      failures.append(key)
  same_px = (rec_gpu.cpu() == rec_cpu).float().mean().item()
  log("reference", f"192x256 reconstruction: {same_px:.6f} of pixels equal on the 255 grid "
      f"(tol 0.99); done in {time.time() - t:.1f}s")
  check(same_px >= 0.99 and not failures, f"GPU eval disagrees with the CPU eval: {failures}")

  # --- 6. timing ------------------------------------------------------------
  pixels = DECODE_BATCH * EVAL_HW[0] * EVAL_HW[1]
  decode_ms = cuda_ms(torch, decode, iters=20, warmup=3)
  log("timing", f"decode B={DECODE_BATCH} {EVAL_HW[0]}x{EVAL_HW[1]} bf16: {decode_ms:.4f} ms, "
      f"{pixels / decode_ms / 1e3:.2f} Mpx/s  [{smi}]")

  def time_final(b, dtype):
    mid, kern, bias = final_inputs(b, mh, mw, dtype)
    out = tl.final_deconv_cuda(mid, kern, bias, 12)
    x_d2s = fd.depth_to_space(mid, 8).permute(0, 3, 1, 2)  # NCHW view, channels-last
    weight = kern.flip(0, 1).permute(2, 3, 0, 1).contiguous()
    lib = F.conv_transpose2d(x_d2s, weight, bias.to(dtype), stride=2, padding=1)
    lib_err = (lib[:, :, : 16 * mh, : 16 * mw].permute(0, 2, 3, 1).float()
               - out.float()).abs().max().item()
    ms = cuda_ms(torch, lambda: tl.final_deconv_cuda(mid, kern, bias, 12))
    plain = cuda_ms(torch, lambda: tl.final_deconv_plain(mid, kern, bias, 12), iters=20)
    lib_ms = cuda_ms(torch, lambda: F.conv_transpose2d(x_d2s, weight, bias.to(dtype),
                                                       stride=2, padding=1))
    bound, by = final_deconv_bound_ms(mid, out, kern, str(dtype).split(".")[-1])
    log("timing", f"final_deconv_phase B={b} {mh}x{mw} {dtype}: kernel {ms:.5f} ms, "
        f"plain {plain:.5f} ms, conv_transpose2d {lib_ms:.5f} ms (vs kernel max|diff| "
        f"{lib_err:.2e}), bound {bound:.5f} ms ({by})  [{smi}]")
    return dict(ms=ms, plain_ms=plain, bound_ms=bound, bound_by=by, library_ms=lib_ms)

  decode_t = time_final(DECODE_BATCH, torch.bfloat16)
  eval_t = time_final(1, torch.float32)
  kernels = [dict(
      name=tl.STATS.name, route="cuda",
      source="shallow_ntc_tpu_torch/csrc/final_deconv.cu",
      replaces="shallow_ntc_tpu/ops/pallas/twolayer_final.py:273",
      launches=launches, max_abs_err=errs[(DECODE_BATCH, torch.bfloat16)], **decode_t,
      shape=f"B={DECODE_BATCH} mid {mh}x{mw}x768 bf16 (decode)",
      eval_shape=dict(shape=f"B=1 mid {mh}x{mw}x768 f32 (eval)",
                      max_abs_err=errs[(1, torch.float32)], **eval_t),
      decode_mpx_per_s=pixels / decode_ms / 1e3)]
  print(json.dumps({"kernels": kernels}), flush=True)
  print(smi, flush=True)
  print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                           "count": torch.cuda.device_count()}}), flush=True)
  return 0


if __name__ == "__main__":
  sys.exit(main())
