#!/usr/bin/env python3
"""Where an SGA step of the port spends its time on the GPU: a torch.profiler trace.

  python3 scripts/torch_itinf_profile.py [--iters 5] [--transforms_dtype bfloat16] [--tf32]

Runs SGA steps (shallow_ntc_tpu_torch.itinf_lib) of the flagship at full
width (configs.ITINF, seeded random weights) on one 512x768 image, as
chip_smoke.py phase "itinf" times them. After a warm-up it profiles --iters
steps and prints, per step, the wall time, the device time summed over
kernels, their ratio (the device's busy share), the host time spent in
PyTorch ops (their self CPU time, summed), the kernels that take the most
device time, and the PyTorch ops whose kernels do (an op's device time
includes its children's, so the op lists overlap). TF32 is off unless
--tf32. Needs CUDA.
"""

import argparse
import itertools
import os
import sys
import time

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from shallow_ntc_tpu_torch import configs, eval_lib, itinf_lib  # noqa: E402


def main():
  parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
  parser.add_argument("--iters", type=int, default=5)
  parser.add_argument("--top", type=int, default=15)
  parser.add_argument("--transforms_dtype", default="float32", choices=("float32", "bfloat16"))
  parser.add_argument("--tf32", action="store_true")
  args = parser.parse_args()
  torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = args.tf32
  cfg = dict(configs.ITINF["model_config"],
             transforms_dtype=itinf_lib.TRANSFORMS_DTYPES[args.transforms_dtype])
  model = eval_lib.build_model(cfg, init_seed=0, device="cuda")
  rng = np.random.default_rng(0)
  x = torch.from_numpy((rng.integers(0, 256, (1, 512, 768, 3)) / 255.0 - 0.5)
                       .astype(np.float32)).cuda()
  fns = itinf_lib.make_itinf_functions(model, cfg["optimizer_config"], 3000)
  latents, optimizer = fns.init(x)
  gen = torch.Generator(device=x.device)
  count = itertools.count()

  def step():
    s = next(count)
    fns.step(x, latents, optimizer, s, None, generator=itinf_lib.seed_step(gen, 0, s))

  for _ in range(3):
    step()
  torch.cuda.synchronize()
  with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
    t = time.time()
    for _ in range(args.iters):
      step()
    torch.cuda.synchronize()
    wall_ms = (time.time() - t) * 1e3 / args.iters
  averages = prof.key_averages()
  kernels = [e for e in averages if e.device_type.name == "CUDA"]
  device_ms = sum(e.self_device_time_total for e in kernels) / 1e3 / args.iters
  host_ms = sum(e.self_cpu_time_total for e in averages
                if e.device_type.name == "CPU") / 1e3 / args.iters
  print(f"device: {torch.cuda.get_device_name(0)}; {args.transforms_dtype} transforms, "
        f"TF32 {'on' if args.tf32 else 'off'}")
  print(f"per step: wall {wall_ms:.4f} ms, device (sum of kernels) {device_ms:.4f} ms, busy "
        f"share {device_ms / wall_ms:.3f}, {sum(e.count for e in kernels) // args.iters} "
        f"kernels; host time in ops {host_ms:.4f} ms")
  print("kernels:")
  for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[: args.top]:
    ms = e.self_device_time_total / 1e3 / args.iters
    print(f"  {ms:9.4f} ms  {e.count // args.iters:4d} calls  {e.key[:100]}")
  print("ops (device time of their kernels, children included):")
  ops = [e for e in averages if e.device_type.name == "CPU" and e.device_time_total > 0]
  for e in sorted(ops, key=lambda e: -e.device_time_total)[: args.top]:
    ms = e.device_time_total / 1e3 / args.iters
    print(f"  {ms:9.4f} ms  {e.count // args.iters:4d} calls  {e.key[:100]}")
  return 0


if __name__ == "__main__":
  sys.exit(main())
