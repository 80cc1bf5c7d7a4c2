#!/usr/bin/env python3
"""Where the port's decode spends its time on the GPU: a torch.profiler trace.

  python3 scripts/torch_decode_profile.py [--iters 5]

Runs the flagship decode (hyper_synthesize + synthesize) of
shallow_ntc_tpu_torch at B=8, 512x768, bf16, with seeded random weights and
symbols, as chip_smoke.py times it. After a warm-up it profiles --iters
decodes and prints, per decode, the wall time, the device time summed over
kernels, their ratio (the device's busy share; kernels that overlap would
count twice), and the kernels that take the most device time. Needs CUDA.
"""

import argparse
import os
import sys
import time

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from shallow_ntc_tpu_torch import configs, eval_lib  # noqa: E402


def main():
  parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
  parser.add_argument("--iters", type=int, default=5)
  parser.add_argument("--top", type=int, default=12)
  args = parser.parse_args()
  model = eval_lib.build_model(configs.TWO_LAYER_SYN_RD, init_seed=0,
                               device="cuda").to(torch.bfloat16)
  rng = np.random.default_rng(0)
  dev = torch.device("cuda")
  y_hat = torch.from_numpy(rng.integers(-8, 8, (8, 32, 48, 320))).to(dev, torch.bfloat16)
  z_hat = torch.from_numpy(rng.integers(-8, 8, (8, 8, 12, 320))).to(dev, torch.bfloat16)

  def decode():
    with torch.no_grad():
      model.hyper_synthesize(z_hat)
      model.synthesize(y_hat)

  for _ in range(3):
    decode()
  torch.cuda.synchronize()
  with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
    t = time.time()
    for _ in range(args.iters):
      decode()
    torch.cuda.synchronize()
    wall_ms = (time.time() - t) * 1e3 / args.iters
  events = [e for e in prof.key_averages() if e.device_type.name == "CUDA"]
  device_ms = sum(e.self_device_time_total for e in events) / 1e3 / args.iters
  print(f"device: {torch.cuda.get_device_name(0)}")
  print(f"per decode: wall {wall_ms:.4f} ms, device (sum of kernels) {device_ms:.4f} ms, "
        f"busy share {device_ms / wall_ms:.3f}")
  events.sort(key=lambda e: -e.self_device_time_total)
  for e in events[: args.top]:
    ms = e.self_device_time_total / 1e3 / args.iters
    print(f"  {ms:9.4f} ms  {e.count // args.iters:4d} calls  {e.key[:100]}")
  return 0


if __name__ == "__main__":
  sys.exit(main())
