#!/usr/bin/env python3
"""Where the port's flagship train step spends its time on the GPU.

  python3 scripts/torch_train_profile.py [--iters 2] [--top 15]

Runs train steps of shallow_ntc_tpu_torch's flagship config (two_layer_syn_rd:
B=8, 256x256, float32, TF32 off, seeded weights and synthetic images), once
with the residual blocks as cuDNN convolutions and once with
SNTC_FUSED_RB_CHAIN=1. After two warm-up steps it profiles --iters steps
with torch.profiler and prints, per step, the wall time, the device time
summed over kernels, their ratio (the device's busy share; kernels that
overlap would count twice), and the kernels that take the most device time.
Needs CUDA.
"""

import argparse
import os
import sys
import time

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from shallow_ntc_tpu_torch import configs, train_lib  # noqa: E402


def profile_steps(chain: bool, iters: int, top: int):
  os.environ["SNTC_FUSED_RB_CHAIN"] = "1" if chain else "0"
  cfg = configs.TRAIN_CONFIGS["two_layer_syn_rd"]
  model, opt_cfg = train_lib.build_model(cfg["model_config"], init_seed=0, device="cuda")
  state, lr_fn = train_lib.create_train_state(model, opt_cfg)
  step = train_lib.make_train_step(model, state.optimizer, lr_fn)
  b, p = cfg["train_data_config"]["batchsize"], cfg["train_data_config"]["patchsize"]
  rng = np.random.default_rng(0)
  batch = torch.from_numpy((rng.integers(0, 256, (b, p, p, 3)) / 255.0 - 0.5)
                           .astype(np.float32)).cuda()
  for _ in range(2):
    step(state, batch)
  torch.cuda.synchronize()
  with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
    t = time.time()
    for _ in range(iters):
      step(state, batch)
    torch.cuda.synchronize()
    wall_ms = (time.time() - t) * 1e3 / iters
  events = [e for e in prof.key_averages() if e.device_type.name == "CUDA"]
  device_ms = sum(e.self_device_time_total for e in events) / 1e3 / iters
  print(f"residual blocks as {'the chain kernel' if chain else 'cuDNN convs'}: per step "
        f"wall {wall_ms:.3f} ms, device (sum of kernels) {device_ms:.3f} ms, "
        f"busy share {device_ms / wall_ms:.3f}")
  events.sort(key=lambda e: -e.self_device_time_total)
  for e in events[:top]:
    ms = e.self_device_time_total / 1e3 / iters
    print(f"  {ms:9.3f} ms  {100 * ms / device_ms:5.1f}%  {e.count // iters:5d} calls  "
          f"{e.key[:90]}")
  del model, state, step


def main():
  parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
  parser.add_argument("--iters", type=int, default=2)
  parser.add_argument("--top", type=int, default=15)
  args = parser.parse_args()
  torch.backends.cudnn.allow_tf32 = False
  torch.backends.cuda.matmul.allow_tf32 = False
  print(f"device: {torch.cuda.get_device_name(0)}")
  for chain in (False, True):
    profile_steps(chain, args.iters, args.top)
  return 0


if __name__ == "__main__":
  sys.exit(main())
