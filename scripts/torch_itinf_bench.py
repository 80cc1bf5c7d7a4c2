#!/usr/bin/env python
"""SGA step rate of the PyTorch port: the marginal ms of one step of the
iterative inference on a 512x768 image.

The port's counterpart of scripts/itinf_bench.py (its arguments and its
printed line, also as JSON with --out; shallow_ntc_tpu_torch/measure.py:
sga_step_ms): the flagship with JAX's SGA relaxation (tau_r 5e-4, tau_ub
0.5, tau_t0 200; scheduled_num_steps 3000) and optimizer (lr 5e-3, drop
after 0.9 by 0.1, no clipping, no warm-up), --batch uniform images, the
marginal time between --n_lo and --n_hi back-to-back steps of itinf_lib's
loop, the best of two each. The model is a port workdir's (--workdir) or
the seeded full-width flagship. Runs on CUDA unless --device names another
device; TF32 off unless --tf32 (the SGA CLI's default is on).

  python scripts/torch_itinf_bench.py [--batch 8] [--workdir DIR] [--out x.json]
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np

from shallow_ntc_tpu_torch import measure
from shallow_ntc_tpu_torch.utils import runname as runname_utils


def main(argv=None):
  p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
  p.add_argument("--steps", type=int, default=1000, help="the schedule's length")
  p.add_argument("--batch", type=int, default=1)
  p.add_argument("--n_lo", type=int, default=64)
  p.add_argument("--n_hi", type=int, default=256)
  p.add_argument("--out", default=None)
  measure.add_common_args(p)
  args = p.parse_args(argv)
  device = measure.setup(args)
  model = measure.load_model(args.workdir, device, update_model_config=dict(
      latent_config=measure.SGA_LATENT_CONFIG, scheduled_num_steps=3000))
  batch = np.random.default_rng(0).uniform(-0.5, 0.5, (args.batch, 512, 768, 3))
  per_step = measure.sga_step_ms(model, batch.astype(np.float32), args.steps, args.n_lo,
                                 args.n_hi)
  rate = 1e3 / per_step
  rec = dict(device=measure.device_label(device), batch=args.batch, height=512, width=768,
             n_lo=args.n_lo, n_hi=args.n_hi, tf32=args.tf32, ms_per_step=per_step, steps_per_s=rate, image_steps_per_s=rate * args.batch)
  print(f"marginal {per_step:.2f} ms/step -> {rate:.1f} steps/s "
        f"(batch {args.batch}; {rate * args.batch:.1f} image-steps/s)", flush=True)
  if args.out:
    runname_utils.dump_json(rec, args.out)
  return rec


if __name__ == "__main__":
  main()
