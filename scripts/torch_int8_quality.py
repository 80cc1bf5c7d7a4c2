#!/usr/bin/env python
"""Quality cost of the int8 decode paths on a workdir trained by the
PyTorch port.

The port's counterpart of scripts/int8_quality.py: the end-to-end eval
(eval_lib.evaluate_images at step 0, as the JAX script's) of the eval set
in float, int8_syn (the synthesis's convolutions on int8 operands; the rate
stays the float path's) and int8_all (the hyper-decoder's too: its error
shows as rate), through int8ops.decode_mode as the CLIs' --decode_dtype;
the per-image values and the mean deltas in results/int8_quality.json's
schema (shallow_ntc_tpu_torch/results.py: int8_quality). Runs on CUDA unless
--device names another device; TF32 off, as the eval CLI's default.

--ranges adds "hyper_ranges" (results.int8_hyper_ranges: each hyper-decoder
conv's input absmax per channel and largest folded weight under int8_all,
the scale indexes it changes and its largest |delta mu|) on the z_hat of the
float eval. --save_hyper writes the hyper-decoder's parameters (kernels as
float16, biases float32, by their flax paths) and those z_hat
(z_hat_<i>, float32) to one .npz, which scripts/parity_int8_hyper.py reads.

  python scripts/torch_int8_quality.py --workdir <trained workdir> \\
      [--dataset deadleaves_eval] [--out results/torch_rd_deadleaves/int8_quality.json] \\
      [--ranges] [--save_hyper hyper.npz]
"""

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np
import torch

from shallow_ntc_tpu_torch import data as data_lib
from shallow_ntc_tpu_torch import eval_lib
from shallow_ntc_tpu_torch import results
from shallow_ntc_tpu_torch.utils import runname as runname_utils


def main(argv=None):
  p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
  p.add_argument("--workdir", required=True)
  p.add_argument("--dataset", default="deadleaves_eval")
  p.add_argument("--out", default="results/torch_rd_deadleaves/int8_quality.json")
  p.add_argument("--max_images", type=int, default=0)
  p.add_argument("--ranges", action="store_true",
                 help="add the hyper-decoder's int8 ranges (an mshyper model's)")
  p.add_argument("--save_hyper", help="write the hyper-decoder's parameters and z_hat here")
  p.add_argument("--device", default="cuda")
  args = p.parse_args(argv)
  torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False

  model, config = eval_lib.load_latest_ckpt(args.workdir, device=args.device)
  images = list(data_lib.get_dataset(args.dataset, "test", 1, None))
  if args.max_images:
    images = images[:args.max_images]
  out = dict(workdir=args.workdir, dataset=args.dataset, **results.int8_quality(model, images))
  if args.ranges or args.save_hyper:
    z_hats = results.hyper_latents(model, images)
  if args.ranges:
    out["hyper_ranges"] = results.int8_hyper_ranges(model.hyper_synthesize, z_hats)
    print(json.dumps({k: v for k, v in out["hyper_ranges"].items() if k != "per_image"} | {
        "convs": [{k: v for k, v in c.items() if k != "input_absmax"}
                  for c in out["hyper_ranges"]["convs"]]}, indent=1))
  if args.save_hyper:
    params = {k.replace(".", "/"): v.detach().float().cpu().numpy()
              for k, v in model._hyper_synthesis.state_dict().items()}
    np.savez_compressed(
        args.save_hyper, step=np.int64(config["_restored_step"]),
        **{k: v.astype(np.float16) if v.ndim > 1 else v for k, v in params.items()},
        **{f"z_hat_{i}": z.cpu().numpy() for i, z in enumerate(z_hats)})
  runname_utils.dump_json(out, args.out)
  print(json.dumps({"int8_quality": out["summary"]}, indent=1))
  return out


if __name__ == "__main__":
  main()
