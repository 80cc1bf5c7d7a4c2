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

  python scripts/torch_int8_quality.py --workdir <trained workdir> \\
      [--dataset deadleaves_eval] [--out results/torch_rd_deadleaves/int8_quality.json]
"""

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

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
  p.add_argument("--device", default="cuda")
  args = p.parse_args(argv)
  torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False

  model, _ = eval_lib.load_latest_ckpt(args.workdir, device=args.device)
  images = list(data_lib.get_dataset(args.dataset, "test", 1, None))
  if args.max_images:
    images = images[:args.max_images]
  out = dict(workdir=args.workdir, dataset=args.dataset, **results.int8_quality(model, images))
  runname_utils.dump_json(out, args.out)
  print(json.dumps({"int8_quality": out["summary"]}, indent=1))
  return out


if __name__ == "__main__":
  main()
