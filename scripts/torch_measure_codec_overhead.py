#!/usr/bin/env python
"""Real-bitstream bpp against the likelihood bound, on a workdir trained by
the PyTorch port.

The port's counterpart of scripts/measure_codec_overhead.py (its arguments,
--device for its --cpu, and its output keys): the eval images go through
shallow_ntc_tpu_torch.codec, each round trip is checked bit for bit, and the
gap to the likelihood bpp is split into the container's framing
(header_bpp), the rANS coders' flush (flush_bpp) and the rest (coding_bpp:
the CDFs' quantization). shallow_ntc_tpu_torch/results.py: codec_overhead.
Runs on CUDA unless --device names another device; TF32 off.

Usage:
  python scripts/torch_measure_codec_overhead.py --workdir <trained workdir> \\
      --dataset deadleaves_eval [--max_images 8] [--out codec_overhead.json]
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
  p.add_argument("--max_images", type=int, default=8)
  p.add_argument("--out", default=None)
  p.add_argument("--device", default="cuda")
  args = p.parse_args(argv)
  torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False

  model, _ = eval_lib.load_latest_ckpt(args.workdir, device=args.device)
  images = data_lib.get_dataset(args.dataset, "test", 1, None)
  agg = dict(workdir=os.path.abspath(args.workdir), dataset=args.dataset,
             **results.codec_overhead(model, images, args.max_images))
  for row in agg["per_image"]:
    print(row, flush=True)
  print(json.dumps({k: v for k, v in agg.items() if k != "per_image"}, indent=2))
  if args.out:
    runname_utils.dump_json(agg, args.out)
    print("wrote", args.out)
  return agg


if __name__ == "__main__":
  main()
