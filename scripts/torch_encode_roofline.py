#!/usr/bin/env python
"""The encoder's roofline in the PyTorch port: each stage's time against its
least HBM bytes and FLOPs on the H100.

The port's counterpart of scripts/encode_roofline.py (--batch, and
results/encode_roofline.json's keys; shallow_ntc_tpu_torch/measure.py:
encode_roofline): the ten stages of the seeded full-width flagship's
ElicAnalysis and HyperAnalysis at B x 512x768 in bf16 (conv0_s2, rb_chain1,
conv1_s2, rb_chain2, attn1, conv2_s2, rb_chain3, conv3_s2, attn2,
hyper_analysis), each timed by measure.marginal_ms beside JAX's formulas
for its least bytes and FLOPs, against the H100's 3.35 TB/s and 989 bf16
TFLOP/s (JAX's file has v5e's). The chain stages run as cuDNN blocks (ms)
and through the chain kernel (kernel_ms). Runs on CUDA unless --device names
another device; TF32 off unless --tf32.

  python scripts/torch_encode_roofline.py [--batch 8] [--out results/torch_encode_roofline.json]
"""

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from shallow_ntc_tpu_torch import measure
from shallow_ntc_tpu_torch.utils import runname as runname_utils


def main(argv=None):
  p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
  p.add_argument("--batch", type=int, default=8)
  p.add_argument("--out", default="results/torch_encode_roofline.json")
  measure.add_common_args(p, workdir=False)
  args = p.parse_args(argv)
  device = measure.setup(args)
  out = measure.encode_roofline(device, args.batch)
  for rec in out["stages"]:
    print(rec, flush=True)
  runname_utils.dump_json(out, args.out)
  print(json.dumps({k: v for k, v in out.items() if k != "stages"}), flush=True)
  return out


if __name__ == "__main__":
  main()
