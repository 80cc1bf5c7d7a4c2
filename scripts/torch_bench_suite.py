#!/usr/bin/env python
"""Benchmark suite of the PyTorch port on the card.

The port's counterpart of scripts/bench_suite.py (--fast, and
results/bench_suite.json's keys; shallow_ntc_tpu_torch/measure.py:
bench_suite), for the seeded full-width flagship:
  * decode Mpx/s (hyper-synthesis + synthesis) at B=8 512x768 bf16, in
    float, int8_syn and int8_all;
  * encode Mpx/s (analysis + hyper-analysis) at the same shape: float,
    SNTC_INT8_ENCODE=1, and (beside the JAX keys) the chain kernel
    (SNTC_FUSED_RB_CHAIN=1);
  * train steps/s and images/s at B=8 256x256 float32;
  * SGA steps/s on one 512x768 image;
  * host rANS encode / decode Msym/s of 1M symbols, round trip checked.
Times by CUDA events around the host's loop (measure.marginal_ms). "device"
is the card's name and power limit from nvidia-smi. Runs on CUDA unless
--device names another device; TF32 off unless --tf32.

  python scripts/torch_bench_suite.py [--fast] [--out results/torch_bench_suite.json]
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
  p.add_argument("--fast", action="store_true")
  p.add_argument("--out", default="results/torch_bench_suite.json")
  measure.add_common_args(p, workdir=False)
  args = p.parse_args(argv)
  device = measure.setup(args)
  results = measure.bench_suite(device, args.fast)
  runname_utils.dump_json(results, args.out)
  print(json.dumps(results, indent=2), flush=True)
  return results


if __name__ == "__main__":
  main()
