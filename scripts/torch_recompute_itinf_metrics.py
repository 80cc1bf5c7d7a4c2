#!/usr/bin/env python
"""Evaluate the saved SGA latents of the PyTorch port's itinf workdirs again.

The port's counterpart of scripts/recompute_itinf_metrics.py: for each
workdir, rebuild the warm-start model (float32 transforms, TF32 off), load
each batch's itinf_vars.npz and evaluate it once, without re-running the
optimization; rewrite each batch_id=<i>/metrics.json's val section and the
workdir's metrics.json (the per-batch list that
scripts/torch_itinf_to_results.py reads). shallow_ntc_tpu_torch/results.py:
recompute_itinf_metrics. Runs on CUDA unless --device names another device.

  python scripts/torch_recompute_itinf_metrics.py --itinf_glob 'itinf_xms/*/*'
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch

from shallow_ntc_tpu_torch import results


def main(argv=None):
  p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
  p.add_argument("--itinf_glob", required=True)
  p.add_argument("--device", default="cuda")
  args = p.parse_args(argv)
  torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False

  workdirs = results.workdirs_with(args.itinf_glob, "config.json")
  if not workdirs:
    raise SystemExit(f"no itinf workdirs match {args.itinf_glob!r}")
  out = {}
  for wd in workdirs:
    out[wd] = results.recompute_itinf_metrics(wd, args.device)
    for m in out[wd]:
      print(f"{wd} batch {m['batch_id']}: rd_loss {m['rd_loss']:.6f}, bpp {m['bpp']:.6f}, "
            f"psnr {m['psnr']:.4f}, msssim {m['msssim']:.5f}")
  return out


if __name__ == "__main__":
  main()
