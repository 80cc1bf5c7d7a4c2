#!/usr/bin/env python
"""The shallow decoder's basis functions, from a workdir trained by the
PyTorch port.

The port's counterpart of scripts/vis_syn_filters.py (the reference's
notebooks/vis_syn_filters.ipynb): for a (near-)linear decoder g the learned
basis functions are g(e_i) - g(0) for unit latent vectors e_i, scaled by
--scale; each is cropped about its impulse, scaled to 0..255 and the lot
tiled into one PNG (shallow_ntc_tpu_torch/results.py: synthesis_basis,
basis_grid). The flagship's synthesis runs final_deconv_phase on the card.
--save_basis also writes the float basis [n, k, k, 3] as .npy. Runs on CUDA
unless --device names another device; TF32 off.

Usage:
  python scripts/torch_vis_syn_filters.py --workdir <trained workdir> \\
      --out filters.png [--num 64] [--scale 8]
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np
import torch

from shallow_ntc_tpu_torch import data as data_lib
from shallow_ntc_tpu_torch import eval_lib
from shallow_ntc_tpu_torch import results


def main(argv=None):
  parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
  parser.add_argument("--workdir", required=True)
  parser.add_argument("--out", default="filters.png")
  parser.add_argument("--num", type=int, default=64, help="number of basis fns")
  parser.add_argument("--scale", type=float, default=8.0, help="latent magnitude")
  parser.add_argument("--model_family", default=None)
  parser.add_argument("--save_basis", help="also write the float basis here (.npy)")
  parser.add_argument("--device", default="cuda")
  args = parser.parse_args(argv)
  torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False

  model, _ = eval_lib.load_latest_ckpt(args.workdir, args.model_family, device=args.device)
  basis = results.synthesis_basis(model, args.num, args.scale)
  data_lib.write_png(args.out, results.basis_grid(basis))
  if args.save_basis:
    np.save(args.save_basis, basis)
  print(f"Wrote {args.out}: {basis.shape[0]} basis functions, patch "
        f"{basis.shape[1]}x{basis.shape[2]}")
  return basis


if __name__ == "__main__":
  main()
