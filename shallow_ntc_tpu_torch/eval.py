"""Eval CLI of the port: per-image R-D metrics of the flagship model -> JSON.

  python -m shallow_ntc_tpu_torch.eval --init_seed 0 --dataset synthetic \
      --results_dir /tmp/results
  python -m shallow_ntc_tpu_torch.eval --params params.npz --images 'imgs/*.npy'

--params takes an .npz whose keys are flax parameter paths
("_analysis/Conv_0/kernel", ...) and may hold a "step" entry; --init_seed
evaluates a seeded full-width init instead. Runs on CUDA unless --device
names another device.
"""

import argparse
import os
from typing import Optional, Sequence

import numpy as np

from shallow_ntc_tpu_torch import configs
from shallow_ntc_tpu_torch import data as data_lib
from shallow_ntc_tpu_torch import eval_lib

_SYNTHETIC_IMAGES = 16  # as shallow_ntc_tpu/data.py's eval split of "synthetic"


def main(argv: Optional[Sequence[str]] = None) -> str:
  parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
  weights = parser.add_mutually_exclusive_group(required=True)
  weights.add_argument("--params", help=".npz of flax parameter paths -> arrays")
  weights.add_argument("--init_seed", type=int, help="seed of a flax-style random init")
  source = parser.add_mutually_exclusive_group(required=True)
  source.add_argument("--dataset", choices=["synthetic"])
  source.add_argument("--images", help="glob of .npy images, [H, W, 3] pixels 0..255")
  parser.add_argument("--patchsize", type=int, default=256, help="synthetic image size")
  parser.add_argument("--results_dir", default="./json_results/torch")
  parser.add_argument("--device", default="cuda")
  args = parser.parse_args(argv)

  step = 0
  if args.params is not None:
    with np.load(args.params) as npz:
      params = {k: npz[k] for k in npz.files}
    step = int(params.pop("step", 0))
    model = eval_lib.build_model(params=params, device=args.device)
    xid = os.path.splitext(os.path.basename(args.params))[0]
  else:
    model = eval_lib.build_model(init_seed=args.init_seed, device=args.device)
    xid = f"init_seed={args.init_seed}"
  if args.dataset == "synthetic":
    images = data_lib.SyntheticDataset(1, args.patchsize, num_batches=_SYNTHETIC_IMAGES)
  else:
    images = data_lib.npy_images(args.images)
  path = eval_lib.eval_to_json(model, images, args.results_dir,
                               configs.TWO_LAYER_SYN_RD_RUNNAME, xid, step)
  print(path)
  return path


if __name__ == "__main__":
  main()
