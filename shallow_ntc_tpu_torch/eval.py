"""Eval CLI of the port: per-image R-D metrics of a model -> JSON.

  python -m shallow_ntc_tpu_torch.eval --init_seed 0 --dataset synthetic \
      --results_dir /tmp/results
  python -m shallow_ntc_tpu_torch.eval --params params.npz --images 'imgs/*.npy'
  python -m shallow_ntc_tpu_torch.eval --config jpegl_rd --init_seed 0 --dataset synthetic

--config picks the model, its family and its run name: two_layer_syn_rd
(the flagship, the default), jpegl_rd (the JPEG-like decoder),
two_layer_syn2 (CNN analysis, non-residual two-layer decoder, mixedq),
mbt2018 (Minnen 2018), or the factorized family's bls2017_rd and bls2017. --params takes an .npz
whose keys are flax parameter paths ("_analysis/Conv_0/kernel", ...) and
may hold a "step" entry; --init_seed evaluates a seeded full-width init
instead. Runs on CUDA unless --device names another device.
--matmul_precision highest (the default, as the JAX eval's) turns TF32 off
for cuDNN convolutions and matmuls; default leaves TF32 on.
--decode_dtype int8_syn runs the synthesis's convolutions on int8 operands
(the rate stays the float path's bit for bit), int8_all the hyper-decoder's
too (ops/int8ops.py); float (the default) leaves SNTC_INT8_DECODE in charge.
Each record gets "lpips" when the LPIPS weights file exists
(models/lpips.default_weights_path); without it the metric is omitted.
"""

import argparse
import logging
import os
from typing import Optional, Sequence

import torch

from shallow_ntc_tpu_torch import configs
from shallow_ntc_tpu_torch import data as data_lib
from shallow_ntc_tpu_torch import eval_lib
from shallow_ntc_tpu_torch.models import lpips
from shallow_ntc_tpu_torch.ops import int8ops

# --decode_dtype -> int8ops.decode_mode (None: the environment's mode).
DECODE_MODES = {"float": None, "int8_syn": "syn", "int8_all": "all"}

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
  parser.add_argument("--config", default="two_layer_syn_rd", choices=configs.EVAL_CONFIG_NAMES)
  parser.add_argument("--matmul_precision", default="highest", choices=("highest", "default"))
  parser.add_argument("--decode_dtype", default="float", choices=sorted(DECODE_MODES))
  args = parser.parse_args(argv)
  # Process-wide, so set here and not in eval_lib: a library must not change
  # its caller's numerics.
  tf32 = args.matmul_precision == "default"
  torch.backends.cudnn.allow_tf32 = tf32
  torch.backends.cuda.matmul.allow_tf32 = tf32
  model_config, runname, family = configs.eval_config(args.config)

  step = 0
  if args.params is not None:
    params, step = eval_lib.read_params(args.params)
    model = eval_lib.build_model(model_config, params=params, device=args.device,
                                 family=family)
    xid = os.path.splitext(os.path.basename(args.params))[0]
  else:
    model = eval_lib.build_model(model_config, init_seed=args.init_seed, device=args.device,
                                 family=family)
    xid = f"init_seed={args.init_seed}"
  if args.dataset == "synthetic":
    images = data_lib.SyntheticDataset(1, args.patchsize, num_batches=_SYNTHETIC_IMAGES)
  else:
    images = data_lib.npy_images(args.images)
  try:
    lpips_fn = lpips.make_lpips_fn(device=eval_lib.resolve_device(args.device))
  except FileNotFoundError as e:
    logging.warning("LPIPS unavailable (%s); omitting the metric.", e)
    lpips_fn = None
  with int8ops.decode_mode(DECODE_MODES[args.decode_dtype]):
    path = eval_lib.eval_to_json(model, images, args.results_dir, runname, xid, step, lpips_fn)
  print(path)
  return path


if __name__ == "__main__":
  main()
