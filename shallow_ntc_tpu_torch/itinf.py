"""SGA iterative-inference CLI of the port: per-image optimization of a
model's latents (configs.ITINF on the flagship, configs.ITINF_FACTORIZED on
bls2017_rd; both from mshyper/configs/itinf.py).

  python -m shallow_ntc_tpu_torch.itinf --init_seed 0 --dataset synthetic
  python -m shallow_ntc_tpu_torch.itinf --config itinf_factorized --init_seed 0 \\
      --dataset synthetic
  python -m shallow_ntc_tpu_torch.itinf --workdir TRAIN_DIR --images 'imgs/*.npy' \\
      [--num_steps 3000] [--log_every 300] [--eval_every 3000] \\
      [--transforms_dtype bfloat16] [--out ./itinf_xms/torch] [--dispatch eager]

Weights come from exactly one of --params (an .npz of flax parameter paths,
as the eval CLI's), --init_seed (a seeded full-width init) or --workdir (the
newest checkpoint of the port's train CLI under DIR). Images are .npy
[H, W, 3] pixels 0..255, one at a time, or the 16 synthetic 256x256 test
images. Writes <out>/config.json, per image <out>/batch_id=<i>/
(train/ and val/record.jsonl, metrics.json, itinf_vars.npz) and
<out>/metrics.json, as the JAX package's itinf does. --transforms_dtype is
the computation type of the frozen transforms (the latents and the entropy
math stay float32). --config picks the configuration and with it the model
family: itinf (the flagship, the default) or itinf_factorized. --matmul_precision default (the default, as the JAX
itinf CLI's) leaves TF32 on for cuDNN convolutions and matmuls; highest
turns it off. --seed seeds the SGA draws. --dispatch auto (the default)
captures the SGA step once as a CUDA graph and replays it on the card, and
runs it eagerly on the CPU; eager asks for the eager loop on the card. Runs on CUDA unless --device
names another device. An int8 gate left on (SNTC_INT8_DECODE,
SNTC_INT8_ENCODE) is an error: its quantizers have no gradient.
"""

import argparse
import copy
import json
import os
from typing import Dict, List, Optional, Sequence

import torch

from shallow_ntc_tpu_torch import configs
from shallow_ntc_tpu_torch import data as data_lib
from shallow_ntc_tpu_torch import eval_lib
from shallow_ntc_tpu_torch import itinf_lib
from shallow_ntc_tpu_torch import train_lib
from shallow_ntc_tpu_torch.ops import int8ops


def main(argv: Optional[Sequence[str]] = None) -> List[Dict]:
  parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
  weights = parser.add_mutually_exclusive_group(required=True)
  weights.add_argument("--params", help=".npz of flax parameter paths -> arrays")
  weights.add_argument("--init_seed", type=int, help="seed of a flax-style random init")
  weights.add_argument("--workdir", help="the newest checkpoint of the train CLI there")
  source = parser.add_mutually_exclusive_group(required=True)
  source.add_argument("--dataset", choices=["synthetic"])
  source.add_argument("--images", help="glob of .npy images, [H, W, 3] pixels 0..255")
  parser.add_argument("--config", default="itinf", choices=("itinf", "itinf_factorized"))
  parser.add_argument("--num_steps", type=int)
  parser.add_argument("--log_every", type=int)
  parser.add_argument("--eval_every", type=int)
  parser.add_argument("--transforms_dtype", choices=("bfloat16", "float32"))
  parser.add_argument("--matmul_precision", default="default", choices=("default", "highest"))
  parser.add_argument("--seed", type=int, default=0, help="seed of the SGA draws")
  parser.add_argument("--out", default="./itinf_xms/torch")
  parser.add_argument("--device", default="cuda")
  parser.add_argument("--dispatch", default="auto", choices=("auto", "eager"))
  args = parser.parse_args(argv)
  int8ops.assert_training_safe()
  # Process-wide, so set here and not in itinf_lib.
  tf32 = args.matmul_precision == "default"
  torch.backends.cudnn.allow_tf32 = tf32
  torch.backends.cuda.matmul.allow_tf32 = tf32

  config = copy.deepcopy(configs.itinf_config(args.config))
  family = config["model_family"]
  te_cfg = config["train_eval_config"]
  for key, value in (("num_steps", args.num_steps), ("log_metrics_every_steps", args.log_every),
                     ("eval_every_steps", args.eval_every),
                     ("transforms_dtype", args.transforms_dtype)):
    if value is not None:
      te_cfg[key] = value
  model_config = dict(config["model_config"],
                      transforms_dtype=itinf_lib.TRANSFORMS_DTYPES[te_cfg["transforms_dtype"]])
  if args.workdir is not None:
    model = train_lib.model_from_checkpoint(args.workdir, model_config, args.device, family)
  else:
    params = eval_lib.read_params(args.params)[0] if args.params is not None else None
    model = eval_lib.build_model(model_config, params=params, init_seed=args.init_seed,
                                 device=args.device, family=family)
  images = data_lib.get_dataset(args.images or args.dataset, "test", 1, None)
  os.makedirs(args.out, exist_ok=True)
  with open(os.path.join(args.out, "config.json"), "w") as f:
    json.dump(config, f, indent=2)
  all_metrics = itinf_lib.itinf_eval(model, images, config, args.out, seed=args.seed,
                                     dispatch=args.dispatch)
  for m in all_metrics:
    print(f"image {m['batch_id']}: rd_loss {m['rd_loss']:.5f} bpp {m['bpp']:.5f} "
          f"psnr {m['psnr']:.4f}")
  print(f"wrote {os.path.join(args.out, 'metrics.json')}")
  return all_metrics


if __name__ == "__main__":
  main()
