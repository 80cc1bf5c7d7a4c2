"""Train CLI of the port: a model of either family on one GPU.

  python -m shallow_ntc_tpu_torch.train --config two_layer_syn_rd \\
      --workdir /tmp/train_flagship [--num_steps 3] [--init_seed 0] \\
      [--images 'imgs/*.npy'] [--device cuda] [--dispatch eager]

--config names an entry of configs.TRAIN_CONFIGS: two_layer_syn_rd (the
flagship), jpegl_rd, two_layer_syn2, mbt2018, the factorized family's
bls2017_rd and bls2017, or the small smoke config. Writes <workdir>/config.json, train/record.jsonl and
val/record.jsonl (the JAX package's metric keys, steps_per_sec included)
and train/checkpoints/ckpt_<step>.pt, and resumes from the newest
checkpoint there. Runs on CUDA unless --device names another device; the
residual-block kernels are chosen by SNTC_FUSED_RB_CHAIN=1 or
SNTC_FUSED_RESBLOCK=1, as in the JAX package. --dispatch auto (the
default) captures the train step once as a CUDA graph and replays it on the
card, and runs it eagerly on the CPU; eager asks for the eager loop on the
card (step_graph.py). An int8 gate left on
(SNTC_INT8_DECODE, SNTC_INT8_ENCODE) is an error: its quantizers have no
gradient.
"""

import argparse
from typing import Optional, Sequence

from shallow_ntc_tpu_torch import configs
from shallow_ntc_tpu_torch import train_lib
from shallow_ntc_tpu_torch.ops import int8ops


def main(argv: Optional[Sequence[str]] = None) -> train_lib.TrainState:
  parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
  parser.add_argument("--config", required=True, choices=sorted(configs.TRAIN_CONFIGS))
  parser.add_argument("--workdir", required=True)
  parser.add_argument("--num_steps", type=int, help="stop after this many steps")
  parser.add_argument("--init_seed", type=int, default=0,
                      help="seed of the init, the data and the training noise")
  parser.add_argument("--images", help="glob of .npy images to crop, instead of synthetic")
  parser.add_argument("--device", default="cuda")
  parser.add_argument("--dispatch", default="auto", choices=("auto", "eager"))
  args = parser.parse_args(argv)
  int8ops.assert_training_safe()
  state = train_lib.train_and_eval(configs.TRAIN_CONFIGS[args.config], args.workdir,
                                   device=args.device, init_seed=args.init_seed,
                                   num_steps=args.num_steps, images=args.images,
                                   dispatch=args.dispatch)
  print(f"trained to step {state.step}; records and checkpoints under {args.workdir}")
  return state


if __name__ == "__main__":
  main()
