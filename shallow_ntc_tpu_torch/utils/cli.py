"""The train and itinf CLIs of the experiment workflow, on argparse
(mirrors shallow_ntc_tpu/utils/cli.py).

  python -m shallow_ntc_tpu_torch.mshyper.train \\
      --config shallow_ntc_tpu_torch/mshyper/configs/two_layer_syn_rd.py --hid 3 \\
      [--config.train_eval_config.num_steps=4] [--experiments_dir ./train_xms]

--config is a config script (utils/config.py: get_config, get_cfg_str,
get_hyper); `--config.a.b=value` overrides a key of it, and --hid N applies
entry N of its get_hyper() sweep after the overrides. The run is named
<family>-<get_cfg_str(config)> and writes under
<experiments_dir>/<xid>/[wid=<wid>-]<run name>/ (train_lib.setup_workdir).
--matmul_precision default (the default, as the JAX train CLI's) leaves
TF32 on for cuDNN convolutions and matmuls; highest turns it off. Runs on
CUDA unless --device names another device. An int8 gate left on
(SNTC_INT8_DECODE, SNTC_INT8_ENCODE) is an error: its quantizers have no
gradient. The JAX CLIs' multi-device flags (--dp_devices, --coordinator,
--num_processes, --process_id) are not defined: the port runs on one GPU.
"""

import argparse
import sys
from typing import Dict, Optional, Sequence, Tuple

import torch

from shallow_ntc_tpu_torch.ops import int8ops
from shallow_ntc_tpu_torch.utils import config as config_lib
from shallow_ntc_tpu_torch.utils.config import load_config_module


def parse_args(argv: Optional[Sequence[str]], default_experiments_dir: str,
               description: str) -> Tuple[argparse.Namespace, Dict]:
  """(the parsed flags, the resolved config) of a train or itinf command line."""
  rest, overrides = config_lib.split_overrides(sys.argv[1:] if argv is None else argv)
  parser = argparse.ArgumentParser(description=description)
  parser.add_argument("--config", required=True, help="path of the config script")
  parser.add_argument("--hid", type=int,
                      help="index into the config's get_hyper() sweep (one work unit per entry)")
  parser.add_argument("--experiments_dir", default=default_experiments_dir,
                      help="directory to store experiments")
  parser.add_argument("--matmul_precision", default="default", choices=("default", "highest"),
                      help="default: TF32 on for cuDNN and matmuls; highest: TF32 off")
  parser.add_argument("--device", default="cuda")
  args = parser.parse_args(rest)
  return args, config_lib.resolve_config(args.config, overrides, args.hid)


def get_runname(cfg: Dict, config_filename: str, family: str) -> str:
  """<family>-<the script's get_cfg_str(cfg)>."""
  return family + "-" + load_config_module(config_filename).get_cfg_str(cfg)


def _set_matmul_precision(args: argparse.Namespace) -> None:
  # Process-wide, so set here and not in the libraries.
  tf32 = args.matmul_precision == "default"
  torch.backends.cudnn.allow_tf32 = tf32
  torch.backends.cuda.matmul.allow_tf32 = tf32


def run_train_main(family: str, argv: Optional[Sequence[str]] = None,
                   default_experiments_dir: str = "./train_xms"):
  """Body of the train CLIs; returns (the final TrainState, the workdir)."""
  int8ops.assert_training_safe()
  args, cfg = parse_args(argv, default_experiments_dir, f"Train the {family} family.")
  _set_matmul_precision(args)
  from shallow_ntc_tpu_torch import train_lib

  state, workdir = train_lib.train_and_eval_experiment(
      cfg, model_family=family, experiments_dir=args.experiments_dir,
      runname=get_runname(cfg, args.config, family), config_script=args.config,
      device=args.device)
  print(f"trained to step {state.step}; workdir {workdir}")
  return state, workdir


def run_itinf_main(family: str, argv: Optional[Sequence[str]] = None,
                   default_experiments_dir: str = "./itinf_xms"):
  """Body of the itinf CLIs; returns (the workdir, the per-batch metrics)."""
  int8ops.assert_training_safe()
  args, cfg = parse_args(argv, default_experiments_dir,
                         f"SGA iterative inference of the {family} family.")
  _set_matmul_precision(args)
  from shallow_ntc_tpu_torch import itinf_lib

  workdir, metrics = itinf_lib.itinf_eval_experiment(
      cfg, model_family=family, experiments_dir=args.experiments_dir,
      runname=get_runname(cfg, args.config, family), config_script=args.config,
      device=args.device)
  print(f"SGA of {len(metrics)} batches; workdir {workdir}")
  return workdir, metrics
