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
CUDA unless --device names another device. --dispatch issues the train or
SGA steps (step_graph.py): auto, the default, captures each step once as a
CUDA graph and replays it on the card, and runs it eagerly on the CPU and
in a process group; eager asks for the eager loop on the card.
--seed (train) seeds the init, the data and the training noise (0, as the
JAX package's). An int8 gate left on
(SNTC_INT8_DECODE, SNTC_INT8_ENCODE) is an error: its quantizers have no
gradient.

The train CLIs train data-parallel with one process per device, as the JAX
CLIs' flags say (shallow_ntc_tpu/utils/cli.py:29-50, :81-103):
  --dp_devices N      N local ranks on 127.0.0.1 and a free port, started
                      with torch.multiprocessing's spawn; rank i on cuda:i
                      (cuda:i mod the device count under gloo). The default
                      is every visible GPU (1 with --device cpu); 1 is the
                      plain loop.
  --coordinator host:port --num_processes P --process_id i
                      join a group of P ranks as rank i, on
                      cuda:(i mod the device count); not with --dp_devices.
The backend is nccl on CUDA and gloo on the CPU; --dist_backend gloo lets
ranks share a card, which nccl refuses.
"""

import argparse
import multiprocessing
import socket
import sys
from typing import Dict, Optional, Sequence, Tuple

import torch

from shallow_ntc_tpu_torch.ops import int8ops
from shallow_ntc_tpu_torch.parallel import distributed
from shallow_ntc_tpu_torch.utils import config as config_lib
from shallow_ntc_tpu_torch.utils.config import load_config_module


def parse_args(argv: Optional[Sequence[str]], default_experiments_dir: str,
               description: str, parallel: bool = False) -> Tuple[argparse.Namespace, Dict]:
  """(the parsed flags, the resolved config) of a train (parallel=True: with
  the data-parallel flags) or itinf command line."""
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
  parser.add_argument("--dispatch", default="auto", choices=("auto", "eager"),
                      help="auto: a CUDA graph a step on the card, eager elsewhere")
  if parallel:
    parser.add_argument("--seed", type=int, default=0,
                        help="seed of the init, the data and the training noise")
    parser.add_argument("--dp_devices", type=int,
                        help="number of devices for data-parallel training (default: all)")
    parser.add_argument("--coordinator", help="host:port of rank 0; joins a process group")
    parser.add_argument("--num_processes", type=int, help="the group's process count")
    parser.add_argument("--process_id", type=int, help="this process's rank")
    parser.add_argument("--dist_backend", choices=("nccl", "gloo"),
                        help="default: nccl on CUDA, gloo on the CPU")
    parser.add_argument("--max_to_keep", type=int,
                        help="checkpoints kept, the newest; 0 keeps every one (default: "
                             "train_eval_config.max_to_keep, else 1)")
  args = parser.parse_args(rest)
  if parallel and args.coordinator:
    if args.dp_devices is not None:
      parser.error("--dp_devices starts local ranks; --coordinator joins a group: not both")
    if args.num_processes is None or args.process_id is None:
      parser.error("--coordinator needs --num_processes and --process_id")
  cfg = config_lib.resolve_config(args.config, overrides, args.hid)
  if parallel and args.max_to_keep is not None:
    cfg["train_eval_config"]["max_to_keep"] = args.max_to_keep
  return args, cfg


def get_runname(cfg: Dict, config_filename: str, family: str) -> str:
  """<family>-<the script's get_cfg_str(cfg)>."""
  return family + "-" + load_config_module(config_filename).get_cfg_str(cfg)


def _set_matmul_precision(args: argparse.Namespace) -> None:
  # Process-wide, so set here and not in the libraries.
  tf32 = args.matmul_precision == "default"
  torch.backends.cudnn.allow_tf32 = tf32
  torch.backends.cuda.matmul.allow_tf32 = tf32


def _free_port() -> int:
  with socket.socket() as s:
    s.bind(("127.0.0.1", 0))
    return s.getsockname()[1]


def _train(args: argparse.Namespace, cfg: Dict, family: str, device: str):
  from shallow_ntc_tpu_torch import train_lib

  return train_lib.train_and_eval_experiment(
      cfg, model_family=family, experiments_dir=args.experiments_dir,
      runname=get_runname(cfg, args.config, family), config_script=args.config,
      device=device, seed=args.seed, dispatch=args.dispatch)


def _train_rank(rank: int, world: int, coordinator: str, args: argparse.Namespace, cfg: Dict,
                family: str, workdir_queue=None):
  """One rank of a data-parallel run: join the group, train, leave. Rank 0
  puts the workdir on `workdir_queue` when given."""
  device = torch.device(args.device)
  if device.type == "cuda":
    device = torch.device("cuda", rank % torch.cuda.device_count())
    torch.cuda.set_device(device)
  _set_matmul_precision(args)  # a spawned rank starts from a fresh interpreter
  distributed.initialize(coordinator, world, rank, args.dist_backend, device)
  try:
    state, workdir = _train(args, cfg, family, str(device))
    if workdir_queue is not None and rank == 0:
      workdir_queue.put(workdir)
    return state, workdir
  finally:
    distributed.shutdown()


def run_train_main(family: str, argv: Optional[Sequence[str]] = None,
                   default_experiments_dir: str = "./train_xms"):
  """Body of the train CLIs; returns (the final TrainState, the workdir). A
  run of --dp_devices N > 1 returns (None, the workdir): its states lived in
  the spawned ranks."""
  int8ops.assert_training_safe()
  args, cfg = parse_args(argv, default_experiments_dir, f"Train the {family} family.",
                         parallel=True)
  _set_matmul_precision(args)
  if args.coordinator:
    state, workdir = _train_rank(args.process_id, args.num_processes, args.coordinator, args,
                                 cfg, family)
  else:
    cuda = torch.device(args.device).type == "cuda"
    n = args.dp_devices
    if n is None:
      n = torch.cuda.device_count() if cuda else 1
    if n <= 1:
      state, workdir = _train(args, cfg, family, args.device)
    else:
      if cuda and args.dist_backend != "gloo" and n > torch.cuda.device_count():
        raise ValueError(f"--dp_devices {n} but {torch.cuda.device_count()} GPUs: nccl takes "
                         "one rank a GPU (--dist_backend gloo shares them)")
      from shallow_ntc_tpu_torch import train_lib

      queue = multiprocessing.get_context("spawn").SimpleQueue()
      torch.multiprocessing.start_processes(
          _train_rank, args=(n, f"127.0.0.1:{_free_port()}", args, cfg, family, queue),
          nprocs=n, start_method="spawn")
      workdir = queue.get()
      print(f"{n} ranks trained to the checkpoint of step "
            f"{train_lib.latest_checkpoint_step(workdir)}; workdir {workdir}")
      return None, workdir
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
      device=args.device, dispatch=args.dispatch)
  print(f"SGA of {len(metrics)} batches; workdir {workdir}")
  return workdir, metrics
