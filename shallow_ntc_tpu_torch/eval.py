"""Eval CLI of the port: per-image R-D metrics of a model -> JSON.

  python -m shallow_ntc_tpu_torch.eval --workdir train_xms/<xid>/wid=0-mshyper-... \\
      --dataset deadleaves_eval
  python -m shallow_ntc_tpu_torch.eval --init_seed 0 --dataset synthetic \\
      --results_dir /tmp/results
  python -m shallow_ntc_tpu_torch.eval --params params.npz --images 'imgs/*.npy'
  python -m shallow_ntc_tpu_torch.eval --config jpegl_rd --init_seed 0 --dataset synthetic

Weights come from exactly one of --workdir (a trained workdir: the model of
its config.json and its newest checkpoint, as the root eval.py), --params
(an .npz whose keys are flax parameter paths, "_analysis/Conv_0/kernel",
..., with an optional "step" entry) or --init_seed (a seeded full-width
init). --config picks the model of --params and --init_seed, its family and
run name: two_layer_syn_rd (the flagship, the default), jpegl_rd,
two_layer_syn2, mbt2018, bls2017_rd or bls2017. --dataset is "synthetic",
a name of project_configs.dataset_to_globs or a glob of PNG (or .npy)
images, read in --batchsize batches, centre-cropped to --patchsize when
given; --images is a glob of .npy [H, W, 3] images. Results go to
--results_dir (default ./json_results/<dataset>/end_to_end): for a workdir
<run name>-step=<n>-xid=<xid>.json, kept when it exists unless
--noskip_existing; with --workdir, --profile adds the transforms' times to
each record and writes into profile/device=<gpu|cpu>-host=<host>/ below it,
with a link to the file beside it. --model_family overrides the family
that config.json names; --models_path is a Python file whose `Model` class
replaces it.
Runs on CUDA unless --device names another device.
--matmul_precision highest (the default, as the JAX eval's) turns TF32 off
for cuDNN convolutions and matmuls; default leaves TF32 on.
--decode_dtype int8_syn runs the synthesis's convolutions on int8 operands
(the rate stays the float path's bit for bit), int8_all the hyper-decoder's
too (ops/int8ops.py); float (the default) leaves SNTC_INT8_DECODE in charge.
Each record gets "lpips" when the LPIPS weights file exists
(models/lpips.default_weights_path); without it the metric is omitted.
--spatial_devices N splits each image's height over cuda:0 ... cuda:N-1 for
the analysis and the synthesis (eval_lib.evaluate_images), as the JAX
eval's spatial sharding.
"""

import argparse
import logging
import os
import socket
from typing import Optional, Sequence

import torch

from shallow_ntc_tpu_torch import configs
from shallow_ntc_tpu_torch import data as data_lib
from shallow_ntc_tpu_torch import eval_lib
from shallow_ntc_tpu_torch.models import lpips
from shallow_ntc_tpu_torch.ops import int8ops
from shallow_ntc_tpu_torch.parallel import mesh

# --decode_dtype -> int8ops.decode_mode (None: the environment's mode).
DECODE_MODES = {"float": None, "int8_syn": "syn", "int8_all": "all"}


def main(argv: Optional[Sequence[str]] = None) -> Optional[str]:
  parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
  weights = parser.add_mutually_exclusive_group(required=True)
  weights.add_argument("--workdir", help="a trained workdir (config.json + checkpoints)")
  weights.add_argument("--params", help=".npz of flax parameter paths -> arrays")
  weights.add_argument("--init_seed", type=int, help="seed of a flax-style random init")
  source = parser.add_mutually_exclusive_group(required=True)
  source.add_argument("--dataset", help="synthetic, a dataset name or a file glob")
  source.add_argument("--images", help="glob of .npy images, [H, W, 3] pixels 0..255")
  parser.add_argument("--batchsize", type=int, default=1, help="size of eval data batches")
  parser.add_argument("--patchsize", type=int,
                      help="centre-cropped patch size (default: whole images; synthetic 256)")
  parser.add_argument("--results_dir", help="default ./json_results/<dataset>/end_to_end")
  parser.add_argument("--skip_existing", action="store_true", default=True,
                      help="keep a workdir's existing results file (the default)")
  parser.add_argument("--noskip_existing", dest="skip_existing", action="store_false")
  parser.add_argument("--profile", action="store_true",
                      help="add the transforms' times; results go to a per-device profile dir")
  parser.add_argument("--model_family", choices=("mshyper", "factorized"),
                      help="the family of --workdir (default: from its config.json)")
  parser.add_argument("--models_path", help="a Python file defining a torch `Model` class")
  parser.add_argument("--device", default="cuda")
  parser.add_argument("--config", default="two_layer_syn_rd", choices=configs.EVAL_CONFIG_NAMES)
  parser.add_argument("--matmul_precision", default="highest", choices=("highest", "default"))
  parser.add_argument("--decode_dtype", default="float", choices=sorted(DECODE_MODES))
  parser.add_argument("--spatial_devices", type=int, default=1,
                      help="split each image's height over this many GPUs")
  args = parser.parse_args(argv)
  if args.profile and args.workdir is None:
    parser.error("--profile times a --workdir's model")
  # Process-wide, so set here and not in eval_lib: a library must not change
  # its caller's numerics.
  tf32 = args.matmul_precision == "default"
  torch.backends.cudnn.allow_tf32 = tf32
  torch.backends.cuda.matmul.allow_tf32 = tf32
  device = eval_lib.resolve_device(args.device)
  devices = mesh.spatial_device_list(args.spatial_devices)

  if args.dataset is not None:
    images = data_lib.get_dataset(args.dataset, "test", args.batchsize, args.patchsize)
    results_dir = args.results_dir or f"./json_results/{args.dataset}/end_to_end"
  else:
    images = data_lib.npy_images(args.images)
    results_dir = args.results_dir or "./json_results/torch"
  noprofile_results_dir = results_dir
  if args.profile:
    profile_sub = os.path.join(
        "profile", f"device={'gpu' if device.type == 'cuda' else device.type}-"
                   f"host={socket.gethostname()}")
    results_dir = os.path.join(results_dir, profile_sub)
  try:
    lpips_fn = lpips.make_lpips_fn(device=device)
  except FileNotFoundError as e:
    logging.warning("LPIPS unavailable (%s); omitting the metric.", e)
    lpips_fn = None

  with int8ops.decode_mode(DECODE_MODES[args.decode_dtype]):
    if args.workdir is not None:
      model_cls = eval_lib.load_model_class(args.models_path) if args.models_path else None
      path = eval_lib.eval_workdir(
          args.workdir, images, args.dataset or args.images, results_dir,
          skip_existing=args.skip_existing, model_family=args.model_family,
          lpips_fn=lpips_fn, profile=args.profile, model_cls=model_cls, device=args.device,
          devices=devices)
    else:
      model_config, runname, family = configs.eval_config(args.config)
      step = 0
      if args.params is not None:
        params, step = eval_lib.read_params(args.params)
        model = eval_lib.build_model(model_config, params=params, device=args.device,
                                     family=family)
        xid = os.path.splitext(os.path.basename(args.params))[0]
      else:
        model = eval_lib.build_model(model_config, init_seed=args.init_seed,
                                     device=args.device, family=family)
        xid = f"init_seed={args.init_seed}"
      path = eval_lib.eval_to_json(model, images, results_dir, runname, xid, step, lpips_fn,
                                   devices)

  if args.profile and path:
    # A link in the common results directory (the root eval.py's).
    os.makedirs(noprofile_results_dir, exist_ok=True)
    link = os.path.join(noprofile_results_dir, os.path.basename(path))
    target = os.path.join(profile_sub, os.path.basename(path))
    if os.path.lexists(link) and not args.skip_existing:
      os.unlink(link)
    if not os.path.lexists(link):
      os.symlink(target, link)
  print(path)
  return path


if __name__ == "__main__":
  main()
