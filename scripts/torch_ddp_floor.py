#!/usr/bin/env python3
"""How far a data-parallel run of the port can agree with one process on the GPU.

  python3 scripts/torch_ddp_floor.py

Trains the flagship (two_layer_syn_rd.py --hid 3, full width) 3 steps at
B=8 256x256 on synthetic images, lr 1e-4 without warm-up, TF32 off, the
residual-block chain kernel on, through the train CLI, in these runs:

  A, A2      one process, twice, with cuDNN's default algorithms;
  ddp        --dp_devices 2 --dist_backend gloo (two ranks sharing cuda:0);
  ctl        the same two ranks with the loss called past DDP, so that each
             steps on its own half-batch gradients (the control);
  Adet, Adet2, ddpdet
             A, A2 and ddp under torch.use_deterministic_algorithms with
             cuDNN deterministic and no autotuning.

Every run keeps the checkpoint of each step. For each pair it prints the
rd_loss of each step relative to the reference's and, at each step, the
params against the reference's at the JAX package's data-parallel tolerance
(tests/test_parallel.py: rtol 2e-3, atol 2e-6): the largest |diff| over its
tolerance, the tensor it lies in, how many elements exceed it, whether all
are equal bit for bit, and the change from the seeded init (p - p0) as one
vector, its L2 distance over its norm. Needs CUDA; about 2 minutes.
"""

import json
import os
import sys
import tempfile
import time

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

SCRIPT = "shallow_ntc_tpu_torch/mshyper/configs/two_layer_syn_rd.py"


def _deterministic():
  torch.use_deterministic_algorithms(True, warn_only=True)
  torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False


def det_rank(rank, *args):
  from shallow_ntc_tpu_torch.utils import cli

  _deterministic()
  return cli._train_rank(rank, *args)


def unsynced_rank(rank, *args):
  from shallow_ntc_tpu_torch.parallel import mesh
  from shallow_ntc_tpu_torch.utils import cli

  mesh.data_parallel = mesh.FrameLoss
  return cli._train_rank(rank, *args)


def main():
  from shallow_ntc_tpu_torch import train_lib
  from shallow_ntc_tpu_torch.ops import cuda_build, rb_chain, twolayer_final
  from shallow_ntc_tpu_torch.utils import cli
  from shallow_ntc_tpu_torch.utils import config as config_lib

  os.chdir(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
  for source in (twolayer_final.SOURCE, rb_chain.SOURCE):
    cuda_build.build(source)  # before the ranks, which would race to build
  print("nvidia-smi:", os.popen("nvidia-smi --query-gpu=name,power.limit "
                                "--format=csv,noheader").read().strip())
  tmp = tempfile.mkdtemp()
  base = config_lib.load_config_module(SCRIPT).get_config()
  optimizer = dict(base["model_config"]["optimizer_config"], warmup_until=0.0)
  train_eval = dict(base["train_eval_config"], num_steps=3, log_metrics_every_steps=1,
                    eval_every_steps=3, checkpoint_every_steps=1, max_validation_steps=1,
                    max_to_keep=3)
  td, vd = "--config.train_data_config.", "--config.val_data_config."
  os.environ.update(SLURM_ARRAY_TASK_ID="3", SNTC_FUSED_RB_CHAIN="1")
  real_rank = cli._train_rank
  dirs = {}

  def run(xid, dp_devices, rank_fn=None, det=False):
    os.environ["SLURM_ARRAY_JOB_ID"] = xid
    argv = ["--config", SCRIPT, "--hid", "3", "--matmul_precision", "highest",
            f"--config.model_config.optimizer_config={optimizer!r}",
            f"--config.train_eval_config={train_eval!r}",
            "--experiments_dir", os.path.join(tmp, xid), f"{td}dataset=synthetic",
            f"{td}batchsize=8", f"{td}patchsize=256", f"{vd}dataset=synthetic",
            f"{vd}batchsize=2", f"{vd}patchsize=256", "--dp_devices", str(dp_devices)]
    if dp_devices > 1:
      argv += ["--dist_backend", "gloo"]
    cli._train_rank = rank_fn or real_rank
    if det:
      _deterministic()
    try:
      t = time.time()
      _, dirs[xid] = cli.run_train_main("mshyper", argv)
      print(f"{xid}: {time.time() - t:.1f} s", flush=True)
    finally:
      cli._train_rank = real_rank
      torch.use_deterministic_algorithms(False)
      torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = False, False

  run("A", 1)
  run("A2", 1)
  run("ddp", 2)
  run("ctl", 2, unsynced_rank)
  run("Adet", 1, det=True)
  run("Adet2", 1, det=True)
  run("ddpdet", 2, det_rank)

  with open(os.path.join(dirs["A"], "config.json")) as f:
    init, _ = train_lib.build_model(json.load(f)["model_config"], 0, "cuda")
  p0 = {k: v.detach().cpu() for k, v in init.state_dict().items()}

  def params(xid, step):
    path = os.path.join(train_lib.checkpoint_dir(dirs[xid]), f"ckpt_{step}.pt")
    return torch.load(path, map_location="cpu", weights_only=True)["model"]

  def losses(xid):
    with open(os.path.join(dirs[xid], "train", "record.jsonl")) as f:
      return [json.loads(line)["rd_loss"] for line in f]

  def compare(xid, ref):
    rel = [abs(a - b) / abs(b) for a, b in zip(losses(xid), losses(ref))]
    print(f"== {xid} against {ref}: rd_loss rel {rel}")
    for step in (1, 2, 3):
      p, q = params(xid, step), params(ref, step)
      ratio = {k: (p[k] - q[k]).abs() / (2e-6 + 2e-3 * q[k].abs()) for k in q}
      worst = max(ratio, key=lambda k: ratio[k].max().item())
      d = torch.cat([(p[k] - p0[k]).flatten() for k in p0])
      d_ref = torch.cat([(q[k] - p0[k]).flatten() for k in p0])
      print(f"   step {step}: max |diff| / tol {ratio[worst].max().item():.4f} in {worst}; "
            f"{sum(int((r > 1).sum()) for r in ratio.values())} of {d.numel()} elements over; "
            f"bit for bit {all(torch.equal(p[k], q[k]) for k in q)}; change rel "
            f"{((d - d_ref).norm() / d_ref.norm()).item():.4e}")

  for xid, ref in (("A2", "A"), ("ddp", "A"), ("ctl", "A"), ("Adet2", "Adet"),
                   ("ddpdet", "Adet"), ("ddp", "ddpdet")):
    compare(xid, ref)


if __name__ == "__main__":
  if not torch.cuda.is_available():
    sys.exit("torch_ddp_floor: needs CUDA")
  main()
