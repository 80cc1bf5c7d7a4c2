"""Eval launcher: one eval job per trained workdir (mirrors the root
launch_eval.py).

  python -m shallow_ntc_tpu_torch.launch_eval --workdirs 'train_xms/*/wid=*' \\
      --dataset deadleaves_eval [--backend local]

Each job is `python -m shallow_ntc_tpu_torch.eval --workdir <dir> --dataset
<dataset> <extra_args>`: run here one after another (local), or submitted
as a one-task sbatch job each (slurm, slurm_template.py, --gres default
gpu:1).
"""

import argparse
import glob
import logging
import os
import shlex
import subprocess
import sys
import uuid
from typing import Optional, Sequence

from shallow_ntc_tpu_torch import project_configs
from shallow_ntc_tpu_torch import slurm_template


def main(argv: Optional[Sequence[str]] = None) -> None:
  parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
  parser.add_argument("--workdirs", required=True, help="glob of workdirs to evaluate")
  parser.add_argument("--dataset", required=True, help="dataset to evaluate on")
  parser.add_argument("--backend", default="local", choices=("local", "slurm"))
  parser.add_argument("--extra_args", default="", help="flags forwarded to the eval CLI")
  parser.add_argument("--gres", default="gpu:1", help="slurm: generic resource per task")
  args = parser.parse_args(argv)

  workdirs = sorted(glob.glob(args.workdirs))
  if not workdirs:
    raise RuntimeError(f"No workdirs match {args.workdirs!r}")
  logging.info("Evaluating %d workdirs", len(workdirs))
  for wd in workdirs:
    cmd = [sys.executable, "-m", "shallow_ntc_tpu_torch.eval", "--workdir", wd,
           "--dataset", args.dataset, *shlex.split(args.extra_args)]
    if args.backend == "slurm":
      jobs_dir = project_configs.slurm_jobs_dir
      os.makedirs(jobs_dir, exist_ok=True)
      script = slurm_template.render(
          job_name="eval", last_hid=0, jobs_dir=jobs_dir,
          project_dir=project_configs.project_dir, srun_command=f"srun {shlex.join(cmd)}",
          gres=args.gres)
      path = os.path.join(jobs_dir, f"eval_{uuid.uuid4().hex[:8]}.sbatch")
      with open(path, "w") as f:
        f.write(script)
      subprocess.check_call(["sbatch", path])
    else:
      logging.info("Running: %s", shlex.join(cmd))
      subprocess.check_call(cmd)


if __name__ == "__main__":
  logging.basicConfig(level=logging.INFO)
  main()
