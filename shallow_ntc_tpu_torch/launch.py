"""Sweep launcher: fan out a config script's get_hyper() work units (mirrors
the root launch.py).

  python -m shallow_ntc_tpu_torch.launch --main shallow_ntc_tpu_torch.mshyper.train \\
      --config shallow_ntc_tpu_torch/mshyper/configs/two_layer_syn.py [--backend local]

The config script is first copied to <project dir>/slurm_jobs/ (frozen at
submit time), and every work unit reads the copy. Backends:
  local  run `python -m <main> --config <copy> <extra_args> --hid N` for each
         work unit as a subprocess, --parallel at a time, with
         SLURM_ARRAY_JOB_ID (the experiment id, one for the sweep) and
         SLURM_ARRAY_TASK_ID (N) set, so each writes its wid=N- workdir;
  slurm  render slurm_template.py (--gres, default gpu:1) as an array job of
         one task per work unit, submit it with sbatch and link
         <job id>_config.py to the copy.
"""

import argparse
import logging
import os
import shlex
import shutil
import subprocess
import sys
import uuid
from typing import Optional, Sequence

from shallow_ntc_tpu_torch import project_configs
from shallow_ntc_tpu_torch import slurm_template
from shallow_ntc_tpu_torch.utils import config as config_lib


def main(argv: Optional[Sequence[str]] = None) -> None:
  parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
  parser.add_argument("--main", required=True,
                      help="module to run, e.g. shallow_ntc_tpu_torch.mshyper.train")
  parser.add_argument("--config", required=True, help="the config script with get_hyper()")
  parser.add_argument("--backend", default="local", choices=("local", "slurm"))
  parser.add_argument("--parallel", type=int, default=1, help="local: concurrent work units")
  parser.add_argument("--extra_args", default="", help="flags forwarded to the main module")
  parser.add_argument("--gres", default="gpu:1", help="slurm: generic resource per task")
  args = parser.parse_args(argv)

  num_units = len(config_lib.load_config_module(args.config).get_hyper())
  logging.info("Sweep has %d work units", num_units)
  jobs_dir = project_configs.slurm_jobs_dir
  os.makedirs(jobs_dir, exist_ok=True)
  frozen = os.path.join(jobs_dir, f"{uuid.uuid4().hex[:8]}_{os.path.basename(args.config)}")
  shutil.copy(args.config, frozen)
  base_cmd = [sys.executable, "-m", args.main, "--config", frozen,
              *shlex.split(args.extra_args)]

  if args.backend == "slurm":
    script = slurm_template.render(
        job_name=args.main.split(".")[-1], last_hid=num_units - 1, jobs_dir=jobs_dir,
        project_dir=project_configs.project_dir,
        srun_command=f"srun {shlex.join(base_cmd)} --hid $SLURM_ARRAY_TASK_ID",
        gres=args.gres)
    script_path = os.path.splitext(frozen)[0] + ".sbatch"
    with open(script_path, "w") as f:
      f.write(script)
    job_id = subprocess.check_output(["sbatch", "--parsable", script_path]).decode().strip()
    logging.info("Submitted sbatch job %s", job_id)
    os.symlink(os.path.basename(frozen), os.path.join(jobs_dir, f"{job_id}_config.py"))
    return

  xid = os.environ.get("SLURM_ARRAY_JOB_ID", uuid.uuid4().hex[:8])
  logging.info("Experiment id (xid): %s", xid)
  procs = []
  for hid in range(num_units):
    cmd = base_cmd + ["--hid", str(hid)]
    logging.info("Launching: %s", shlex.join(cmd))
    env = dict(os.environ, SLURM_ARRAY_TASK_ID=str(hid), SLURM_ARRAY_JOB_ID=xid)
    procs.append(subprocess.Popen(cmd, env=env))
    while sum(p.poll() is None for p in procs) >= args.parallel:
      next(p for p in procs if p.poll() is None).wait()
  failed = [rc for rc in (p.wait() for p in procs) if rc]
  if failed:
    raise RuntimeError(f"{len(failed)} work unit(s) failed, exit codes {failed}")


if __name__ == "__main__":
  logging.basicConfig(level=logging.INFO)
  main()
