"""sbatch array-job template for sweep fan-out (a copy of the root
slurm_template.py with a GPU as the default resource).

Each array task is an independent work unit running one get_hyper() entry
(`--hid $SLURM_ARRAY_TASK_ID`) on one GPU.
"""

template = """#!/bin/bash
#SBATCH --job-name={job_name}
#SBATCH --array=0-{last_hid}
#SBATCH --output={jobs_dir}/%A_%a.out
#SBATCH --nodes=1
#SBATCH --ntasks=1
#SBATCH --cpus-per-task=8
#SBATCH --mem=16G
{gres_line}

set -euo pipefail
echo "host: $(hostname); job: $SLURM_ARRAY_JOB_ID; task: $SLURM_ARRAY_TASK_ID"

cd {project_dir}
{srun_command}
"""


def render(job_name, last_hid, jobs_dir, project_dir, srun_command, gres="gpu:1"):
  gres_line = f"#SBATCH --gres={gres}" if gres else ""
  return template.format(
      job_name=job_name,
      last_hid=last_hid,
      jobs_dir=jobs_dir,
      project_dir=project_dir,
      srun_command=srun_command,
      gres_line=gres_line,
  )
