"""Run an entry point and write the port's kernel launch counts at its end.

  python -m shallow_ntc_tpu_torch.utils.counted COUNTS_JSON TARGET [ARGS ...]

TARGET is a module, run as `python -m TARGET ARGS ...` runs it, or a script
path ending in .py, run as `python TARGET ARGS ...` runs it. When it ends
(also by an exception, or by SIGTERM, which exits with 143) the launches of
each CUDA kernel of the port in this process, which start at 0, go to
COUNTS_JSON as {kernel name: launches}. chip_smoke.py and
scripts/torch_rd_run.py count each CLI they drive through it.
"""

import json
import runpy
import signal
import sys


def _stop(signum, frame):
  raise SystemExit(143)


def main(argv=None):
  counts_path, *target = sys.argv[1:] if argv is None else argv
  sys.argv = target
  signal.signal(signal.SIGTERM, _stop)
  try:
    if target[0].endswith(".py"):
      runpy.run_path(target[0], run_name="__main__")
    else:
      runpy.run_module(target[0], run_name="__main__", alter_sys=True)
  finally:
    import torch

    from shallow_ntc_tpu_torch.ops import jpegl_decode, rb_chain, resblock, twolayer_final

    if torch.cuda.is_available():
      torch.cuda.synchronize()
    with open(counts_path, "w") as f:
      json.dump({m.STATS.name: m.STATS.launches
                 for m in (twolayer_final, rb_chain, resblock, jpegl_decode)}, f)


if __name__ == "__main__":
  main()
