#!/usr/bin/env python
"""SGA workdirs of the PyTorch port -> eval-style result JSONs.

The port's counterpart of scripts/itinf_to_results.py (the same arguments
and records): each workdir's metrics.json, the per-batch val metrics of
python -m shallow_ntc_tpu_torch.mshyper.itinf, becomes
<out>/<family>+sga-lmbda=<lambda>-step=<steps>-xid=<xid>.json, which
scripts/aggregate_results.py folds into aggregate.json beside the eval's
files (shallow_ntc_tpu_torch/results.py: itinf_workdir_to_records).

Usage:
  python scripts/torch_itinf_to_results.py --itinf_glob 'itinf_xms/*/*' \\
      --out json_results/deadleaves/sga
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from shallow_ntc_tpu_torch import results


def main(argv=None):
  p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
  p.add_argument("--itinf_glob", required=True,
                 help="Glob of itinf workdirs (each holding metrics.json).")
  p.add_argument("--out", required=True)
  args = p.parse_args(argv)

  dirs = results.workdirs_with(args.itinf_glob, "metrics.json")
  if not dirs:
    raise SystemExit(f"No itinf workdirs with metrics.json match {args.itinf_glob!r}")
  paths, failures = [], 0
  for d in dirs:
    try:
      paths.append(results.convert_itinf_workdir(d, args.out))
      print("wrote", paths[-1])
    except (OSError, KeyError, ValueError) as e:
      # One unconvertible workdir (a warm-start directory that is gone) does
      # not stop the rest of a sweep.
      failures += 1
      print(f"SKIP {d}: {type(e).__name__}: {e}", file=sys.stderr)
  if failures == len(dirs):
    raise SystemExit("every itinf workdir failed to convert")
  return paths


if __name__ == "__main__":
  main()
