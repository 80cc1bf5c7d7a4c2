#!/usr/bin/env python3
"""Where a fresh process of the port's codec CLI spends its time on the GPU.

  python3 scripts/torch_cli_time.py [--trees DIR [DIR ...]] [--reps 3]

Each DIR is a checkout of the repo (default: this one); give two to compare
them on one machine. For each it first builds the CUDA kernels and the rANS
coder in a process of its own. Then, --reps times and alternating which tree
goes first, it runs the pair that chip_smoke.py's "codec" phase runs: `python
-m shallow_ntc_tpu_torch.compress compress`, then `decompress`, of a seeded
512x768 image at --init_seed 0, each in a fresh process. Each process reports
the seconds it took to import torch, to initialise CUDA, to import the CLI's
module and to run its main(); the rest of the process's wall time is the
interpreter's start and exit. Needs CUDA.
"""

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

_BUILD = """
from shallow_ntc_tpu_torch.codec import bindings
from shallow_ntc_tpu_torch.ops import cuda_build, jpegl_decode, rb_chain, resblock, twolayer_final
for m in (twolayer_final, rb_chain, resblock, jpegl_decode):
  cuda_build.build(m.SOURCE)
bindings.build()
"""

_TIMED_CLI = """
import json, sys, time
t0 = time.time()
import torch
t1 = time.time()
torch.cuda.init()
t2 = time.time()
from shallow_ntc_tpu_torch import compress
t3 = time.time()
compress.main(sys.argv[1:])
torch.cuda.synchronize()
t4 = time.time()
print("TIMES " + json.dumps(dict(import_torch=t1 - t0, cuda_init=t2 - t1, import_cli=t3 - t2,
                                 main=t4 - t3)))
"""


def _run(tree, args, cwd, code):
  env = dict(os.environ, PYTHONPATH=tree)
  t = time.time()
  proc = subprocess.run([sys.executable, "-c", code, *args], cwd=cwd, env=env,
                        capture_output=True, text=True, timeout=600)
  wall = time.time() - t
  if proc.returncode:
    sys.exit(f"{tree}: {proc.stderr[-3000:]}")
  return wall, proc.stdout


def main():
  parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
  parser.add_argument("--trees", nargs="+",
                      default=[os.path.dirname(os.path.dirname(os.path.abspath(__file__)))])
  parser.add_argument("--reps", type=int, default=3)
  args = parser.parse_args()
  trees = [os.path.abspath(t) for t in args.trees]
  for tree in trees:
    wall, _ = _run(tree, [], tree, _BUILD)
    print(f"{tree}: kernels and rANS coder built in {wall:.1f} s", flush=True)
  with tempfile.TemporaryDirectory() as tmp:
    image = np.random.default_rng(0).integers(0, 256, (512, 768, 3)).astype(np.uint8)
    np.save(os.path.join(tmp, "img.npy"), image)
    for rep in range(args.reps):
      for tree in (trees if rep % 2 == 0 else trees[::-1]):
        pair = 0.0
        for argv in (["compress", "--input", "img.npy", "--output", "img.sntc"],
                     ["decompress", "--input", "img.sntc", "--output", "rec.npy"]):
          wall, out = _run(tree, argv + ["--init_seed", "0"], tmp, _TIMED_CLI)
          times = json.loads(out.split("TIMES ", 1)[1])
          times["start_and_exit"] = wall - sum(times.values())
          pair += wall
          print(f"rep {rep} {tree} {argv[0]}: {wall:.3f} s: "
                + ", ".join(f"{k} {v:.3f}" for k, v in times.items()), flush=True)
        print(f"rep {rep} {tree} pair: {pair:.3f} s", flush=True)


if __name__ == "__main__":
  main()
