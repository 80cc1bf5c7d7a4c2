#!/usr/bin/env python
"""Codec latency end to end in the PyTorch port: image -> bitstream and
bitstream -> image, wall ms, per image and in batches.

The port's counterpart of scripts/codec_e2e_bench.py (its arguments and
results/codec_e2e.json's keys, plus "device"; shallow_ntc_tpu_torch/
measure.py: codec_e2e): per-image compress()/decompress() over the first 8
images and the pipelined compress_batch()/decompress_batch() amortized per
image, --repeats times each; the batch decode of image 0 against the
per-image decode (within 1 uint8 on under 5% of the pixels). The model is
a port workdir's (--workdir) or the seeded full-width flagship. Runs on
CUDA unless --device names another device; TF32 off unless --tf32.

  python scripts/torch_codec_e2e_bench.py [--workdir DIR] \\
      [--images 'data/deadleaves/eval/*.png'] [--out results/torch_codec_e2e.json]
"""

import argparse
import glob
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from shallow_ntc_tpu_torch import data as data_lib
from shallow_ntc_tpu_torch import measure
from shallow_ntc_tpu_torch.utils import runname as runname_utils


def main(argv=None):
  p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
  p.add_argument("--images", default="data/deadleaves/eval/*.png")
  p.add_argument("--num_images", type=int, default=24)
  p.add_argument("--chunk_size", type=int, default=8)
  p.add_argument("--repeats", type=int, default=3)
  p.add_argument("--out", default="results/torch_codec_e2e.json")
  measure.add_common_args(p)
  args = p.parse_args(argv)
  device = measure.setup(args)
  paths = sorted(glob.glob(args.images))[:args.num_images]
  if not paths:
    raise SystemExit(f"no images match {args.images}")
  images = [measure.normalized(data_lib.read_png(f)) for f in paths]
  model = measure.load_model(args.workdir, device)
  record = dict(measure.codec_e2e(model, images, args.chunk_size, args.repeats),
                device=measure.device_label(device))
  runname_utils.dump_json(record, args.out)
  print(json.dumps(record, indent=2), flush=True)
  return record


if __name__ == "__main__":
  main()
