#!/usr/bin/env python
"""Compress / decompress latency of one image in the PyTorch port, with the
bitstream's overhead over the likelihood bound.

The port's counterpart of scripts/codec_latency.py (its arguments, --device
for its --cpu, and its numbers as JSON; shallow_ntc_tpu_torch/measure.py:
codec_latency): the blob's bytes, bpp and stripes per tensor
(codec.api.stream_counts); the likelihood-bound bpp of the eval path and the
overhead over it; the decompress wall ms (min and median of --reps), its
output equal to the compressor's reconstruction; the host's y decode,
striped as the codec codes it and as one stream, in ms and Msym/s.

The image is --image, or, where that file is absent (the repository holds
no data/), deadleaves_image(900000, 512, 768): the image
scripts/make_deadleaves_dataset.py writes as dle000.png. The model is a
port workdir's (--workdir) or the seeded full-width flagship. Runs on CUDA
unless --device names another device; TF32 off unless --tf32.

  python scripts/torch_codec_latency.py [--workdir DIR] [--image img.png] [--out x.json]
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from shallow_ntc_tpu_torch import data as data_lib
from shallow_ntc_tpu_torch import deadleaves
from shallow_ntc_tpu_torch import measure
from shallow_ntc_tpu_torch.utils import runname as runname_utils


def main(argv=None):
  p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
  p.add_argument("--image", default="data/deadleaves/eval/dle000.png")
  p.add_argument("--reps", type=int, default=5)
  p.add_argument("--out", default=None)
  measure.add_common_args(p)
  args = p.parse_args(argv)
  device = measure.setup(args)
  model = measure.load_model(args.workdir, device)
  if os.path.isfile(args.image):
    image_u8, source = data_lib.read_png(args.image), args.image
  else:
    image_u8, source = deadleaves.deadleaves_image(900000, 512, 768), "deadleaves_image(900000)"
  rec = dict(image=source, device=measure.device_label(device),
             **measure.codec_latency(model, measure.normalized(image_u8), args.reps))
  print(f"image {rec['height']}x{rec['width']}: {rec['bytes']} bytes = {rec['bpp']:.4f} bpp, "
        f"streams per tensor: {rec['stream_counts']}")
  print(f"likelihood bound {rec['likelihood_bpp']:.4f} bpp -> overhead "
        f"{rec['overhead_pct']:.3f}% (budget <= 0.5%)")
  print(f"decompress wall: {rec['decompress_ms_min']:.1f} ms "
        f"(median {rec['decompress_ms_median']:.1f})")
  print(f"host y-decode [striped]: {rec['y_decode_striped_ms']:.2f} ms "
        f"({rec['y_decode_striped_Msym_per_s']:.1f} Msym/s, {rec['y_streams']} streams)")
  print(f"host y-decode [single-stream]: {rec['y_decode_single_ms']:.2f} ms "
        f"({rec['y_decode_single_Msym_per_s']:.1f} Msym/s)", flush=True)
  if args.out:
    runname_utils.dump_json(rec, args.out)
  if not rec["reconstruction_equal"]:
    raise SystemExit("the decompressed image differs from the compressor's reconstruction")
  return rec


if __name__ == "__main__":
  main()
