#!/usr/bin/env python
"""High-resolution codec end to end in the PyTorch port: a 2048x1536 image
through the codec unsplit and in height strips.

The port's counterpart of scripts/spatial_codec_e2e.py (its arguments and
output keys; shallow_ntc_tpu_torch/measure.py: spatial_codec_e2e):

  --mode card   the model on one card (--device, default cuda): the codec
                unsplit and with devices=[cuda:0] * N for N = 2 and
                --spatial_devices (the strips run one after another on the
                one card); warm compress and decompress wall seconds, bpp,
                PSNR against the source and the peak of
                torch.cuda.max_memory_allocated of each setting; each self
                round trip bit for bit; the unsplit bitstream decoded by the
                N-strip codec and the reverse (within 1 uint8, bpp equal to
                rtol 1e-4), whether the bitstreams are byte-equal and how
                many y symbols differ; the eval unsplit and in the same
                strips (bpp, PSNR, rd_loss within rtol 1e-4).
  --mode cpu    the same with [cpu] * N: JAX's mesh mode.

The image is deadleaves_image(777000, height, width), as the JAX script's.
The model is a port workdir's (--workdir) or the seeded full-width flagship
(configs.TWO_LAYER_SYN_RD, init seed 0). TF32 off unless --tf32. Results
merge into --out under "<mode>_single_device" (the JAX chip mode's keys),
"<mode>_spatial" (the mesh mode's keys) and "<mode>_detail"; each gets
"device", the card's name and power limit from nvidia-smi. A failed check
exits non-zero after the file is written.

  python scripts/torch_spatial_codec_e2e.py [--mode card] [--workdir DIR]
  python scripts/torch_spatial_codec_e2e.py --mode cpu --height 256 --width 128
"""

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from shallow_ntc_tpu_torch import deadleaves
from shallow_ntc_tpu_torch import measure


def main(argv=None):
  p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
  p.add_argument("--mode", choices=["card", "cpu"], default="card")
  p.add_argument("--height", type=int, default=2048)
  p.add_argument("--width", type=int, default=1536)
  p.add_argument("--spatial_devices", type=int, default=4)
  p.add_argument("--out", default="results/torch_spatial_codec_e2e.json")
  measure.add_common_args(p)
  args = p.parse_args(argv)
  if args.mode == "cpu":
    args.device = "cpu"
  device = measure.setup(args)
  model = measure.load_model(args.workdir, device)
  image = deadleaves.deadleaves_image(777000, args.height, args.width)
  strips = sorted({1, min(2, args.spatial_devices), args.spatial_devices})
  rec = measure.spatial_codec_e2e(model, image, strips)
  label = measure.device_label(device)
  out = {f"{args.mode}_single_device": dict(rec["single_device"], device=label),
         f"{args.mode}_detail": dict(settings=rec["settings"], cross=rec["cross"],
                                     eval=rec["eval"], failures=rec["failures"],
                                     workdir=args.workdir, tf32=args.tf32, device=label)}
  if rec["spatial"] is not None:
    out[f"{args.mode}_spatial"] = dict(rec["spatial"], device=label)
  merged = {}
  if os.path.exists(args.out):
    with open(args.out) as f:
      merged = json.load(f)
  merged.update(out)
  os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
  with open(args.out, "w") as f:
    json.dump(merged, f, indent=1)
  print(json.dumps(out, indent=1), flush=True)
  if rec["failures"]:
    raise SystemExit(f"spatial codec checks failed: {rec['failures']}")
  return out


if __name__ == "__main__":
  main()
