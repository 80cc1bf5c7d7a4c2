#!/usr/bin/env python
"""FLOPs per pixel and params of the paper's transforms in the PyTorch port.

The port's counterpart of scripts/get_flops.py: the same 13 rows, names and
inputs, and the same CSV (transform,flops_per_pixel,params) at 512x768 by
default, comparable with results/flops_audit.csv. The FLOPs are the model's,
counted from each layer's shapes (shallow_ntc_tpu_torch/utils/profiling.py),
so the kernels, the plain versions and cuDNN give one count.

Usage: python scripts/torch_get_flops.py [--height 512 --width 768]
           [--device cuda|cpu]
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch

from shallow_ntc_tpu_torch.models import transforms as T
from shallow_ntc_tpu_torch.utils import profiling

TRANSFORMS = {
    # name: (config, input kind)  kind: image | latent320 | latent256 | hyper320
    "ElicAnalysis(192,192,192,320) [f]": (
        dict(cls="ElicAnalysis", channels=(192, 192, 192, 320)), "image"),
    "HyperAnalysis(320) [f_h]": (
        dict(cls="HyperAnalysis", bottleneck_size=320), "latent320"),
    "HyperSynthesis(320) [g_h]": (
        dict(cls="HyperSynthesis", bottleneck_size=320), "hyper320"),
    "JPEGLikeHyperSynthesis(320)": (
        dict(cls="JPEGLikeHyperSynthesis", bottleneck_size=320), "hyper320"),
    "JPEGLikeSynthesis(k18,s16) [g jpegl]": (
        dict(cls="JPEGLikeSynthesis", kernel_size=18, strides=16), "latent320"),
    "TwoLayerResSynthesis(12,3) [g 2layer]": (
        dict(cls="TwoLayerResSynthesis", channels=(12, 3)), "latent320"),
    "TwoLayerSynthesis(24,3) [g 2layer syn2]": (
        dict(cls="TwoLayerSynthesis", channels=(24, 3)), "latent320"),
    "BLS2017Analysis(256)": (
        dict(cls="BLS2017Analysis", num_filters=256), "image"),
    "BLS2017Synthesis(256)": (
        dict(cls="BLS2017Synthesis", num_filters=256), "latent256"),
    "MBT2018Analysis(192,320)": (
        dict(cls="MBT2018Analysis", channels_base=192, output_channels=320), "image"),
    "MBT2018Synthesis(192)": (
        dict(cls="MBT2018Synthesis", channels_base=192), "latent320"),
    "CNNAnalysis(256,320)": (
        dict(cls="CNNAnalysis", channels_base=256, output_channels=320), "image"),
    "ElicSynthesis(192,160,128,3)": (
        dict(cls="ElicSynthesis", channels=(192, 160, 128, 3)), "latent320"),
}


def input_shape(kind, h, w):
  return {"image": (1, h, w, 3), "latent320": (1, h // 16, w // 16, 320),
          "latent256": (1, h // 16, w // 16, 256),
          "hyper320": (1, h // 64, w // 64, 320)}[kind]


def rows(h, w, device, names=None):
  """(name, FLOPs per pixel, params) of each transform of TRANSFORMS (or of
  `names`), counted on a zero input of batch 1 on `device`."""
  out = []
  for name, (cfg, kind) in TRANSFORMS.items():
    if names is not None and name not in names:
      continue
    shape = input_shape(kind, h, w)
    mod = T.build_transform(cfg, shape[-1]).to(device).eval()
    n_params = sum(p.numel() for p in mod.parameters())
    flops = profiling.get_flops(mod, torch.zeros(shape, device=device))
    out.append((name, flops / (h * w), n_params))
  return out


def main():
  parser = argparse.ArgumentParser()
  parser.add_argument("--height", type=int, default=512)
  parser.add_argument("--width", type=int, default=768)
  parser.add_argument("--device", default="cuda")
  args = parser.parse_args()
  print("transform,flops_per_pixel,params")
  for name, fpp, n_params in rows(args.height, args.width, torch.device(args.device)):
    print(f"{name},{fpp:.0f},{n_params}")


if __name__ == "__main__":
  main()
