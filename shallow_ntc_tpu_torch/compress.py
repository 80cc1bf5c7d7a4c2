"""Compress CLI of the port: real bitstreams of a model of either family.

  python -m shallow_ntc_tpu_torch.compress compress --init_seed 0 \
      --input img.npy --output img.sntc
  python -m shallow_ntc_tpu_torch.compress decompress --init_seed 0 \
      --input img.sntc --output rec.npy
  python -m shallow_ntc_tpu_torch.compress roundtrip --workdir DIR --input img.npy

Weights come from exactly one of --params (an .npz of flax parameter paths,
as the eval CLI's), --init_seed (a seeded full-width init) or --workdir (the
newest checkpoint of the port's train CLI under DIR). --config picks the
model and its codec: two_layer_syn_rd (the flagship, the default),
jpegl_rd, two_layer_syn2, mbt2018 (MSHyperCodec), or the factorized
family's bls2017_rd and bls2017 (FactorizedCodec). Images are
.npy [H, W, 3] uint8; decompress writes one. Runs on CUDA unless --device
names another device. --matmul_precision highest (the default) turns TF32
off for the analysis; the coding tables, the hyper-synthesis and the
synthesis run without TF32 either way (codec.api.coding_numerics).
roundtrip compresses, decompresses, checks that the decoder's image equals
the encoder's bit for bit and prints bpp, PSNR and the byte count.
--decode_dtype int8_syn runs the synthesis (the encoder's reconstruction and
the decoder's) on int8 operands (ops/int8ops.py); the coding tables, the
hyper-decoder and so the bitstream stay float, and a float encoder's
bitstream decodes to the same latent.
"""

import argparse
from typing import Optional, Sequence

import numpy as np
import torch

from shallow_ntc_tpu_torch import configs, eval_lib, train_lib
from shallow_ntc_tpu_torch.codec import api as codec_api
from shallow_ntc_tpu_torch.models import base as models_base
from shallow_ntc_tpu_torch.ops import int8ops
from shallow_ntc_tpu_torch.ops import metrics_ops


def load_image(path: str) -> np.ndarray:
  """An .npy [H, W, 3] uint8 image."""
  img = np.load(path)
  if img.ndim != 3 or img.shape[-1] != 3 or img.dtype != np.uint8:
    raise ValueError(f"{path}: expected an [H, W, 3] uint8 image, got {img.shape} {img.dtype}")
  return img


def load_model(args) -> torch.nn.Module:
  model_config, _, family = configs.eval_config(args.config)
  if args.workdir is not None:
    return train_lib.model_from_checkpoint(args.workdir, model_config, args.device, family)
  params = eval_lib.read_params(args.params)[0] if args.params is not None else None
  return eval_lib.build_model(model_config, params=params, init_seed=args.init_seed,
                              device=args.device, family=family)


def main(argv: Optional[Sequence[str]] = None) -> str:
  parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
  parser.add_argument("mode", choices=("compress", "decompress", "roundtrip"))
  parser.add_argument("--input", required=True, help=".npy image, or .sntc to decompress")
  parser.add_argument("--output", help="default: the input's name + .sntc or .npy")
  weights = parser.add_mutually_exclusive_group(required=True)
  weights.add_argument("--params", help=".npz of flax parameter paths -> arrays")
  weights.add_argument("--init_seed", type=int, help="seed of a flax-style random init")
  weights.add_argument("--workdir", help="the newest checkpoint of the train CLI there")
  parser.add_argument("--config", default="two_layer_syn_rd", choices=configs.EVAL_CONFIG_NAMES)
  parser.add_argument("--device", default="cuda")
  parser.add_argument("--matmul_precision", default="highest", choices=("highest", "default"))
  parser.add_argument("--decode_dtype", default="float", choices=("float", "int8_syn"))
  args = parser.parse_args(argv)
  # Process-wide, so set here and not in the codec.
  tf32 = args.matmul_precision == "default"
  torch.backends.cudnn.allow_tf32 = tf32
  torch.backends.cuda.matmul.allow_tf32 = tf32
  codec = codec_api.make_codec(load_model(args))
  with int8ops.decode_mode("syn" if args.decode_dtype == "int8_syn" else None):
    line = _run(args, codec)
  print(line)
  return line


def _run(args, codec) -> str:
  """The mode's work; returns the line that main prints."""
  if args.mode == "compress":
    result = codec.compress(models_base.normalize_image(load_image(args.input).astype(np.float32)))
    out = args.output or args.input + ".sntc"
    with open(out, "wb") as f:
      f.write(result.bitstring)
    line = f"bpp={result.bpp:.4f} bytes={len(result.bitstring)} wrote {out}"
  elif args.mode == "decompress":
    with open(args.input, "rb") as f:
      rec = codec.decompress(f.read())
    out = args.output or args.input + ".npy"
    np.save(out, rec)
    line = f"wrote {out} {rec.shape}"
  else:
    raw = load_image(args.input).astype(np.float32)
    result = codec.compress(models_base.normalize_image(raw))
    rec = codec.decompress(result.bitstring)
    if not np.array_equal(rec, result.reconstruction):
      raise RuntimeError("the decoder's reconstruction differs from the encoder's")
    _, psnr = metrics_ops.mse_psnr(torch.from_numpy(raw[None]),
                                   torch.from_numpy(rec[None].astype(np.float32)))
    line = (f"bpp={result.bpp:.4f} psnr={float(psnr[0]):.2f} bytes={len(result.bitstring)} "
            "bit_exact=True")
  return line


if __name__ == "__main__":
  main()
