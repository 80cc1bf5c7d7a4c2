"""Compress CLI of the port: real bitstreams of a model of either family
(mirrors the root compress.py).

  python -m shallow_ntc_tpu_torch.compress compress --workdir DIR \
      --input img.png --output img.sntc
  python -m shallow_ntc_tpu_torch.compress decompress --workdir DIR \
      --input img.sntc --output rec.png
  python -m shallow_ntc_tpu_torch.compress roundtrip --init_seed 0 --input img.npy

Weights come from exactly one of --workdir (a trained workdir: the model of
its config.json, of the family it names or --model_family, with its newest
checkpoint, as eval --workdir), --params (an .npz of flax parameter paths,
as the eval CLI's) or --init_seed (a seeded full-width init). --config
picks the model of --params and --init_seed and its codec:
two_layer_syn_rd (the flagship, the default), jpegl_rd, two_layer_syn2,
mbt2018 (MSHyperCodec), or the factorized family's bls2017_rd and bls2017
(FactorizedCodec). Images are PNG or JPEG (data.read_png) or .npy [H, W, 3] uint8,
by their extension; decompress writes the --output's format, by default
<input>.png. Runs on CUDA unless --device names another device.
--matmul_precision highest (the default) turns TF32 off for the analysis;
the coding tables, the hyper-synthesis and the synthesis run without TF32
either way (codec.api.coding_numerics).
roundtrip compresses, decompresses, checks that the decoder's image equals
the encoder's bit for bit and prints bpp, PSNR and the byte count.
--decode_dtype int8_syn runs the synthesis (the encoder's reconstruction and
the decoder's) on int8 operands (ops/int8ops.py); the coding tables, the
hyper-decoder and so the bitstream stay float, and a float encoder's
bitstream decodes to the same latent.
--spatial_devices N runs the analysis and the synthesis on N height strips
over cuda:0 ... cuda:N-1 (codec.api.make_codec); the coding tables stay on
the single-device path, so a bitstream decodes under any setting.
"""

import argparse
from typing import Optional, Sequence

import numpy as np
import torch

from shallow_ntc_tpu_torch import configs, eval_lib
from shallow_ntc_tpu_torch import data as data_lib
from shallow_ntc_tpu_torch.codec import api as codec_api
from shallow_ntc_tpu_torch.models import base as models_base
from shallow_ntc_tpu_torch.ops import int8ops
from shallow_ntc_tpu_torch.ops import metrics_ops
from shallow_ntc_tpu_torch.parallel import mesh


def load_image(path: str) -> np.ndarray:
  """A PNG or JPEG, or an .npy [H, W, 3] uint8 image."""
  if path.lower().endswith((".png", ".jpg", ".jpeg")):
    return data_lib.read_png(path)
  img = np.load(path)
  if img.ndim != 3 or img.shape[-1] != 3 or img.dtype != np.uint8:
    raise ValueError(f"{path}: expected an [H, W, 3] uint8 image, got {img.shape} {img.dtype}")
  return img


def save_image(path: str, image: np.ndarray) -> None:
  """A PNG by the name's extension, else an .npy."""
  if path.lower().endswith(".png"):
    data_lib.write_png(path, image)
  else:
    np.save(path, image)


def load_model(args) -> torch.nn.Module:
  if args.workdir is not None:
    return eval_lib.load_latest_ckpt(args.workdir, args.model_family, device=args.device)[0]
  model_config, _, family = configs.eval_config(args.config)
  params = eval_lib.read_params(args.params)[0] if args.params is not None else None
  return eval_lib.build_model(model_config, params=params, init_seed=args.init_seed,
                              device=args.device, family=family)


def main(argv: Optional[Sequence[str]] = None) -> str:
  parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
  parser.add_argument("mode", choices=("compress", "decompress", "roundtrip"))
  parser.add_argument("--input", required=True,
                      help=".png or .npy image, or .sntc to decompress")
  parser.add_argument("--output", help="default: the input's name + .sntc or .png")
  weights = parser.add_mutually_exclusive_group(required=True)
  weights.add_argument("--workdir", help="a trained workdir (config.json + checkpoints)")
  weights.add_argument("--params", help=".npz of flax parameter paths -> arrays")
  weights.add_argument("--init_seed", type=int, help="seed of a flax-style random init")
  parser.add_argument("--model_family", choices=("mshyper", "factorized"),
                      help="the family of --workdir (default: from its config.json)")
  parser.add_argument("--config", default="two_layer_syn_rd", choices=configs.EVAL_CONFIG_NAMES,
                      help="the model of --params and --init_seed")
  parser.add_argument("--device", default="cuda")
  parser.add_argument("--matmul_precision", default="highest", choices=("highest", "default"))
  parser.add_argument("--decode_dtype", default="float", choices=("float", "int8_syn"))
  parser.add_argument("--spatial_devices", type=int, default=1,
                      help="split the pixel-space transforms' height over this many GPUs")
  args = parser.parse_args(argv)
  # Process-wide, so set here and not in the codec.
  tf32 = args.matmul_precision == "default"
  torch.backends.cudnn.allow_tf32 = tf32
  torch.backends.cuda.matmul.allow_tf32 = tf32
  codec = codec_api.make_codec(load_model(args), mesh.spatial_device_list(args.spatial_devices))
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
    out = args.output or args.input + ".png"
    save_image(out, rec)
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
