"""Write the JPEG and PNG test images of tests/data/jpeg/ (under 1 MB in all).

  python scripts/make_jpeg_fixtures.py [--out tests/data/jpeg]

Dead-leaves images (shallow_ntc_tpu_torch.deadleaves, seeded) encoded by
PIL's libjpeg-turbo:
  coco_000.jpg .. coco_007.jpg  640x480 (COCO's usual size), q=85, 4:2:0:
                                the images the loader's batch path reads;
  s444.jpg, s422.jpg            4:4:4 and 4:2:2, q=90;
  progressive.jpg               progressive 4:2:0;
  grey.jpg                      one component;
  restart.jpg                   a restart marker after every MCU row
                                (restart_marker_rows=1);
  rgb.jpg                       RGB components (Adobe transform 0, keep_rgb);
  cmyk.jpg                      four components, which no RGB decode accepts.
The variants are 157x203 and the greys and RGB 149x211: sizes that end in
partial MCUs, so the edges of the upsampling and the padded blocks are read.
PNGs the port's zlib reader refused before, written here byte by byte (PIL
writes neither 16-bit RGB nor Adam7), each row under one of the five filters
in turn:
  grey16.png     16-bit grey, samples spread over 0..65535 and 0..300;
  rgb16.png      16-bit RGB;
  grey1.png      1-bit grey;
  grey2_adam7.png 2-bit grey, Adam7-interlaced;
  pal4_trns.png  4-bit palette of 11 colours, some indexes past them, with
                 a tRNS chunk;
  rgb_adam7.png  8-bit RGB, Adam7-interlaced.
Beside them, tests/data/jpeg_sha256.json: each image's shape and the sha256
of its pixels as the JAX package reads them: "read_png" through PIL (JAX's
read_png), "decode_image" through JAX's native loader (libjpeg-turbo and
libpng; null where it fails, and for the tRNS PNG, on which it overruns its
buffer). The port is held to these digests on machines without PIL or
libjpeg (chip_smoke.py).
"""

import argparse
import hashlib
import io
import json
import os
import struct
import sys
import zlib

import numpy as np
from PIL import Image

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
from shallow_ntc_tpu import dataio as jax_dataio  # noqa: E402  (no JAX import)
from shallow_ntc_tpu_torch import deadleaves  # noqa: E402

ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4), (0, 2, 2, 4), (1, 0, 2, 2),
         (0, 1, 1, 2))


def _chunk(kind: bytes, payload: bytes) -> bytes:
  return (struct.pack(">I", len(payload)) + kind + payload
          + struct.pack(">I", zlib.crc32(kind + payload)))


def _filtered(rows: np.ndarray, bpp: int, first_filter: int) -> bytes:
  """Scanlines [H, rowbytes] under filters first_filter, first_filter + 1,
  ... (mod 5), each row after its filter byte."""
  out = bytearray()
  prev = np.zeros(rows.shape[1], np.int32)
  for y, row in enumerate(rows.astype(np.int32)):
    ftype = (first_filter + y) % 5
    a = np.concatenate([np.zeros(bpp, np.int32), row[:-bpp]])
    c = np.concatenate([np.zeros(bpp, np.int32), prev[:-bpp]])
    if ftype == 4:
      p = a + prev - c
      pa, pb, pc = abs(p - a), abs(p - prev), abs(p - c)
      pred = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, prev, c))
    else:
      pred = [0, a, prev, (a + prev) >> 1][ftype]
    out.append(ftype)
    out += ((row - pred) & 255).astype(np.uint8).tobytes()
    prev = row
  return bytes(out)


def _pack(samples: np.ndarray, depth: int) -> np.ndarray:
  """Rows of samples [H, W * channels] at `depth` bits, big-endian, packed
  MSB first: [H, rowbytes] uint8."""
  if depth == 16:
    return samples.astype(">u2").view(np.uint8).reshape(samples.shape[0], -1)
  if depth == 8:
    return samples.astype(np.uint8)
  per = 8 // depth
  h, n = samples.shape
  padded = np.zeros((h, -(-n // per) * per), np.uint8)
  padded[:, :n] = samples
  shifts = (8 - depth * (np.arange(per) + 1)).astype(np.uint8)
  return (padded.reshape(h, -1, per) << shifts).sum(axis=-1).astype(np.uint8)


def png_bytes(samples: np.ndarray, depth: int, ctype: int, interlace: bool = False,
              palette=None, trns: bytes = b"") -> bytes:
  """A PNG of `samples` [H, W, channels] (integers < 2**depth)."""
  h, w, ch = samples.shape
  bpp = max(1, ch * depth // 8)
  passes = ADAM7 if interlace else ((0, 0, 1, 1),)
  raw = b""
  for i, (x0, y0, dx, dy) in enumerate(passes):
    sub = samples[y0::dy, x0::dx]
    if sub.size:
      raw += _filtered(_pack(sub.reshape(sub.shape[0], -1), depth), bpp, i)
  out = b"\x89PNG\r\n\x1a\n" + _chunk(
      b"IHDR", struct.pack(">IIBBBBB", w, h, depth, ctype, 0, 0, int(interlace)))
  if palette is not None:
    out += _chunk(b"PLTE", np.asarray(palette, np.uint8).tobytes())
  if trns:
    out += _chunk(b"tRNS", trns)
  return out + _chunk(b"IDAT", zlib.compress(raw, 9)) + _chunk(b"IEND", b"")


def _jpeg(img: Image.Image, **kw) -> bytes:
  buf = io.BytesIO()
  img.save(buf, format="JPEG", **kw)
  return buf.getvalue()


def fixtures():
  """{file name: bytes}."""
  files = {}
  for i in range(8):
    rgb = Image.fromarray(deadleaves.deadleaves_image(700_000 + i, 480, 640))
    files[f"coco_{i:03d}.jpg"] = _jpeg(rgb, quality=85, subsampling="4:2:0")
  odd = Image.fromarray(deadleaves.deadleaves_image(700_100, 157, 203))
  files["s444.jpg"] = _jpeg(odd, quality=90, subsampling="4:4:4")
  files["s422.jpg"] = _jpeg(odd, quality=90, subsampling="4:2:2")
  files["progressive.jpg"] = _jpeg(odd, quality=85, subsampling="4:2:0", progressive=True)
  files["restart.jpg"] = _jpeg(odd, quality=85, subsampling="4:2:0", restart_marker_rows=1)
  small = Image.fromarray(deadleaves.deadleaves_image(700_101, 149, 211))
  files["grey.jpg"] = _jpeg(small.convert("L"), quality=85)
  files["rgb.jpg"] = _jpeg(small, quality=85, subsampling="4:4:4", keep_rgb=True)
  files["cmyk.jpg"] = _jpeg(small.convert("CMYK"), quality=85)

  rng = np.random.default_rng(700_200)
  h, w = 37, 53
  grey16 = np.concatenate([rng.integers(0, 65536, (h, w - 20)),
                           rng.integers(0, 301, (h, 20))], axis=1)
  files["grey16.png"] = png_bytes(grey16[..., None], 16, 0)
  files["rgb16.png"] = png_bytes(rng.integers(0, 65536, (h, w, 3)), 16, 2)
  files["grey1.png"] = png_bytes(rng.integers(0, 2, (h, w, 1)), 1, 0)
  files["grey2_adam7.png"] = png_bytes(rng.integers(0, 4, (h, w, 1)), 2, 0, interlace=True)
  palette = rng.integers(0, 256, (11, 3))
  files["pal4_trns.png"] = png_bytes(rng.integers(0, 16, (h, w, 1)), 4, 3, palette=palette,
                                     trns=bytes(range(0, 250, 25)))
  files["rgb_adam7.png"] = png_bytes(rng.integers(0, 256, (h, w, 3)), 8, 2, interlace=True)
  return files


def sha256(pixels: np.ndarray) -> str:
  return hashlib.sha256(np.ascontiguousarray(pixels, np.uint8).tobytes()).hexdigest()


def reference_digests(out_dir):
  """{file name: {"shape", "read_png", "decode_image"}} of the images in
  out_dir, as the JAX package reads them."""
  refs = {}
  for name in sorted(os.listdir(out_dir)):
    path = os.path.join(out_dir, name)
    with Image.open(path) as im:
      pil = np.asarray(im.convert("RGB"))
    native = None if "trns" in name else jax_dataio.decode_image(path)
    refs[name] = {"shape": list(pil.shape), "read_png": sha256(pil),
                  "decode_image": None if native is None else sha256(native)}
  return refs


def main(argv=None):
  parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
  parser.add_argument("--out", default=os.path.join(
      os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "tests", "data", "jpeg"))
  args = parser.parse_args(argv)
  os.makedirs(args.out, exist_ok=True)
  files = fixtures()
  for name, data in files.items():
    with open(os.path.join(args.out, name), "wb") as f:
      f.write(data)
  digests = os.path.join(os.path.dirname(os.path.abspath(args.out)), "jpeg_sha256.json")
  with open(digests, "w") as f:
    json.dump(reference_digests(args.out), f, indent=1, sort_keys=True)
    f.write("\n")
  print(f"wrote {len(files)} files, {sum(map(len, files.values()))} bytes, to {args.out}, "
        f"and their digests to {digests}")


if __name__ == "__main__":
  main()
