#!/usr/bin/env python
"""The committed flagship checkpoint's codec at 2048x1536 through the PyTorch
port, against the JAX package's codec, on the CPU (float32).

  python scripts/parity_spatial_codec.py \
      [--workdir train_xms_rd/201b91d1/mshyper-lmbda=0.01-num_steps=30000] \
      [--height 2048 --width 1536] [--out results/torch_spatial_codec_e2e.json]

The JAX package restores the orbax checkpoint, and its parameter tree goes
into the port in memory (as scripts/parity_golden_eval.py does). The image
is deadleaves_image(777000, height, width), scripts/spatial_codec_e2e.py's.
JAX's single-device codec compresses and decompresses it; the port's codec
(shallow_ntc_tpu_torch/measure.py: spatial_codec_e2e) compresses it unsplit
and on 4 height strips of the CPU, each decoded by itself and across.

Hard checks (the script exits non-zero on a miss, after writing --out):
  * the port's bpp, unsplit and in 4 strips, within rtol 1e-4 of JAX's;
  * the port's PSNR against the source within 1e-3 dB of JAX's;
  * each self round trip of the port bit for bit;
  * the port's cross-setting decodes within 1 uint8.
Reported: whether the port's bitstreams equal JAX's byte for byte and how
many y symbols differ (the container is shared, so the port decodes JAX's
blob; a scale index flipped by a last bit between XLA's and oneDNN's convs
would show there), the port's decode of JAX's blob against JAX's
reconstruction, and the gap to results/spatial_codec_e2e.json's record of
JAX's 8-device CPU mesh (a CPU run too). The result goes under "cpu_golden"
of --out.

This script imports both packages, so it is not one of the scripts/torch_*.py,
which import no JAX.
"""

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def main():
  p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
  p.add_argument("--workdir",
                 default="train_xms_rd/201b91d1/mshyper-lmbda=0.01-num_steps=30000")
  p.add_argument("--height", type=int, default=2048)
  p.add_argument("--width", type=int, default=1536)
  p.add_argument("--spatial_devices", type=int, default=4)
  p.add_argument("--out", default="results/torch_spatial_codec_e2e.json")
  args = p.parse_args()

  os.environ["JAX_PLATFORMS"] = "cpu"
  import jax

  jax.config.update("jax_platforms", "cpu")
  jax.config.update("jax_default_matmul_precision", "highest")
  import numpy as np

  from shallow_ntc_tpu import eval_lib as jax_eval_lib
  from shallow_ntc_tpu.codec import api as jax_codec_api
  from shallow_ntc_tpu.models import base as jax_base
  from shallow_ntc_tpu_torch import deadleaves, eval_lib, measure
  from shallow_ntc_tpu_torch.codec import api as codec_api

  for name in measure.SWITCHES:
    os.environ.pop(name, None)
  jax_model, params, config = jax_eval_lib.load_latest_ckpt(os.path.join(ROOT, args.workdir))
  port = eval_lib.build_model(jax_base.to_plain_dict(config["model_config"]), params=params,
                              device="cpu")
  t = time.time()
  image = deadleaves.deadleaves_image(777000, args.height, args.width)
  x = measure.normalized(image)
  print(f"dead-leaves image {args.height}x{args.width} in {time.time() - t:.1f}s; step "
        f"{config['_restored_step']}", flush=True)

  t = time.time()
  jax_codec = jax_codec_api.make_codec(jax_model, params)
  jax_res = jax_codec.compress(x)
  jax_out = jax_codec.decompress(jax_res.bitstring)
  jax_rec = dict(bpp=jax_res.bpp, bytes=len(jax_res.bitstring),
                 psnr_vs_source=measure.psnr_u8(jax_out, image),
                 roundtrip_bit_exact=bool(np.array_equal(jax_out, jax_res.reconstruction)),
                 wall_s=time.time() - t)
  print(f"jax: {jax_rec}", flush=True)
  del jax_codec

  t = time.time()
  strips = (1, args.spatial_devices)
  rec = measure.spatial_codec_e2e(port, image, strips, with_eval=False)
  print(f"port: {rec['settings']}; across {rec['cross']} in {time.time() - t:.1f}s", flush=True)
  failures = list(rec["failures"])
  whole = codec_api.make_codec(port)
  vs_jax = {}
  for n in strips:
    s = rec["settings"][str(n)]
    bpp_rel = abs(s["bpp"] - jax_rec["bpp"]) / jax_rec["bpp"]
    psnr_db = abs(s["psnr_vs_source"] - jax_rec["psnr_vs_source"])
    vs_jax[str(n)] = dict(bpp_rel=bpp_rel, psnr_db=psnr_db)
    if bpp_rel > 1e-4 or psnr_db > 1e-3:
      failures.append(f"{n} strips against JAX: bpp rel {bpp_rel:.3e}, psnr {psnr_db:.3e} dB")
  # The port reads JAX's blob: the symbols against its own, the image against JAX's.
  port_blob = rec["blobs"][1]
  y_port = whole.decode_latent(port_blob)[2]
  y_jax = whole.decode_latent(jax_res.bitstring)[2]
  z_port = whole._decode_z_host(port_blob)[2]
  z_jax = whole._decode_z_host(jax_res.bitstring)[2]
  d = np.abs(whole.decompress(jax_res.bitstring).astype(np.int32)
             - jax_res.reconstruction.astype(np.int32))
  across = dict(bitstreams_equal_jax=port_blob == jax_res.bitstring,
                bytes_port=len(port_blob), bytes_jax=len(jax_res.bitstring),
                z_symbols_differ=int((z_port != z_jax).sum()),
                y_symbols_differ=int((y_port != y_jax).sum()), y_symbols=int(y_port.size),
                port_decode_of_jax_blob_max_abs=int(d.max()),
                port_decode_of_jax_blob_frac_diff=float((d != 0).mean()))
  with open(os.path.join(ROOT, "results", "spatial_codec_e2e.json")) as f:
    record = json.load(f)["cpu_mesh_spatial"]
  gaps = {"bpp_single - record bpp_single": rec["settings"]["1"]["bpp"] - record["bpp_single"],
          "psnr - record psnr_vs_source": (rec["settings"]["1"]["psnr_vs_source"]
                                          - record["psnr_vs_source"])}
  golden = dict(workdir=args.workdir, step=config["_restored_step"], device="cpu",
                height=args.height, width=args.width, jax=jax_rec,
                port=dict(single_device=rec["single_device"], spatial=rec["spatial"],
                          settings=rec["settings"], cross=rec["cross"]),
                port_vs_jax=vs_jax, port_and_jax_bitstreams=across,
                record_cpu_mesh_spatial=record, gap_to_record=gaps, failures=failures)
  out = os.path.join(ROOT, args.out) if not os.path.isabs(args.out) else args.out
  merged = {}
  if os.path.exists(out):
    with open(out) as f:
      merged = json.load(f)
  merged["cpu_golden"] = golden
  with open(out, "w") as f:
    json.dump(merged, f, indent=1)
  print(json.dumps({k: golden[k] for k in ("jax", "port_vs_jax", "port_and_jax_bitstreams",
                                           "gap_to_record", "failures")}, indent=1))
  if failures:
    raise SystemExit(f"parity misses: {failures}")


if __name__ == "__main__":
  main()
