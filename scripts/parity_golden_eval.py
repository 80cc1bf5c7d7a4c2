#!/usr/bin/env python
"""Golden eval of the committed flagship checkpoint through the PyTorch port,
against the JAX package, on the CPU (float32), with the int8 decode arms.

  python scripts/parity_golden_eval.py \
      [--workdir train_xms_rd/201b91d1/mshyper-lmbda=0.01-num_steps=30000] \
      [--num_images 24] [--max_images 4] [--out results/torch_golden_deadleaves.json]

The JAX package restores the orbax checkpoint, and its parameter tree goes
into the port in memory (as tests/test_torch_checkpoint.py does). The eval
images are the dead-leaves set of scripts/make_deadleaves_dataset.py
(deadleaves_image at 512x768, seeds 900000+i, as its main() writes them).
The port evaluates all of them in the arms f32, syn and all (the eval CLI's
--decode_dtype float, int8_syn, int8_all); the JAX package evaluates the
first --max_images in the same arms.

Hard checks (the script exits non-zero on a miss):
  * the port against JAX per image: bpp within rtol 1e-4, PSNR within 1e-3 dB;
  * syn's bpp equal to f32's for every image (the float hyper-decoder).
Reported beside the records, with the gap:
  * the f32 means against the lambda=0.01 rows of
    results/rd_deadleaves/mshyper-detailed.json;
  * the int8 deltas against results/int8_quality.json's summary.
Both records were taken on a TPU (int8_quality.py at its default matmul
precision), so they are context, not a target.

This script imports both packages, so it is not one of the scripts/torch_*.py,
which import no JAX.
"""

import argparse
import importlib.util
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

ARMS = {"f32": "", "syn": "syn", "all": "all"}  # arm -> SNTC_INT8_DECODE / decode_mode
KEYS = ("bpp", "psnr", "msssim", "rd_loss", "latent_bpp", "hyper_latent_bpp")


def deadleaves_images(n, h=512, w=768):
  """The eval set of scripts/make_deadleaves_dataset.py, normalized [1, H, W, 3]."""
  spec = importlib.util.spec_from_file_location(
      "make_deadleaves_dataset", os.path.join(ROOT, "scripts", "make_deadleaves_dataset.py"))
  module = importlib.util.module_from_spec(spec)
  spec.loader.exec_module(module)
  import numpy as np

  return [(module.deadleaves_image(900000 + i, h, w).astype(np.float32)[None] / 255.0 - 0.5)
          .astype(np.float32) for i in range(n)]


def mean(rows, key):
  return float(sum(r[key] for r in rows) / len(rows))


def main():
  p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
  p.add_argument("--workdir",
                 default="train_xms_rd/201b91d1/mshyper-lmbda=0.01-num_steps=30000")
  p.add_argument("--num_images", type=int, default=24)
  p.add_argument("--max_images", type=int, default=4, help="images the JAX package evaluates")
  p.add_argument("--out", default="results/torch_golden_deadleaves.json")
  args = p.parse_args()

  os.environ["JAX_PLATFORMS"] = "cpu"
  import jax

  jax.config.update("jax_platforms", "cpu")
  jax.config.update("jax_default_matmul_precision", "highest")
  import torch

  from shallow_ntc_tpu import eval_lib as jax_eval_lib
  from shallow_ntc_tpu.models import base as jax_base
  from shallow_ntc_tpu_torch import eval_lib
  from shallow_ntc_tpu_torch.ops import int8ops

  for name in ("SNTC_INT8_DECODE", "SNTC_INT8_ENCODE", "SNTC_FUSED_RB_CHAIN",
               "SNTC_FUSED_RESBLOCK"):
    os.environ.pop(name, None)
  workdir = os.path.join(ROOT, args.workdir)
  jax_model, params, config = jax_eval_lib.load_latest_ckpt(workdir)
  step = config["_restored_step"]
  port = eval_lib.build_model(jax_base.to_plain_dict(config["model_config"]), params=params,
                              device="cpu")
  t = time.time()
  images = deadleaves_images(args.num_images)
  print(f"{len(images)} dead-leaves images 512x768 in {time.time() - t:.1f}s; step {step}",
        flush=True)

  port_rows, jax_rows = {}, {}
  for arm, mode in ARMS.items():
    t = time.time()
    with int8ops.decode_mode(mode):
      port_rows[arm] = [{k: r[k] for k in KEYS}
                        for r in eval_lib.evaluate_images(port, images, step=step)]
    print(f"port {arm}: {len(images)} images in {time.time() - t:.1f}s; mean bpp "
          f"{mean(port_rows[arm], 'bpp'):.6f} psnr {mean(port_rows[arm], 'psnr'):.5f}",
          flush=True)
    t = time.time()
    os.environ["SNTC_INT8_DECODE"] = mode  # the JAX package's gate, read at trace time
    try:
      jax_rows[arm] = [{k: r[k] for k in KEYS} for r in jax_eval_lib.evaluate_images(
          jax_model, params, images[:args.max_images], step=step)]
    finally:
      os.environ.pop("SNTC_INT8_DECODE")
    print(f"jax {arm}: {args.max_images} images in {time.time() - t:.1f}s", flush=True)

  failures = []
  per_image = []
  for i in range(len(images)):
    row = {"instance_id": i}
    for arm in ARMS:
      row.update({f"{arm}_{k}": v for k, v in port_rows[arm][i].items()})
      if i < args.max_images:
        ref = jax_rows[arm][i]
        row.update({f"jax_{arm}_{k}": v for k, v in ref.items()})
        bpp_rel = abs(port_rows[arm][i]["bpp"] - ref["bpp"]) / ref["bpp"]
        psnr_db = abs(port_rows[arm][i]["psnr"] - ref["psnr"])
        row[f"{arm}_bpp_rel_vs_jax"], row[f"{arm}_psnr_db_vs_jax"] = bpp_rel, psnr_db
        if bpp_rel > 1e-4 or psnr_db > 1e-3:
          failures.append(f"image {i} {arm}: bpp rel {bpp_rel:.3e}, psnr {psnr_db:.3e} dB")
    if port_rows["syn"][i]["bpp"] != port_rows["f32"][i]["bpp"]:
      failures.append(f"image {i}: syn bpp {port_rows['syn'][i]['bpp']} != f32 "
                      f"{port_rows['f32'][i]['bpp']}")
    per_image.append(row)

  summary = {arm: {k: mean(port_rows[arm], k) for k in KEYS} for arm in ARMS}
  for arm in ("syn", "all"):
    for k in ("bpp", "psnr"):
      summary[arm][f"{k}_delta"] = summary[arm][k] - summary["f32"][k]
  with open(os.path.join(ROOT, "results", "rd_deadleaves", "mshyper-detailed.json")) as f:
    detailed = [r for r in json.load(f) if r["lmbda"] == "0.01"]
  with open(os.path.join(ROOT, "results", "int8_quality.json")) as f:
    int8_rec = json.load(f)["summary"]
  records = {
      "mshyper-detailed lmbda=0.01 (24 images)": {
          k: mean(detailed, k) for k in ("bpp", "psnr", "msssim", "rd_loss")},
      "int8_quality summary": {"f32_psnr": int8_rec["psnr"]["f32"],
                               "f32_bpp": int8_rec["bpp"]["f32"],
                               "syn_psnr_delta": int8_rec["psnr"]["syn_delta"],
                               "all_psnr_delta": int8_rec["psnr"]["all_delta"],
                               "syn_bpp_delta": int8_rec["bpp"]["syn_delta"],
                               "all_bpp_delta": int8_rec["bpp"]["all_delta"]}}
  gaps = {
      "f32 bpp - detailed": summary["f32"]["bpp"] - records[
          "mshyper-detailed lmbda=0.01 (24 images)"]["bpp"],
      "f32 psnr - detailed (dB)": summary["f32"]["psnr"] - records[
          "mshyper-detailed lmbda=0.01 (24 images)"]["psnr"],
      "syn psnr delta - int8_quality (dB)": summary["syn"]["psnr_delta"] - int8_rec["psnr"][
          "syn_delta"],
      "all psnr delta - int8_quality (dB)": summary["all"]["psnr_delta"] - int8_rec["psnr"][
          "all_delta"],
      "all bpp delta - int8_quality": summary["all"]["bpp_delta"] - int8_rec["bpp"]["all_delta"],
  }
  out = {"workdir": args.workdir, "step": step, "device": "cpu (float32)",
         "torch": torch.__version__, "jax": jax.__version__,
         "images": f"deadleaves_image(900000 + i, 512, 768), i < {len(images)}",
         "jax_images": args.max_images, "summary": summary, "records": records, "gaps": gaps,
         "failures": failures, "per_image": per_image}
  path = os.path.join(ROOT, args.out)
  os.makedirs(os.path.dirname(path), exist_ok=True)
  with open(path, "w") as f:
    json.dump(out, f, indent=1)
  print(json.dumps({"summary": summary, "gaps": gaps, "failures": failures}, indent=1))
  print(f"wrote {path}")
  return 1 if failures else 0


if __name__ == "__main__":
  sys.exit(main())
