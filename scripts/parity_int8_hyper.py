#!/usr/bin/env python
"""int8_all's hyper-decoder in the JAX package and in the PyTorch port, on the
same weights and latents, on the CPU.

  python scripts/parity_int8_hyper.py \
      [--npz results/torch_rd_deadleaves/hyper_int8_probe.npz] \
      [--workdir train_xms_rd/201b91d1/mshyper-lmbda=0.01-num_steps=30000] \
      [--num_images 24] [--out results/torch_rd_deadleaves/parity_int8_hyper.json]

Two sources of a HyperSynthesis and the z_hat its eval gives it:
  * "port_trained": the .npz that scripts/torch_int8_quality.py --save_hyper
    wrote on the card (the port-trained flagship's hyper-decoder, kernels
    rounded to float16, and the eval images' z_hat);
  * "jax_checkpoint": the JAX package's committed checkpoint (orbax, restored
    by the JAX package), its z_hat from the port's float eval on the CPU of
    the dead-leaves eval images (deadleaves_image at 512x768, seeds 900000+i).
For each, both packages run the hyper-decoder in float and under int8_all
(the JAX package jitted, as its evals run it; SNTC_INT8_DECODE=all, read at
trace time; the port under int8ops.decode_mode("all")) and the script sets
side by side:
  * mu and the scale indexes (rounded and clipped as the codec's tables snap
    them) of JAX against the port's, in each mode;
  * what int8_all changes against float in each package: the scale indexes
    it flips and the largest |delta mu|;
  * each conv's int8 ranges: the per-channel absmax of its input and its
    largest folded weight (the port: results.int8_hyper_ranges; the JAX
    package: its int8ops.conv_s1_int8 observed in an un-jitted pass).
Exits non-zero where the packages disagree under int8_all: more than 1e-4
of mu's elements apart by over 1e-4 x max(1, max|mu|), or more than 1e-4 of
the scale indexes. Not every element: the two packages' float ops round
differently (mu 8e-5 apart in float on the JAX checkpoint), and a value that
lands on the other side of an activation's int8 rounding step moves what
the next conv computes from it.

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

MU_TOL, SHARE_TOL = 1e-4, 1e-4


def deadleaves_images(n, h=512, w=768):
  """The eval set of scripts/make_deadleaves_dataset.py, normalized [1, H, W, 3]."""
  spec = importlib.util.spec_from_file_location(
      "make_deadleaves_dataset", os.path.join(ROOT, "scripts", "make_deadleaves_dataset.py"))
  module = importlib.util.module_from_spec(spec)
  spec.loader.exec_module(module)
  import numpy as np

  return [(module.deadleaves_image(900000 + i, h, w).astype(np.float32)[None] / 255.0 - 0.5)
          .astype(np.float32) for i in range(n)]


def jax_checkpoint_source(workdir, num_images):
  """(hyper-decoder params {flax path: float32 array}, [z_hat]) of JAX's checkpoint."""
  import numpy as np

  from shallow_ntc_tpu import eval_lib as jax_eval_lib
  from shallow_ntc_tpu.models import base as jax_base
  from shallow_ntc_tpu_torch import eval_lib, results

  _, params, config = jax_eval_lib.load_latest_ckpt(workdir)
  port = eval_lib.build_model(jax_base.to_plain_dict(config["model_config"]), params=params,
                              device="cpu")
  z_hats = [z.numpy() for z in results.hyper_latents(port, deadleaves_images(num_images))]
  hyper = {}

  def walk(tree, prefix):
    for k, v in tree.items():
      if isinstance(v, dict) or hasattr(v, "items"):
        walk(v, f"{prefix}{k}/")
      else:
        hyper[f"{prefix}{k}"] = np.asarray(v, np.float32)

  walk(params["_hyper_synthesis"], "")
  return hyper, z_hats, int(config["_restored_step"])


def npz_source(path):
  """(hyper-decoder params as float32, [z_hat], step) of a --save_hyper .npz."""
  import numpy as np

  with np.load(path) as z:
    hyper = {k: z[k].astype(np.float32) for k in z.files
             if k != "step" and not k.startswith("z_hat_")}
    z_hats = [z[f"z_hat_{i}"] for i in range(sum(k.startswith("z_hat_") for k in z.files))]
    return hyper, z_hats, int(z["step"])


def compare(hyper, z_hats):
  """Both packages' hyper-decoder on `hyper` and each z_hat; returns the
  record and the failures."""
  import jax
  import jax.numpy as jnp
  import numpy as np
  import torch

  from shallow_ntc_tpu.models import transforms as jax_transforms
  from shallow_ntc_tpu.ops import int8ops as jax_int8ops
  from shallow_ntc_tpu_torch import results
  from shallow_ntc_tpu_torch.models import transforms
  from shallow_ntc_tpu_torch.ops import entropy
  from shallow_ntc_tpu_torch.ops import int8ops

  c_in, b = hyper["stack/convs_0/kernel"].shape[2:]
  port = transforms.HyperSynthesis(c_in, b)
  port.load_state_dict({k.replace("/", "."): torch.from_numpy(v) for k, v in hyper.items()})
  port.eval()

  def port_hyper(z):
    out = port(torch.as_tensor(z).contiguous())
    mu, raw = torch.chunk(out, 2, dim=-1)
    return mu, torch.exp(raw)

  flax_mod = jax_transforms.HyperSynthesis(bottleneck_size=b)
  tree = {}
  for k, v in hyper.items():
    node = tree
    *heads, leaf = k.split("/")
    for h in heads:
      node = node.setdefault(h, {})
    node[leaf] = jnp.asarray(v)

  def jax_apply(z):
    out = flax_mod.apply({"params": tree}, z)
    mu, raw = jnp.split(out, 2, axis=-1)
    return mu, jnp.exp(raw)

  # One jitted program per mode: the gate is read when the program is traced.
  programs = {}
  for mode in ("", "all"):
    os.environ["SNTC_INT8_DECODE"] = mode
    try:
      programs[mode] = jax.jit(lambda z: jax_apply(z)).lower(
          jnp.zeros(z_hats[0].shape, jnp.float32)).compile()
    finally:
      os.environ.pop("SNTC_INT8_DECODE")

  def jax_run(mode, z):
    mu, idx = programs[mode](jnp.asarray(z))
    return np.asarray(mu), np.asarray(idx)

  def snap(idx):
    idx = np.asarray(idx, np.float32)
    return np.clip(np.round(np.clip(idx, 0, entropy.NUM_SCALES - 1)), 0, entropy.NUM_SCALES - 1)

  # The JAX package's ranges: its conv_s1_int8 observed in an un-jitted pass.
  calls = {}
  conv_s1_int8 = jax_int8ops.conv_s1_int8

  def recording(x, w, pad, dn, out_dtype):
    _, sx = jax_int8ops.quantize_act_per_channel(x)
    rec = calls.setdefault(tuple(x.shape[1:]), dict(absmax=np.zeros(x.shape[-1], np.float32),
                                                   folded=0.0))
    rec["absmax"] = np.maximum(rec["absmax"], np.asarray(jnp.max(jnp.abs(x), axis=(0, 1, 2))))
    rec["folded"] = max(rec["folded"], float(jnp.max(jnp.abs(w * sx[:, None]))))
    return conv_s1_int8(x, w, pad, dn, out_dtype)

  jax_int8ops.conv_s1_int8 = recording
  os.environ["SNTC_INT8_DECODE"] = "all"
  try:
    for z in z_hats:
      jax_apply(jnp.asarray(z))
  finally:
    jax_int8ops.conv_s1_int8 = conv_s1_int8
    os.environ.pop("SNTC_INT8_DECODE")
  jax_convs = list(calls.values())  # in call order: dicts keep insertion order

  with torch.no_grad():
    port_ranges = results.int8_hyper_ranges(port_hyper, [torch.as_tensor(z) for z in z_hats])
  rows, failures = [], []
  totals = dict(n=0, jax_index_changed=0, port_index_changed=0, index_mismatch_all=0,
                index_mismatch_float=0, mu_all_beyond_tol=0)
  for i, z in enumerate(z_hats):
    jax_f, jax_q = jax_run("", z), jax_run("all", z)
    with torch.no_grad():
      with int8ops.decode_mode(""):
        port_f = [t.numpy() for t in port_hyper(z)]
      with int8ops.decode_mode("all"):
        port_q = [t.numpy() for t in port_hyper(z)]
    tol = MU_TOL * max(1.0, float(np.abs(jax_q[0]).max()))
    row = dict(
        instance_id=i,
        mu_max_abs=float(np.abs(jax_f[0]).max()),
        mu_float_jax_vs_port=float(np.abs(jax_f[0] - port_f[0]).max()),
        mu_all_jax_vs_port=float(np.abs(jax_q[0] - port_q[0]).max()),
        index_mismatch_float=int((snap(jax_f[1]) != snap(port_f[1])).sum()),
        index_mismatch_all=int((snap(jax_q[1]) != snap(port_q[1])).sum()),
        jax_index_changed=int((snap(jax_q[1]) != snap(jax_f[1])).sum()),
        port_index_changed=int((snap(port_q[1]) != snap(port_f[1])).sum()),
        jax_max_abs_dmu=float(np.abs(jax_q[0] - jax_f[0]).max()),
        port_max_abs_dmu=float(np.abs(port_q[0] - port_f[0]).max()),
        mu_all_beyond_tol=int((np.abs(jax_q[0] - port_q[0]) > tol).sum()),
        mu_tol=tol, index_count=int(jax_q[1].size))
    rows.append(row)
    totals["n"] += row["index_count"]
    for k in ("jax_index_changed", "port_index_changed", "index_mismatch_all",
              "index_mismatch_float", "mu_all_beyond_tol"):
      totals[k] += row[k]
  for k, what in (("mu_all_beyond_tol", "mu elements"), ("index_mismatch_all", "scale indexes")):
    if totals[k] > SHARE_TOL * totals["n"]:
      failures.append(f"int8_all {what}: {totals[k]} of {totals['n']} differ between the packages")
  convs = []
  for j, (pc, jc) in enumerate(zip(port_ranges["convs"], jax_convs)):
    pa = np.asarray(pc["input_absmax"])
    convs.append(dict(
        conv=f"convs_{j}", kernel=list(hyper[f"stack/convs_{j}/kernel"].shape),
        input_absmax_max=pc["input_absmax_max"], input_absmax_median=pc["input_absmax_median"],
        input_absmax_top=[float(v) for v in np.sort(pa)[::-1][:4]],
        input_absmax_jax_vs_port=float(np.abs(jc["absmax"] - pa).max()),
        folded_weight_absmax=pc["folded_weight_absmax"],
        folded_weight_absmax_jax=jc["folded"], zero_weight_share=pc["zero_weight_share"],
        input_absmax=pc["input_absmax"]))
  summary = dict(
      images=len(z_hats), index_count=totals["n"],
      jax_index_changed=totals["jax_index_changed"],
      port_index_changed=totals["port_index_changed"],
      index_mismatch_float=totals["index_mismatch_float"],
      index_mismatch_all=totals["index_mismatch_all"],
      mu_all_beyond_tol=totals["mu_all_beyond_tol"],
      jax_max_abs_dmu=max(r["jax_max_abs_dmu"] for r in rows),
      port_max_abs_dmu=max(r["port_max_abs_dmu"] for r in rows),
      mu_all_jax_vs_port=max(r["mu_all_jax_vs_port"] for r in rows),
      mu_float_jax_vs_port=max(r["mu_float_jax_vs_port"] for r in rows))
  return dict(summary=summary, convs=convs, per_image=rows), failures


def main():
  p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
  p.add_argument("--npz", default="results/torch_rd_deadleaves/hyper_int8_probe.npz")
  p.add_argument("--workdir",
                 default="train_xms_rd/201b91d1/mshyper-lmbda=0.01-num_steps=30000")
  p.add_argument("--num_images", type=int, default=24,
                 help="eval images whose z_hat the JAX checkpoint's source takes")
  p.add_argument("--out", default="results/torch_rd_deadleaves/parity_int8_hyper.json")
  args = p.parse_args()

  os.environ["JAX_PLATFORMS"] = "cpu"
  import jax

  jax.config.update("jax_platforms", "cpu")
  jax.config.update("jax_default_matmul_precision", "highest")
  import torch

  for name in ("SNTC_INT8_DECODE", "SNTC_INT8_ENCODE", "SNTC_FUSED_RB_CHAIN",
               "SNTC_FUSED_RESBLOCK"):
    os.environ.pop(name, None)
  out = {"device": "cpu (float32)", "torch": torch.__version__, "jax": jax.__version__,
         "mu_tol": f"{MU_TOL} x max(1, max|mu|)", "share_tol": SHARE_TOL}
  failures = []
  sources = {}
  if args.npz:
    sources["port_trained"] = lambda: npz_source(os.path.join(ROOT, args.npz))
  if args.workdir:
    sources["jax_checkpoint"] = lambda: jax_checkpoint_source(
        os.path.join(ROOT, args.workdir), args.num_images)
  for name, load in sources.items():
    t = time.time()
    hyper, z_hats, step = load()
    record, fails = compare(hyper, z_hats)
    out[name] = dict(step=step, seconds=time.time() - t, **record)
    failures += [f"{name}: {f}" for f in fails]
    print(f"{name} (step {step}, {len(z_hats)} images, {time.time() - t:.1f}s): "
          f"{json.dumps(record['summary'])}", flush=True)
    for c in record["convs"]:
      print("  " + json.dumps({k: v for k, v in c.items() if k != "input_absmax"}), flush=True)
  out["failures"] = failures
  path = os.path.join(ROOT, args.out)
  os.makedirs(os.path.dirname(path), exist_ok=True)
  with open(path, "w") as f:
    json.dump(out, f, indent=1)
  print(json.dumps({"failures": failures}))
  print(f"wrote {path}")
  return 1 if failures else 0


if __name__ == "__main__":
  sys.exit(main())
