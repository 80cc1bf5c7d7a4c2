"""The R-D result tools of the port: from trained and SGA workdirs to the
numbers of the published table (mirrors the JAX package's scripts, whose
arguments and output keys they keep; the thin CLIs are
scripts/torch_<name>.py):

  itinf_workdir_to_records   scripts/itinf_to_results.py: an SGA workdir's
                             per-batch val metrics as eval-style records of
                             the "<family>+sga" method
  codec_overhead             scripts/measure_codec_overhead.py: real rANS
                             bytes against the likelihood bound, each round
                             trip checked bit for bit, the gap split into
                             the container's framing, the coder's flush and
                             the rest (CDF quantization)
  int8_quality               scripts/int8_quality.py: the eval in float,
                             int8_syn and int8_all (ops/int8ops.py)
  int8_hyper_ranges          what int8_all does to the hyper-decoder: its
                             convs' input ranges and folded weights, the
                             scale indexes and mu it moves
  synthesis_basis            scripts/vis_syn_filters.py: the decoder's basis
                             functions g(e_i) - g(0), tiled into a PNG
  recompute_itinf_metrics    scripts/recompute_itinf_metrics.py: the val
                             metrics of saved SGA latents (itinf_vars.npz),
                             evaluated once without re-running SGA

scripts/aggregate_results.py and scripts/collect_train_curves.py, which
import neither package, read the JSON that these and the eval write.
"""

import glob
import os
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from shallow_ntc_tpu_torch import data as data_lib
from shallow_ntc_tpu_torch import eval_lib
from shallow_ntc_tpu_torch.ops import int8ops
from shallow_ntc_tpu_torch.ops import metrics_ops
from shallow_ntc_tpu_torch.utils import runname as runname_utils


# ---------------------------------------------------------------------------
# SGA workdirs -> result records (scripts/itinf_to_results.py:25-83)
# ---------------------------------------------------------------------------
def itinf_workdir_to_records(workdir: str) -> Tuple[str, List[Dict]]:
  """(file name, records) of an SGA workdir (itinf_lib.itinf_eval_experiment's:
  metrics.json, the per-batch val metrics, and config.json).

  Each record is a batch's val metrics with instance_id (the batch id),
  lmbda (the warm-start training config's rd_lambda, as a string) and
  num_images (the batch size: aggregate_results.py weights the batch means
  by it). The training config is read from warm_start_exp_dir itself when
  it holds config.json, else from its work unit warm_start_wid
  (eval_lib.find_workdir_by_wid). The name is
  <family>+sga-lmbda=<lambda>-step=<SGA steps>-xid=<experiment>.json."""
  batches = runname_utils.load_json(os.path.join(workdir, "metrics.json"))
  cfg = runname_utils.load_json(os.path.join(workdir, "config.json"))
  te_cfg = cfg["train_eval_config"]
  warm = te_cfg["warm_start_exp_dir"]
  if not os.path.isfile(os.path.join(warm, "config.json")):
    warm = eval_lib.find_workdir_by_wid(warm, te_cfg.get("warm_start_wid", 0))
  lmbda = runname_utils.load_json(os.path.join(warm, "config.json"))["model_config"]["rd_lambda"]
  method = cfg.get("model_family", "mshyper") + "+sga"
  batchsize = int(cfg.get("data_config", {}).get("batchsize", 1) or 1)
  records = []
  for b in batches:
    rec = {k: v for k, v in b.items() if k != "batch_id"}
    rec.update(instance_id=b["batch_id"], lmbda=str(lmbda), num_images=batchsize)
    records.append(rec)
  xid = os.path.basename(os.path.dirname(os.path.normpath(workdir)))
  steps = te_cfg.get("num_steps", 0)
  return f"{method}-lmbda={lmbda}-step={steps}-xid={xid}.json", records


def convert_itinf_workdir(workdir: str, out_dir: str) -> str:
  """Write itinf_workdir_to_records(workdir) under out_dir; return the path."""
  name, records = itinf_workdir_to_records(workdir)
  path = os.path.join(out_dir, name)
  runname_utils.dump_json(records, path)
  return path


# ---------------------------------------------------------------------------
# Codec overhead (scripts/measure_codec_overhead.py)
# ---------------------------------------------------------------------------
def _bitstream_split(blob: bytes) -> Tuple[int, int]:
  """(framing bytes: header, stripe counts and stripe lengths; the rANS
  coders' flushed final states) of a bitstream."""
  from shallow_ntc_tpu_torch.codec import api as codec_api

  counts = codec_api.stream_counts(blob)
  flush = codec_api.RANS_FLUSH_BYTES * sum(counts)
  return codec_api.fixed_overhead_bytes(counts) - flush, flush


def codec_overhead(model: nn.Module, images: Iterable, max_images: int = 8) -> Dict:
  """Compress up to `max_images` images ([1, H, W, 3] normalized) with the
  model's codec, check each round trip bit for bit, and set the real bpp
  beside the likelihood bound of the eval path (training=False at a late
  step), as measure_codec_overhead.py does.

  Per image the JAX script's keys (instance_id, h, w, likelihood_bpp,
  real_bpp, overhead_pct, header_bpp, psnr, roundtrip_lossless) and the
  gap's other parts: flush_bpp (each rANS stripe's 32-bit final state) and
  coding_bpp (the rest: the CDFs' quantization and the coder's own loss).
  header_bpp is the framing read from the bitstream (header, stripe counts
  and lengths); the JAX script writes a fixed 18 bytes there. Also
  real_bytes and likelihood_latent_bpp (y's part of the likelihood: z's
  part can differ across devices where its prior's probability floors; the
  whole bpp of the factorized family, whose one latent is y).
  Returns the means with the JAX script's keys, per_image included."""
  from shallow_ntc_tpu_torch.codec import api as codec_api

  codec = codec_api.make_codec(model)
  device = next(model.parameters()).device
  rows = []
  for i, batch in enumerate(images):
    if i >= max_images:
      break
    img = np.asarray(batch, np.float32)
    img = img[0] if img.ndim == 4 else img
    h, w = img.shape[:2]
    result = codec.compress(img)
    lossless = np.array_equal(codec.decompress(result.bitstring), result.reconstruction)
    with torch.no_grad():
      _, metrics, _ = model.end_to_end_frame_loss(
          torch.as_tensor(img[None], device=device), training=False, step=10**9)
    like_bpp = float(metrics["bpp"])
    n_px = h * w
    real_bpp = result.bpp
    framing, flush = _bitstream_split(result.bitstring)
    header_bpp, flush_bpp = 8.0 * framing / n_px, 8.0 * flush / n_px
    rows.append(dict(
        instance_id=i, h=h, w=w, likelihood_bpp=like_bpp, real_bpp=real_bpp,
        overhead_pct=100.0 * (real_bpp - like_bpp) / like_bpp, header_bpp=header_bpp,
        flush_bpp=flush_bpp, coding_bpp=real_bpp - like_bpp - header_bpp - flush_bpp,
        real_bytes=len(result.bitstring),
        likelihood_latent_bpp=float(metrics.get("latent_bpp", like_bpp)),
        psnr=float(metrics["psnr"]),
        roundtrip_lossless=bool(lossless)))
  if not rows:
    raise ValueError("no images to compress")
  mean = lambda k: float(np.mean([r[k] for r in rows]))  # noqa: E731
  return dict(
      mean_likelihood_bpp=mean("likelihood_bpp"), mean_real_bpp=mean("real_bpp"),
      mean_overhead_pct=mean("overhead_pct"),
      max_overhead_pct=float(np.max([r["overhead_pct"] for r in rows])),
      mean_header_bpp=mean("header_bpp"), mean_flush_bpp=mean("flush_bpp"),
      mean_coding_bpp=mean("coding_bpp"),
      all_lossless=all(r["roundtrip_lossless"] for r in rows), per_image=rows)


# ---------------------------------------------------------------------------
# int8 quality (scripts/int8_quality.py)
# ---------------------------------------------------------------------------
# Arm -> int8ops.decode_mode: float, int8_syn, int8_all (results/int8_quality.json's arms).
INT8_ARMS = {"f32": "", "syn": "syn", "all": "all"}
INT8_KEYS = ("psnr", "bpp", "msssim", "rd_loss")


def int8_quality(model: nn.Module, images: Sequence) -> Dict:
  """The per-image eval (eval_lib.evaluate_images at step 0, as the JAX
  script's) once in each arm of INT8_ARMS. Returns {"num_images",
  "summary": {metric: {"f32": mean, arm: mean, arm_delta: mean - f32}},
  "per_image": [{"<arm>_<metric>": value}]}, int8_quality.py's schema."""
  images = list(images)
  arms = {}
  for arm, mode in INT8_ARMS.items():
    with int8ops.decode_mode(mode):
      arms[arm] = list(eval_lib.evaluate_images(model, images))
  per_image = [{f"{arm}_{k}": arms[arm][i][k] for arm in arms for k in INT8_KEYS
                if k in arms[arm][i]} for i in range(len(images))]
  summary = {}
  for k in INT8_KEYS:
    f32 = float(np.mean([r[f"f32_{k}"] for r in per_image]))
    summary[k] = {"f32": f32}
    for arm in arms:
      if arm != "f32":
        v = float(np.mean([r[f"{arm}_{k}"] for r in per_image]))
        summary[k].update({arm: v, f"{arm}_delta": v - f32})
  return {"num_images": len(per_image), "summary": summary, "per_image": per_image}


def hyper_latents(model: nn.Module, images: Sequence) -> List[torch.Tensor]:
  """The z_hat that the float eval (eval_lib.evaluate_images) gives the
  hyper-decoder, one [1, h, w, C] float32 tensor per image."""
  z_hats = []
  hook = model._hyper_synthesis.register_forward_pre_hook(
      lambda module, inputs: z_hats.append(inputs[0].detach().float()))
  try:
    with int8ops.decode_mode(""):
      for _ in eval_lib.evaluate_images(model, images):
        pass
  finally:
    hook.remove()
  return z_hats


@torch.no_grad()
def int8_hyper_ranges(hyper_synthesize, z_hats: Sequence[torch.Tensor]) -> Dict:
  """What int8_all does to the hyper-decoder, image by image:
  `hyper_synthesize` (z_hat -> (mu, scale indexes), an mshyper model's) once
  in float and once under decode_mode("all"), where each int8 conv
  (int8ops.conv_s1_int8, in call order: the HyperSynthesis convs) records
  its input's per-channel absmax (the activation scales times 127), the
  largest weight after those scales are folded in, and the share of folded
  weights that quantize to 0. Per conv: "input_absmax" (per input channel,
  the largest over the images), its max and median, "folded_weight_absmax"
  (the largest over the images) and "zero_weight_share" (the mean). Per
  image and in all: the scale indexes (rounded and clipped as the codec's
  tables snap them) that int8 changes, their count, and the largest
  |mu_int8 - mu_float|."""
  from shallow_ntc_tpu_torch.ops import entropy

  convs: List[Dict] = []
  calls: List[Dict] = []

  def recording(x, w_hwio, pad_lo, pad_hi, out_dtype, bias=None):
    absmax = x.float().abs().amax(dim=tuple(range(x.ndim - 1)))
    _, sx = int8ops.quantize_act_per_channel(x)
    folded = w_hwio.float() * sx[:, None]
    wq, _ = int8ops.quantize_weight_per_cout(folded)
    calls.append(dict(absmax=absmax.cpu().numpy(), folded=float(folded.abs().max()),
                      zero=float((wq == 0).float().mean())))
    return conv_s1_int8(x, w_hwio, pad_lo, pad_hi, out_dtype, bias)

  def snap(idx):
    return torch.clamp(torch.round(entropy.normalize_indexes(idx.float())), 0,
                       entropy.NUM_SCALES - 1)

  conv_s1_int8 = int8ops.conv_s1_int8
  per_image = []
  for z in z_hats:
    with int8ops.decode_mode(""):
      mu_f, idx_f = hyper_synthesize(z)
    calls.clear()
    int8ops.conv_s1_int8 = recording
    try:
      with int8ops.decode_mode("all"):
        mu_q, idx_q = hyper_synthesize(z)
    finally:
      int8ops.conv_s1_int8 = conv_s1_int8
    if not convs:
      convs = [dict(absmax=np.zeros_like(c["absmax"]), folded=0.0, zero=[]) for c in calls]
    for agg, c in zip(convs, calls):
      agg["absmax"] = np.maximum(agg["absmax"], c["absmax"])
      agg["folded"] = max(agg["folded"], c["folded"])
      agg["zero"].append(c["zero"])
    changed = snap(idx_q) != snap(idx_f)
    per_image.append(dict(index_changed=int(changed.sum()), index_count=changed.numel(),
                          max_abs_dmu=float((mu_q.float() - mu_f.float()).abs().max())))
  return dict(
      convs=[dict(input_absmax=c["absmax"].tolist(), input_absmax_max=float(c["absmax"].max()),
                  input_absmax_median=float(np.median(c["absmax"])),
                  folded_weight_absmax=c["folded"],
                  zero_weight_share=float(np.mean(c["zero"])))
             for c in convs],
      index_changed=sum(r["index_changed"] for r in per_image),
      index_count=sum(r["index_count"] for r in per_image),
      max_abs_dmu=max(r["max_abs_dmu"] for r in per_image), per_image=per_image)


# ---------------------------------------------------------------------------
# Basis functions (scripts/vis_syn_filters.py)
# ---------------------------------------------------------------------------
BASIS_CANVAS = 8  # the latent canvas's side: each impulse sits at its centre


def synthesis_basis(model: nn.Module, num: int = 64, scale: float = 8.0) -> np.ndarray:
  """g(e_i) - g(0) of the model's synthesis for the first min(num, C)
  latent channels i, e_i an impulse of `scale` at the centre of an 8x8
  latent canvas, cropped to the 3 latent pixels' span about the centre:
  float32 [n, k, k, 3] on the synthesis's output scale. g(0) and the n
  impulses go through one synthesize call (the flagship's
  final_deconv_phase launches once)."""
  device = next(model.parameters()).device
  c = model._analysis.output_depth
  n = min(num, c)
  z = torch.zeros((n + 1, BASIS_CANVAS, BASIS_CANVAS, c), device=device)
  z[torch.arange(1, n + 1), BASIS_CANVAS // 2, BASIS_CANVAS // 2, torch.arange(n)] = scale
  with torch.no_grad():
    out = model.synthesize(z).float().cpu().numpy()
  basis = out[1:] - out[:1]
  up = basis.shape[1] // BASIS_CANVAS
  k = min(3 * up, basis.shape[1])
  c0 = basis.shape[1] // 2 - k // 2
  return basis[:, c0:c0 + k, c0:c0 + k, :]


def basis_grid(basis: np.ndarray) -> np.ndarray:
  """Each basis function scaled to 0..255 over its own range and the lot
  tiled into one uint8 image (metrics_ops.visualize_image_batch)."""
  lo = basis.min(axis=(1, 2, 3), keepdims=True)
  hi = basis.max(axis=(1, 2, 3), keepdims=True)
  imgs = (basis - lo) / np.maximum(hi - lo, 1e-9) * 255.0
  return metrics_ops.visualize_image_batch(imgs.astype(np.uint8))


# ---------------------------------------------------------------------------
# Saved SGA latents, evaluated again (scripts/recompute_itinf_metrics.py)
# ---------------------------------------------------------------------------
def recompute_itinf_metrics(itinf_workdir: str, device: Optional[str] = "cuda") -> List[Dict]:
  """Rebuild the warm-start model of an SGA workdir in float32 (its
  config.json's model_config laid over the checkpoint's), load each batch's
  itinf_vars.npz and evaluate the latents once (training=False at the SGA
  step count). Rewrites each batch_id=<i>/metrics.json's "val" and the
  workdir's metrics.json; returns the latter's list. Stops at the first
  batch without saved latents."""
  from shallow_ntc_tpu_torch import itinf_lib
  from shallow_ntc_tpu_torch.latents import LatentRVCollection, UQLatentRV

  cfg = runname_utils.load_json(os.path.join(itinf_workdir, "config.json"))
  te_cfg = cfg["train_eval_config"]
  model, _ = eval_lib.load_latest_ckpt_from_experiment(
      te_cfg["warm_start_exp_dir"], te_cfg.get("warm_start_wid", 0),
      model_family=cfg.get("model_family", "mshyper"),
      update_model_config=cfg.get("model_config"), device=device)
  num_steps = te_cfg.get("num_steps", 3000)
  optimizer_config = dict(cfg.get("model_config", {}).get("optimizer_config", {}))
  fns = itinf_lib.make_itinf_functions(model, optimizer_config, num_steps)
  offset = fns.frozen_offset()
  dev = next(model.parameters()).device
  data_cfg = cfg["data_config"]
  dataset = data_lib.get_dataset(data_cfg["dataset"], "test", data_cfg["batchsize"],
                                 data_cfg.get("patchsize"))
  all_metrics = []
  for batch_id, batch in enumerate(dataset):
    batch_dir = os.path.join(itinf_workdir, f"batch_id={batch_id}")
    npz_path = os.path.join(batch_dir, "itinf_vars.npz")
    if not os.path.isfile(npz_path):
      break
    with np.load(npz_path) as z:
      locs = [z[f"uq_{i}_loc"] for i in range(len(z.files))]
    latents = LatentRVCollection(uq=tuple(UQLatentRV(loc=torch.as_tensor(l, device=dev))
                                          for l in locs))
    x = torch.as_tensor(np.asarray(batch, np.float32), device=dev)
    val = {k: float(v) for k, v in fns.eval(x, latents, num_steps, offset).items()}
    mpath = os.path.join(batch_dir, "metrics.json")
    if os.path.isfile(mpath):
      per_batch = runname_utils.load_json(mpath)
      per_batch["val"] = val
      runname_utils.dump_json(per_batch, mpath)
    all_metrics.append({"batch_id": batch_id, **val})
  if all_metrics:
    runname_utils.dump_json(all_metrics, os.path.join(itinf_workdir, "metrics.json"))
  return all_metrics


def workdirs_with(file_glob: str, name: str) -> List[str]:
  """The directories of a glob that hold `name`, sorted."""
  return [d for d in sorted(glob.glob(file_glob)) if os.path.isfile(os.path.join(d, name))]
