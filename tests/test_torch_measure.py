"""The port's measurement layer (shallow_ntc_tpu_torch/measure.py and its
scripts/torch_*.py CLIs) against the JAX package's measurement scripts, on
the CPU.

The flagship at narrow ELIC widths (tests/torch_parity's SMALL_CONFIG:
ELIC (8, 8, 8, 16), the synthesis at (12, 3)) with the same params in both
packages:
  * the codec unsplit and on 4 height strips of the CPU against JAX's
    make_codec(spatial_devices=4) on a 256x128 image: bpp equal, every self
    round trip bit for bit, the cross-setting decodes within 1 uint8 (JAX's
    contract, scripts/spatial_codec_e2e.py:17-22), the split eval within
    rtol 1e-4; the CLI's record keys against results/spatial_codec_e2e.json;
  * codec_latency's stream counts and likelihood bound against JAX's codec
    and end_to_end_frame_loss (rtol 1e-4);
  * the keys of the codec_e2e_bench and bench_suite CLIs (--device cpu, the
    measure function each calls narrowed to a tiny size) against
    results/codec_e2e.json and results/bench_suite.json;
  * encode_roofline's per-stage least bytes and FLOPs against JAX's
    scripts/encode_roofline.py run unchanged (its timing stubbed) at B=1
    512x768, and the stages' FLOPs summed against utils/profiling's count of
    ElicAnalysis + HyperAnalysis within 2% (tests/test_torch_profiling.py's
    tolerance);
  * the SGA step rate CLI at 2 and 4 steps; marginal_ms's arithmetic.
Each CLI's refusal to run without CUDA unless --device says so is a case of
tests/test_torch_results.py::test_clis_default_to_the_card.
"""

import importlib.util
import json
import os
import sys

import numpy as np
import pytest
import torch

from shallow_ntc_tpu.codec import api as jax_codec_api
from shallow_ntc_tpu_torch import configs
from shallow_ntc_tpu_torch import data as data_lib
from shallow_ntc_tpu_torch import deadleaves
from shallow_ntc_tpu_torch import eval_lib
from shallow_ntc_tpu_torch import measure
from shallow_ntc_tpu_torch.parallel import mesh
from shallow_ntc_tpu_torch.utils import profiling
from tests.torch_parity import SMALL_CONFIG, jax_eval, models

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CHANNELS = (8, 8, 8, 16)  # SMALL_CONFIG's ELIC widths
# The keys scripts/spatial_codec_e2e.py writes in its chip mode (:90-98);
# the committed file holds its mesh mode's record only.
JAX_CHIP_KEYS = {"height", "width", "bpp", "psnr_vs_source", "encode_wall_s_warm",
                 "decode_wall_s_warm", "roundtrip_bit_exact"}


def _script(name):
  """The module of scripts/<name>.py."""
  spec = importlib.util.spec_from_file_location(f"_script_{name}",
                                                os.path.join(REPO, "scripts", f"{name}.py"))
  mod = importlib.util.module_from_spec(spec)
  spec.loader.exec_module(mod)
  return mod


def _load(path):
  with open(path) as f:
    return json.load(f)


@pytest.fixture(scope="module")
def small():
  """(JAX model, its params, the port's model with the same params, JAX's
  single-device codec)."""
  jax_model, params, port = models(SMALL_CONFIG, seed=0)
  return jax_model, params, port, jax_codec_api.make_codec(jax_model, params)


@pytest.fixture
def narrow(monkeypatch):
  """The CLIs' seeded flagship at SMALL_CONFIG's ELIC widths."""
  def load(workdir, device, update_model_config=None):
    assert workdir is None
    return eval_lib.build_model(measure.flagship_config(CHANNELS, **(update_model_config or {})),
                                init_seed=0, device=device)

  monkeypatch.setattr(measure, "load_model", load)


# One image for both packages' codecs (JAX compiles per shape).
IMAGE = deadleaves.deadleaves_image(777000, 256, 128)


def test_split_codec_matches_jax_spatial_codec(small):
  """The port's codec unsplit and on 4 strips ([cpu] * 4) against JAX's
  single-device and spatial_devices=4 codecs on a 256x128 dead-leaves image."""
  jax_model, params, port, plain = small
  x = measure.normalized(IMAGE)
  rec = measure.spatial_codec_e2e(port, IMAGE, (1, 4))
  assert not rec["failures"], rec["failures"]
  for n in ("1", "4"):
    assert rec["settings"][n]["roundtrip_bit_exact"]
  assert rec["cross"]["4"]["max_abs"] <= 1 and rec["spatial"]["self_roundtrip_bit_exact"]
  for n in ("4",):
    for k in ("bpp", "psnr", "rd_loss"):
      assert rec["eval"][n]["rel_to_unsplit"][k] <= 1e-4

  spatial = jax_codec_api.make_codec(jax_model, params, spatial_devices=4)
  theirs = {1: plain.compress(x), 4: spatial.compress(x)}
  for n, r in theirs.items():
    assert rec["settings"][str(n)]["bpp"] == r.bpp
  assert rec["spatial"]["bpp_spatial"] == rec["spatial"]["bpp_single"] == theirs[4].bpp

  # The height split never reaches the hyper-decoder: the coding tables stay canonical.
  hyper = (port._hyper_analysis, port._hyper_synthesis, port._prior)
  with mesh.ModelHeightSplit(port, ["cpu"] * 4) as m:
    assert isinstance(m._analysis, mesh.HeightSplit) and isinstance(m._synthesis,
                                                                     mesh.HeightSplit)
    assert (m._hyper_analysis, m._hyper_synthesis, m._prior) == hyper
  assert not isinstance(port._analysis, mesh.HeightSplit)


def test_spatial_codec_cli_keys(tmp_path, narrow):
  """--mode cpu writes JAX's mesh-mode keys under cpu_spatial and its chip
  mode's under cpu_single_device, each with peak_mem_GB and device; a
  second run merges into the same file, as JAX's does."""
  out = tmp_path / "sc.json"
  (tmp_path / "sc.json").write_text(json.dumps({"cpu_golden": {"x": 1}}))
  _script("torch_spatial_codec_e2e").main(
      ["--mode", "cpu", "--height", "128", "--width", "128", "--spatial_devices", "2",
       "--out", str(out)])
  got = _load(out)
  jax_keys = set(_load(os.path.join(REPO, "results", "spatial_codec_e2e.json"))
                 ["cpu_mesh_spatial"])
  assert jax_keys | {"peak_mem_GB", "device"} <= set(got["cpu_spatial"])
  assert JAX_CHIP_KEYS | {"peak_mem_GB", "device"} <= set(got["cpu_single_device"])
  assert got["cpu_spatial"]["spatial_devices"] == 2 and got["cpu_golden"] == {"x": 1}
  assert sorted(got["cpu_detail"]["settings"]) == sorted(got["cpu_detail"]["eval"]) == ["1", "2"]


def test_codec_latency_matches_jax(small):
  """stream_counts and the likelihood bound against JAX's codec and
  end_to_end_frame_loss (rtol 1e-4); the decompress equals the compressor's
  reconstruction; the striped and single-stream decodes are timed."""
  jax_model, params, port, plain = small
  x = measure.normalized(IMAGE)
  rec = measure.codec_latency(port, x, reps=1)
  res = plain.compress(x)
  assert rec["stream_counts"] == jax_codec_api.stream_counts(res.bitstring)
  np.testing.assert_allclose(rec["bpp"], res.bpp, rtol=1e-4)
  _, metrics, _ = jax_eval(jax_model, params, x[None], step=10**9)
  np.testing.assert_allclose(rec["likelihood_bpp"], float(metrics["bpp"]), rtol=1e-4)
  np.testing.assert_allclose(rec["overhead_pct"],
                             (res.bpp / float(metrics["bpp"]) - 1) * 100, rtol=1e-3, atol=1e-3)
  assert rec["reconstruction_equal"] and rec["y_symbols"] == 16 * 8 * 16
  assert rec["y_decode_striped_ms"] > 0 and rec["y_decode_single_ms"] > 0


def test_codec_latency_cli_generates_its_image(tmp_path, narrow):
  out = tmp_path / "lat.json"
  rec = _script("torch_codec_latency").main(
      ["--image", str(tmp_path / "absent.png"), "--reps", "1", "--out", str(out), "--device",
       "cpu"])
  assert rec["image"] == "deadleaves_image(900000)" and (rec["height"], rec["width"]) == (512, 768)
  assert _load(out)["bytes"] == rec["bytes"]


def test_codec_e2e_bench_cli_keys(tmp_path, narrow):
  """results/codec_e2e.json's keys, and "device"."""
  for i in range(3):
    data_lib.write_png(str(tmp_path / f"dle{i:03d}.png"),
                       deadleaves.deadleaves_image(900000 + i, 40, 56))
  out = tmp_path / "e2e.json"
  rec = _script("torch_codec_e2e_bench").main(
      ["--images", str(tmp_path / "*.png"), "--repeats", "1", "--chunk_size", "2", "--out",
       str(out), "--device", "cpu"])
  jax_keys = set(_load(os.path.join(REPO, "results", "codec_e2e.json")))
  assert set(_load(out)) == jax_keys | {"device"} == set(rec)
  assert rec["images"] == 3 and rec["recon_batch_vs_single_max_abs"] <= 1
  assert rec["bitstream_batch_equals_single"]


def test_bench_suite_cli_keys(tmp_path, monkeypatch):
  """results/bench_suite.json's keys, and the chain kernel's encode, from
  measure.bench_suite at a tiny size (B=1 64x64, 1 -> 2 loops and SGA
  steps, 4096 rANS symbols)."""
  suite = measure.bench_suite

  def tiny(device, fast):
    assert fast
    return suite(device, fast, batch=1, hw=(64, 64), train_batch=1, train_hw=64,
                 analysis_channels=CHANNELS, sga_steps=(1, 2), rans_symbols=4096, loops=(1, 2))

  monkeypatch.setattr(measure, "bench_suite", tiny)
  out = tmp_path / "bs.json"
  rec = _script("torch_bench_suite").main(["--fast", "--out", str(out), "--device", "cpu"])
  jax_keys = set(_load(os.path.join(REPO, "results", "bench_suite.json")))
  assert set(_load(out)) == jax_keys | {"encode_chain_Mpx_per_s"} == set(rec)
  assert rec["device"] == "cpu"
  assert all(np.isfinite(v) and v > 0 for k, v in rec.items()
             if k not in ("device", "matmul_precision"))


def _jax_roofline(tmp_path, monkeypatch):
  """JAX's encode_roofline.py at --batch 1, its timing stubbed (1 ms a stage)."""
  monkeypatch.setattr(sys, "argv", ["encode_roofline.py", "--batch", "1", "--out",
                                    str(tmp_path / "jax.json")])
  from shallow_ntc_tpu.utils import jax_setup

  monkeypatch.setattr(jax_setup, "setup_jax", lambda **kwargs: None)
  mod = _script("encode_roofline")
  mod.loop_marginal_time = lambda fn, x: 1e-3
  mod.main()
  return _load(tmp_path / "jax.json")


def test_roofline_bytes_and_flops_match_jax(tmp_path, monkeypatch):
  """Every stage's min_GB, unfused_GB and GFLOP at B=1 512x768 of the
  full-width flagship against JAX's script (which rounds them to 4 and 2
  decimals). JAX gives hyper_analysis 0 FLOPs; the port gives it its three
  convs by JAX's conv formula."""
  theirs = _jax_roofline(tmp_path, monkeypatch)
  port = eval_lib.build_model(configs.TWO_LAYER_SYN_RD, init_seed=0, device="cpu")
  ours = measure.roofline_stages(port, 1, 512, 768)
  assert [s["stage"] for s in ours] == [s["stage"] for s in theirs["stages"]]
  for mine, ref in zip(ours, theirs["stages"]):
    assert abs(mine["min_bytes"] / 1e9 - ref["min_GB"]) <= 5e-5, ref["stage"]
    if "unfused_GB" in ref:
      assert abs(mine["unfused_bytes"] / 1e9 - ref["unfused_GB"]) <= 5e-5, ref["stage"]
    if ref["stage"] == "hyper_analysis":
      assert ref["GFLOP"] == 0
      convs = [(32, 48, 3, 1), (16, 24, 5, 2), (8, 12, 5, 2)]  # (out h, out w, k, s)
      assert mine["flops"] == sum(2 * h * w * 320 * k * k * 320 for h, w, k, _ in convs)
    else:
      assert abs(mine["flops"] / 1e9 - ref["GFLOP"]) <= 5e-3, ref["stage"]


def test_roofline_flops_sum_matches_the_counted_model():
  """The stages' FLOPs (JAX's formulas count every tap, padding too) summed
  against utils/profiling's count of ElicAnalysis + HyperAnalysis (real
  pixels only) at 512x768, within 2%: at narrow widths counted here, at
  full width as results/flops_audit.csv records it."""
  port = eval_lib.build_model(measure.flagship_config((8, 8, 8, 16)), init_seed=0, device="cpu")
  x = torch.zeros(1, 512, 768, 3)
  counted = profiling.get_flops(lambda: port._hyper_analysis(port._analysis(x)))
  total = sum(s["flops"] for s in measure.roofline_stages(port, 1, 512, 768))
  assert abs(total - counted) / counted <= 0.02, (total, counted)
  # At full width against results/flops_audit.csv's ElicAnalysis and HyperAnalysis rows.
  full = eval_lib.build_model(configs.TWO_LAYER_SYN_RD, init_seed=0, device="cpu")
  per_px = sum(s["flops"] for s in measure.roofline_stages(full, 1, 512, 768)) / (512 * 768)
  with open(os.path.join(REPO, "results", "flops_audit.csv")) as f:
    # transform,flops_per_pixel,params: the names hold unquoted commas
    audit = {name: float(fpp) for name, fpp, _ in
             (line.rsplit(",", 2) for line in f.read().splitlines()[1:])}
  want = audit["ElicAnalysis(192,192,192,320) [f]"] + audit["HyperAnalysis(320) [f_h]"]
  assert abs(per_px - want) / want <= 0.02, (per_px, want)


def test_roofline_cli_record(tmp_path, monkeypatch):
  """The CLI's record from measure.encode_roofline at 64x64, 1 -> 2 calls."""
  roofline = measure.encode_roofline
  monkeypatch.setattr(measure, "encode_roofline", lambda device, batch: roofline(
      device, batch, 64, 64, CHANNELS, n_lo=1, n_hi=2))
  out = tmp_path / "rf.json"
  rec = _script("torch_encode_roofline").main(["--batch", "1", "--out", str(out), "--device",
                                               "cpu"])
  jax_keys = {"batch", "height", "width", "dtype", "peak_hbm_GBps", "peak_bf16_TFLOPS",
              "sum_stage_ms", "Mpx_per_s_stage_sum", "stages"}
  assert jax_keys | {"device", "sum_stage_kernel_ms"} == set(_load(out)) == set(rec)
  stage_keys = {"stage", "ms", "min_GB", "achieved_GBps", "pct_peak_bw", "GFLOP",
                "pct_peak_flops"}
  for s in rec["stages"]:
    assert stage_keys <= set(s)
    assert ("kernel_ms" in s) == ("unfused_GB" in s) == s["stage"].startswith("rb_chain")
  assert rec["peak_hbm_GBps"] == 3350.0 and rec["peak_bf16_TFLOPS"] == 989.0
  assert (rec["batch"], rec["height"], rec["width"]) == (1, 64, 64)


def test_itinf_bench_cli(tmp_path, narrow, monkeypatch):
  """2 and 4 SGA steps on the CPU: a marginal step time and its rate. The
  CLI's 512x768 batch reaches measure.sga_step_ms, which runs on its top
  left 64x64."""
  step_ms, seen = measure.sga_step_ms, []

  def cropped(model, batch, num_steps, n_lo, n_hi):
    seen.append((batch.shape, num_steps, model.scheduled_num_steps))
    return step_ms(model, batch[:, :64, :64], num_steps, n_lo, n_hi)

  monkeypatch.setattr(measure, "sga_step_ms", cropped)
  out = tmp_path / "it.json"
  rec = _script("torch_itinf_bench").main(
      ["--batch", "2", "--n_lo", "2", "--n_hi", "4", "--out", str(out), "--device", "cpu"])
  assert seen == [((2, 512, 768, 3), 1000, 3000)]
  assert _load(out) == rec and rec["batch"] == 2 and rec["device"] == "cpu"
  assert np.isfinite(rec["ms_per_step"]) and rec["image_steps_per_s"] == 2 * rec["steps_per_s"]


def test_marginal_ms_takes_the_marginal_call(monkeypatch):
  """A loop of n calls that takes 5 + 3 n ms (its first repeat 1 ms more)
  gives 3 ms a call: the best of the repeats, the fixed part cancelled."""
  seen = []

  def loop(fn, n, device=None):
    seen.append(n)
    return 5.0 + 3.0 * n + (1.0 if seen.count(n) == 1 else 0.0)

  monkeypatch.setattr(measure, "loop_ms", loop)
  assert measure.marginal_ms(lambda: None, 4, 12, repeats=2, device="cpu") == pytest.approx(3.0)
  assert seen == [4, 12, 4, 12]
