"""The port's codec (shallow_ntc_tpu_torch/codec, compress.py) against the JAX
package's (shallow_ntc_tpu/codec) on the CPU: the rANS bytes, the tables,
the container both ways, the model codec's symbols and blob length, the
self-roundtrip, the decoded latent against the eval path's, the batch paths,
the JPEG-like model's codec and the CLI across two processes. ELIC at narrow
widths (8, 8, 8, 16) with the flagship synthesis (tests/torch_parity.py)."""

import copy
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from shallow_ntc_tpu.codec import api as jax_api
from shallow_ntc_tpu.codec import bindings as jax_bindings
from shallow_ntc_tpu.codec import tables as jax_tables
from shallow_ntc_tpu.ops import entropy as jax_entropy
from shallow_ntc_tpu_torch import compress as compress_cli
from shallow_ntc_tpu_torch import configs, eval_lib, train_lib
from shallow_ntc_tpu_torch import params as params_lib
from shallow_ntc_tpu_torch.codec import api, bindings, tables
from shallow_ntc_tpu_torch.latents import LatentRVCollection, UQLatentRV
from shallow_ntc_tpu_torch.models.mshyper import Model
from shallow_ntc_tpu_torch.ops import entropy
from tests.torch_parity import SMALL_CONFIG, images, models

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BOUNDARY = 1e-4  # symbols are compared where the value lies farther than this from a .5


def _small_jpegl(model_config):
  cfg = copy.deepcopy(model_config)
  cfg["transform_config"]["analysis"]["channels"] = (8, 8, 8, 16)
  return cfg


JPEGL_SMALL = {"jpegl_rd": _small_jpegl(configs.JPEGL_RD),
               "JPEGL_K16": _small_jpegl(configs.JPEGL_K16)}


def _codecs(model_config):
  jax_model, params, port = models(model_config, seed=0)
  return jax_api.MSHyperCodec(jax_model, params), api.make_codec(port), port


@pytest.fixture(scope="module")
def flagship():
  return _codecs(SMALL_CONFIG)


# --- the coder and its tables ---------------------------------------------------
def test_coder_body_is_the_jax_packages():
  """rans.cc is a copy: everything below its header comment is byte-identical."""
  bodies = []
  for path in ("shallow_ntc_tpu/codec/rans.cc", "shallow_ntc_tpu_torch/codec/rans.cc"):
    with open(os.path.join(REPO, path)) as f:
      bodies.append(f.read().split("#include <cstdint>", 1)[1])
  assert bodies[0] == bodies[1]


def _gaussian_case(seed, n, escapes):
  """Symbols drawn from the Gaussian tables' scales, `escapes` of them out of
  their table's range on either side (escape-coded)."""
  rng = np.random.default_rng(seed)
  y_tables = tables.build_gaussian_tables()
  idx = rng.integers(0, 64, n).astype(np.int32)
  scale = np.exp(np.log(0.11) + (np.log(256.0) - np.log(0.11)) / 63 * idx)
  syms = (np.round(rng.standard_normal(n) * scale) - y_tables.kmin[idx]).astype(np.int32)
  at = rng.choice(n, escapes, replace=False)
  syms[at[: escapes // 2]] = -1 - rng.integers(0, 1000, escapes // 2)
  syms[at[escapes // 2 :]] = (y_tables.tables.sizes[idx[at[escapes // 2 :]]]
                              + rng.integers(0, 1000, escapes - escapes // 2))
  return syms, idx, y_tables


@pytest.mark.parametrize("n,escapes,streams", [(3000, 20, 1), (300_000, 200, 9)])
def test_rans_bytes_equal_jax_and_decode_both_ways(n, escapes, streams):
  """The same symbols, indexes and tables give the same stripes, byte for
  byte; each package decodes the other's. One stripe, and a tensor split into
  9 stripes (300k symbols at ~2 bits: the overhead budget allows 9 of 9)."""
  syms, idx, y_tables = _gaussian_case(n, n, escapes)
  cdfs = np.split(y_tables.tables.cdfs, y_tables.tables.offsets[1:])
  jax_t = jax_bindings.CdfTables(cdfs)
  ours = bindings.rans_encode_striped(syms, idx, y_tables.tables)
  theirs = jax_bindings.rans_encode_striped(syms, idx, jax_t)
  assert len(ours) == streams
  assert ours == theirs
  np.testing.assert_array_equal(bindings.rans_decode_striped(theirs, idx, y_tables.tables), syms)
  np.testing.assert_array_equal(jax_bindings.rans_decode_striped(ours, idx, jax_t), syms)
  assert bindings.stripe_bounds(n, streams) == jax_bindings.stripe_bounds(n, streams)


def test_decode_refuses_indexes_outside_the_tables():
  syms, idx, y_tables = _gaussian_case(1, 100, 0)
  blob = bindings.rans_encode(syms, idx, y_tables.tables)
  with pytest.raises(ValueError, match="table indexes"):
    bindings.rans_decode(blob, idx + 64, y_tables.tables)


def test_gaussian_tables_equal_jax_bit_for_bit():
  ours, theirs = tables.build_gaussian_tables(), jax_tables.build_gaussian_tables()
  np.testing.assert_array_equal(ours.kmin, theirs.kmin)
  np.testing.assert_array_equal(ours.tables.sizes, theirs.tables.sizes)
  np.testing.assert_array_equal(ours.tables.cdfs, theirs.tables.cdfs)
  np.testing.assert_array_equal(ours.tables.lut, theirs.tables.lut)


@pytest.mark.parametrize("escape_mass", [None, 1e-8])
def test_quantize_pmf_equals_jax(escape_mass):
  """Pmfs with zeros, with tiny entries and with sums that need the repair
  walk up and down."""
  rng = np.random.default_rng(7)
  pmfs = [rng.dirichlet(np.ones(40)), rng.dirichlet(np.ones(300) * 0.05),
          np.r_[0.0, 1e-9, 0.7, 0.3, 0.0], rng.uniform(0, 1, 500), np.full(7, 0.13)]
  for pmf in pmfs:
    np.testing.assert_array_equal(tables.quantize_pmf(pmf, escape_mass),
                                  jax_tables.quantize_pmf(pmf, escape_mass))


def test_factorized_tables_match_jax(flagship):
  """kmin equal, every CDF equal or within 2 of 65536 (the largest difference
  is reported), and the offset equal to the eval path's once-per-pass offset.
  The offset is within 1e-5 of JAX's, as tests/test_torch_ops.py holds
  quantization_offset: it ends a 60-step float32 bisection whose branch
  flips where the two packages' CDF logits (equal to 1e-4) straddle the
  target within ~1e-6 of the median (the difference is reported)."""
  jax_codec, codec, port = flagship
  ours, theirs = codec.z_tables, jax_codec.z_tables
  np.testing.assert_array_equal(ours.kmin, theirs.kmin)
  print(f"factorized offsets: max |port - JAX| "
        f"{np.abs(ours.offset - theirs.offset).max():.3e}")
  np.testing.assert_allclose(ours.offset, theirs.offset, atol=1e-5)
  np.testing.assert_array_equal(ours.tables.sizes, theirs.tables.sizes)
  diff = np.abs(ours.tables.cdfs.astype(np.int64) - theirs.tables.cdfs.astype(np.int64))
  print(f"factorized CDFs: largest count difference {diff.max()} of 65536 "
        f"({np.count_nonzero(diff)} of {diff.size} entries differ)")
  assert diff.max() <= 2
  np.testing.assert_array_equal(ours.offset, port.prior_quantization_offset().numpy())


def test_em_quantize_matches_jax():
  """The straight-through roundings of the coding grids, bit for bit, with
  the identity gradient: about the prior's per-channel offset, and about mu."""
  rng = np.random.default_rng(8)
  y = (rng.standard_normal((2, 3, 4, 5)) * 3).astype(np.float32)
  offset = (rng.uniform(-0.5, 0.5, 5)).astype(np.float32)
  loc = (rng.standard_normal(y.shape) * 2).astype(np.float32)
  pairs = [(entropy.batched_em_quantize(torch.from_numpy(y), torch.from_numpy(offset)),
            jax_entropy.batched_em_quantize(jnp.asarray(y), jnp.asarray(offset))),
           (entropy.batched_em_quantize(torch.from_numpy(y), None),
            jax_entropy.batched_em_quantize(jnp.asarray(y), None)),
           (entropy.indexed_em_quantize(torch.from_numpy(y), torch.from_numpy(loc)),
            jax_entropy.indexed_em_quantize(jnp.asarray(y), jnp.asarray(loc)))]
  for ours, theirs in pairs:
    np.testing.assert_array_equal(ours.numpy(), np.asarray(theirs))
  leaf = torch.from_numpy(y).requires_grad_(True)
  entropy.indexed_em_quantize(leaf, torch.from_numpy(loc)).sum().backward()
  np.testing.assert_array_equal(leaf.grad.numpy(), np.ones_like(y))


# --- the container ----------------------------------------------------------------
def _repack(mod, blob):
  version, family, h, w, rest = mod._unpack_header(blob)
  z_chunks, y_chunks = mod._unpack_tensors(rest, 2)
  return (mod._pack_header(version, family, h, w) + mod._pack_tensor(z_chunks)
          + mod._pack_tensor(y_chunks))


def test_container_reads_and_writes_the_jax_bytes(flagship):
  jax_codec, codec, _ = flagship
  x = images(1, (96, 80))
  for blob in (jax_codec.compress(x).bitstring, codec.compress(x).bitstring):
    assert api._unpack_header(blob)[:4] == jax_api._unpack_header(blob)[:4] == (2, 1, 96, 80)
    assert api.stream_counts(blob) == jax_api.stream_counts(blob) == [1, 1]
    assert _repack(api, blob) == _repack(jax_api, blob) == blob
    assert api.fixed_overhead_bytes([1, 1]) == jax_api.fixed_overhead_bytes([1, 1])
  with pytest.raises(ValueError, match="not a shallow_ntc_tpu bitstream"):
    codec.decompress(b"JPEG" + blob[4:])


# --- the model codec ---------------------------------------------------------------
@pytest.mark.parametrize("seed,hw", [(1, (96, 80)), (2, (128, 128)), (3, (50, 70))])
def test_roundtrip_is_bit_exact(flagship, seed, hw):
  """decompress(compress(x)) is the encoder's reconstruction, uint8 [h, w, 3];
  50x70 pads to 64x128."""
  _, codec, _ = flagship
  result = codec.compress(images(seed, hw)[0])
  rec = codec.decompress(result.bitstring)
  assert rec.dtype == np.uint8 and rec.shape == hw + (3,)
  np.testing.assert_array_equal(rec, result.reconstruction)
  assert result.bpp == len(result.bitstring) * 8 / (hw[0] * hw[1])


def _eval_y_hat(port, x, z=None):
  """y_hat of the eval path (frame_loss, training=False, the frozen offset),
  caught at the synthesis; z replaces the analysis's z when given."""
  caught = []
  with torch.no_grad():
    latents = port.infer_latent_rvs(torch.from_numpy(x))
    if z is not None:
      latents = LatentRVCollection(uq=(UQLatentRV(loc=torch.from_numpy(z)), latents.uq[1]))
    synthesize = port.synthesize
    port.synthesize = lambda y_hat: caught.append(y_hat) or synthesize(y_hat)
    try:
      port.frame_loss_given_latent_rvs(torch.from_numpy(x), latents, training=False,
                                       frozen_offset=port.prior_quantization_offset())
    finally:
      del port.synthesize
  return caught[0].numpy()


@pytest.mark.parametrize("seed,hw", [(1, (96, 80)), (3, (50, 70))])
def test_decoded_latent_equals_the_eval_paths(flagship, seed, hw):
  """The decoded y_hat equals the eval path's exactly when the eval starts
  from the encoder's latents: z on its coding grid k + o, as the decoder
  rebuilds it. From the analysis's own z, the eval's straight-through round
  (x + (round(x - o) + o - x), bit-equal to JAX's) lands one float32 ulp off
  k + o in some elements, and y_hat then moves by at most an ulp; the share
  that moves is reported."""
  _, codec, port = flagship
  x = images(seed, hw)
  _, _, y_hat = codec.decode_latent(codec.compress(x).bitstring)
  z, _ = codec._fetch(*codec._analyze(x))()
  z_grid = codec.z_tables.latent_from_symbols(codec.z_tables.symbols_from_latent(z))
  np.testing.assert_array_equal(_eval_y_hat(port, x, z_grid), y_hat)
  raw = _eval_y_hat(port, x)
  ulp = np.spacing(np.abs(y_hat).astype(np.float32))
  print(f"{hw}: from the analysis's z, {np.mean(raw != y_hat):.4f} of y_hat moves, "
        f"by <= {np.abs(raw - y_hat).max():.3e}")
  assert np.all(np.abs(raw - y_hat) <= ulp)


def _coding_values(codec, x, is_jax):
  """(z, y) values and symbols of one compress, as each codec computes them."""
  if is_jax:
    z, y = jax.device_get(codec._analyze(codec.params, jnp.asarray(x)))
  else:
    z, y = codec._fetch(*codec._analyze(x))()
  z_syms = codec.z_tables.symbols_from_latent(z)
  z_hat = codec.z_tables.latent_from_symbols(z_syms)
  if is_jax:
    mu, indexes = jax.device_get(codec._hyper_dec(codec.params, jnp.asarray(z_hat)))
  else:
    mu, indexes = codec._fetch(*codec._hyper_dec(z_hat))()
  y_idx = codec.y_tables.snap_indexes(indexes)
  return dict(z_pre=z - codec.z_tables.offset, z_syms=z_syms, y_pre=y - mu, idx_pre=indexes,
              y_syms=codec.y_tables.symbols_from_latent(y, mu, y_idx))


def _safe(*values):
  """Elements whose pre-rounding values all lie farther than BOUNDARY from a .5."""
  return np.logical_and.reduce([np.abs(np.abs(v - np.floor(v)) - 0.5) > BOUNDARY
                                for v in values])


def check_symbols_match_jax(jax_codec, codec, x):
  """z and y symbols equal the JAX codec's wherever the pre-rounding values
  (of both packages: z - o; y - mu and the scale index) lie farther than 1e-4
  from a rounding boundary; the rest are counted and reported. The blob
  length is within 0.5% of the JAX codec's."""
  ours, theirs = _coding_values(codec, x, False), _coding_values(jax_codec, x, True)
  z_safe = _safe(ours["z_pre"], theirs["z_pre"])
  y_safe = _safe(ours["y_pre"], theirs["y_pre"], ours["idx_pre"], theirs["idx_pre"])
  print(f"{x.shape[1:3]}: z symbols near a boundary {np.count_nonzero(~z_safe)} of "
        f"{z_safe.size}, y {np.count_nonzero(~y_safe)} of {y_safe.size}")
  np.testing.assert_array_equal(ours["z_syms"][z_safe], theirs["z_syms"][z_safe])
  np.testing.assert_array_equal(ours["y_syms"][y_safe], theirs["y_syms"][y_safe])
  n_ours, n_theirs = len(codec.compress(x).bitstring), len(jax_codec.compress(x).bitstring)
  print(f"{x.shape[1:3]}: blob {n_ours} bytes, JAX's {n_theirs}")
  assert abs(n_ours - n_theirs) <= 0.005 * n_theirs


@pytest.mark.parametrize("seed,hw", [(1, (96, 80)), (2, (128, 128))])
def test_symbols_and_blob_length_match_jax(flagship, seed, hw):
  jax_codec, codec, _ = flagship
  check_symbols_match_jax(jax_codec, codec, images(seed, hw))


def test_batch_paths_match_the_per_image_path(flagship):
  """Byte-identical bitstreams and identical latents; reconstructions
  identical under strict=True and within +-1 otherwise. Two shapes, chunks
  of 2: a chunk of two equal images, and shorter chunks where shapes change."""
  _, codec, _ = flagship
  xs = [images(1, (96, 80)), images(2, (96, 80)), images(3, (128, 128)), images(4, (96, 80))]
  singles = [codec.compress(x) for x in xs]
  batch = codec.compress_batch(xs, reconstruct=True, chunk_size=2)
  assert [b.bitstring for b in batch] == [s.bitstring for s in singles]
  for b, s in zip(batch, singles):
    assert np.abs(b.reconstruction.astype(int) - s.reconstruction).max() <= 1
  assert all(r.reconstruction is None for r in codec.compress_batch(xs[:2]))
  blobs = [s.bitstring for s in singles]
  for rec, s in zip(codec.decompress_batch(blobs, chunk_size=2, strict=True), singles):
    np.testing.assert_array_equal(rec, s.reconstruction)
  stacked = []
  synth_u8 = codec._synth_u8
  codec._synth_u8 = lambda y_hat: stacked.append(y_hat) or synth_u8(y_hat)
  try:
    recs = codec.decompress_batch(blobs, chunk_size=2)
  finally:
    del codec._synth_u8
  for rec, s in zip(recs, singles):
    assert rec.shape == s.reconstruction.shape
    assert np.abs(rec.astype(int) - s.reconstruction).max() <= 1
  # The latents the batch decode synthesizes are the per-image decode's.
  np.testing.assert_array_equal(np.concatenate(stacked),
                                np.concatenate([codec.decode_latent(b)[2] for b in blobs]))


def test_make_codec_takes_mshyper_models_only():
  """make_codec dispatches on the family: MSHyperCodec for an mshyper model,
  FactorizedCodec for a factorized one, and TypeError for anything else, as
  the JAX package's make_codec."""
  from shallow_ntc_tpu_torch.models import families

  bls = copy.deepcopy(configs.BLS2017_RD)
  for part in ("analysis", "synthesis"):
    bls["transform_config"][part]["num_filters"] = 8
  factorized = eval_lib.build_model(bls, init_seed=0, device="cpu", family="factorized")
  assert isinstance(api.make_codec(factorized), api.FactorizedCodec)
  assert isinstance(api.make_codec(families.build_model(SMALL_CONFIG, "mshyper")[0]),
                    api.MSHyperCodec)
  with pytest.raises(TypeError):
    api.make_codec(torch.nn.Linear(2, 2))


@pytest.mark.parametrize("name", sorted(JPEGL_SMALL))
def test_jpeg_like_codec_roundtrip_and_symbols(name):
  """The same codec wraps the JPEG-like model: jpegl_rd (k18) and JPEGL_K16
  (k16, the jpegl_synthesize route)."""
  jax_codec, codec, _ = _codecs(JPEGL_SMALL[name])
  x = images(5, (96, 80))
  result = codec.compress(x)
  np.testing.assert_array_equal(codec.decompress(result.bitstring), result.reconstruction)
  check_symbols_match_jax(jax_codec, codec, x)


# --- the CLI -------------------------------------------------------------------
def test_cli_roundtrips_across_two_processes(tmp_path):
  """compress in one process (--init_seed 0), decompress in another (the same
  weights from --params): the in-process codec's reconstruction and bytes;
  roundtrip from a trained workdir (--workdir: its config.json and newest
  checkpoint) is bit-exact. Full width,
  a 40x56 image (padded to 64x64)."""
  img = np.random.default_rng(0).integers(0, 256, (40, 56, 3)).astype(np.uint8)
  np.save(tmp_path / "img.npy", img)
  model = Model(**configs.TWO_LAYER_SYN_RD)
  flat = params_lib.init_params(model, 0)
  np.savez(tmp_path / "params.npz", **flat)
  common = ["--device", "cpu"]
  run = [sys.executable, "-m", "shallow_ntc_tpu_torch.compress"]
  for argv in (["compress", "--init_seed", "0", "--input", str(tmp_path / "img.npy"),
                "--output", str(tmp_path / "img.sntc")],
               ["decompress", "--params", str(tmp_path / "params.npz"),
                "--input", str(tmp_path / "img.sntc"), "--output", str(tmp_path / "rec.npy")]):
    proc = subprocess.run(run + argv + common, cwd=REPO, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr
  codec = api.make_codec(eval_lib.build_model(configs.TWO_LAYER_SYN_RD, init_seed=0,
                                              device="cpu"))
  result = codec.compress(img.astype(np.float32) / 255.0 - 0.5)
  assert (tmp_path / "img.sntc").read_bytes() == result.bitstring
  rec = np.load(tmp_path / "rec.npy")
  assert rec.dtype == np.uint8
  np.testing.assert_array_equal(rec, result.reconstruction)

  params_lib.load_params(model, flat)
  os.makedirs(train_lib.checkpoint_dir(str(tmp_path)))
  torch.save({"model": model.state_dict(), "step": 3},
             os.path.join(train_lib.checkpoint_dir(str(tmp_path)), "ckpt_3.pt"))
  with open(tmp_path / "config.json", "w") as f:  # --workdir reads the model from it
    json.dump({"model_family": "mshyper", "model_config": configs.TWO_LAYER_SYN_RD}, f)
  line = compress_cli.main(["roundtrip", "--workdir", str(tmp_path),
                            "--input", str(tmp_path / "img.npy")] + common)
  assert line.endswith("bit_exact=True")
  assert f"bytes={len(result.bitstring)}" in line
