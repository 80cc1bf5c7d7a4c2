"""The port's native image loader (shallow_ntc_tpu_torch/dataio) and its JPEG
input against the JAX package, on the CPU.

JAX's loader (shallow_ntc_tpu/dataio) links libjpeg-turbo and libpng; the
port's carries its own JPEG decoder and a PNG decoder on zlib (the GPU
machine has neither library's headers). Both are built from their sources
here. The images are tests/data/jpeg/ (scripts/make_jpeg_fixtures.py) and
PNGs written by that script into tmp directories.

Measured (this file's inputs): every JPEG decodes bit for bit as JAX's
native loader does, and also as PIL's read (JAX's read_png) does: max
|diff| 0 over the 15 decodable JPEGs, against the bound mean |diff| < 2 of
tests/test_dataio.py:39-47.

JAX's loader is never called on a PNG with a tRNS chunk: for colour types
without alpha it expands tRNS to an alpha channel it does not strip, writes
four bytes a pixel into rows of three and overruns its buffer (the process
aborts). The port drops the alpha, as PIL's convert("RGB") does.
"""

import ast
import glob
import hashlib
import itertools
import json
import os
import subprocess
import sys
import threading
import time

import numpy as np
import pytest
from PIL import Image

from shallow_ntc_tpu import data as jax_data
from shallow_ntc_tpu import dataio as jax_dataio
from shallow_ntc_tpu_torch import data as data_lib
from shallow_ntc_tpu_torch import dataio

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURES = os.path.join(REPO, "tests", "data", "jpeg")
NAMES = sorted(os.listdir(FIXTURES))
# What JAX's native loader can be asked about: not the tRNS PNG (it aborts)
# and not the CMYK JPEG (neither loader decodes it).
NATIVE_NAMES = [n for n in NAMES if "trns" not in n and n != "cmyk.jpg"]
JPEGS = [n for n in NAMES if n.endswith(".jpg") and n != "cmyk.jpg"]
COCO = sorted(glob.glob(os.path.join(FIXTURES, "coco_*.jpg")))
PATCH = 256


def _png_writer():
  sys.path.insert(0, os.path.join(REPO, "scripts"))
  try:
    import make_jpeg_fixtures
  finally:
    sys.path.pop(0)
  return make_jpeg_fixtures.png_bytes


def test_fixtures_are_committed_and_small():
  assert len(NAMES) == 21 and len(COCO) == 8
  assert sum(os.path.getsize(os.path.join(FIXTURES, n)) for n in NAMES) < 1 << 20
  for f in COCO:
    with Image.open(f) as im:
      assert im.size == (640, 480) and im.mode == "RGB"


def _sha256(pixels):
  return hashlib.sha256(np.ascontiguousarray(pixels).tobytes()).hexdigest()


def test_committed_digests_are_jax_reads_and_the_ports():
  """tests/data/jpeg_sha256.json (what chip_smoke.py holds the port to where
  neither PIL nor libjpeg is installed) is the JAX package's two reads of
  each image, and the port's."""
  with open(os.path.join(REPO, "tests", "data", "jpeg_sha256.json")) as f:
    refs = json.load(f)
  assert sorted(refs) == NAMES
  for name, ref in refs.items():
    path = os.path.join(FIXTURES, name)
    pil = jax_data.read_png(path)
    assert list(pil.shape) == ref["shape"] and _sha256(pil) == ref["read_png"]
    assert (ref["decode_image"] is None) == (name in ("cmyk.jpg", "pal4_trns.png"))
    if name != "cmyk.jpg":
      assert _sha256(data_lib.read_png(path)) == ref["read_png"]
    if ref["decode_image"] is not None:
      assert _sha256(jax_dataio.decode_image(path)) == ref["decode_image"]
      assert _sha256(dataio.decode_image(path)) == ref["decode_image"]


@pytest.mark.parametrize("name", NATIVE_NAMES)
def test_decode_image_equals_jax_native(name):
  path = os.path.join(FIXTURES, name)
  got = dataio.decode_image(path)
  ref = jax_dataio.decode_image(path)
  assert got.dtype == np.uint8 and got.shape == ref.shape
  np.testing.assert_array_equal(got, ref)


# PIL encoder settings, each written at every size below in RGB 4:4:4,
# 4:2:2 and 4:2:0 and in grey: 8 x 10 x 4 = 320 JPEGs.
JPEG_KINDS = {
    "q85": dict(quality=85), "q100": dict(quality=100), "q5": dict(quality=5),
    "optimized": dict(quality=75, optimize=True),
    "progressive": dict(quality=90, progressive=True),
    "progressive_optimized": dict(quality=50, progressive=True, optimize=True),
    "restart_every_mcu": dict(quality=85, restart_marker_blocks=1),
    "progressive_restart": dict(quality=85, restart_marker_blocks=3, progressive=True),
}
JPEG_SIZES = [(1, 1), (1, 9), (9, 1), (2, 2), (3, 5), (7, 9), (17, 33), (31, 47), (64, 3),
              (100, 141)]


@pytest.mark.parametrize("kind", sorted(JPEG_KINDS))
def test_pil_jpeg_variants_equal_jax_native(tmp_path, kind):
  """Sizes down to 1x1 (partial MCUs, box upsampling below 3 chroma
  samples), every subsampling and grey, noise and smooth content: the
  port's decoder equals JAX's libjpeg-turbo loader bit for bit."""
  rng = np.random.default_rng(sorted(JPEG_KINDS).index(kind))
  for h, w in JPEG_SIZES:
    arr = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
    if h > 8:
      arr = np.sort(arr, axis=1)  # smooth rows: fewer, larger coefficients
    for mode, sub in [("RGB", "4:4:4"), ("RGB", "4:2:2"), ("RGB", "4:2:0"), ("L", None)]:
      path = str(tmp_path / f"{h}x{w}_{mode}_{sub}.jpg".replace(":", ""))
      Image.fromarray(arr).convert(mode).save(
          path, **JPEG_KINDS[kind], **({"subsampling": sub} if sub else {}))
      np.testing.assert_array_equal(dataio.decode_image(path), jax_dataio.decode_image(path),
                                    err_msg=path)


@pytest.mark.parametrize("name", ["coco_000.jpg", "restart.jpg", "grey.jpg", "s422.jpg"])
def test_truncated_sequential_jpeg_equals_jax_native(tmp_path, name):
  """A sequential JPEG cut short (no EOI) decodes as libjpeg does: the MCU
  where the data ends finishes on zero bits, the rest of its restart
  interval stays grey, later intervals decode. (A progressive file cut
  before its last scan differs: libjpeg then smooths blocks, which the port
  does not; ROADMAP queue 1 item 7.)"""
  with open(os.path.join(FIXTURES, name), "rb") as f:
    data = f.read()
  for frac in (0.3, 0.6, 0.95):
    path = str(tmp_path / f"{frac}_{name}")
    with open(path, "wb") as f:
      f.write(data[:int(len(data) * frac)])
    np.testing.assert_array_equal(dataio.decode_image(path), jax_dataio.decode_image(path))


@pytest.mark.parametrize("name", JPEGS)
def test_jpeg_read_png_within_jax_bound_of_pil(name):
  """read_png of a JPEG (the native loader) against JAX's read_png (PIL):
  mean |diff| < 2 as tests/test_dataio.py holds JAX's loader; max 0 here."""
  path = os.path.join(FIXTURES, name)
  got = data_lib.read_png(path).astype(int)
  ref = jax_data.read_png(path).astype(int)
  assert got.shape == ref.shape
  assert np.abs(got - ref).mean() < 2
  assert np.abs(got - ref).max() == 0


@pytest.mark.parametrize("name", [n for n in NAMES if n.endswith(".png")])
def test_png_fixtures_equal_jax_read_png(name):
  path = os.path.join(FIXTURES, name)
  np.testing.assert_array_equal(data_lib.read_png(path), jax_data.read_png(path))


# (colour type, bit depth): every combination the PNG spec allows.
PNG_KINDS = [(0, 1), (0, 2), (0, 4), (0, 8), (0, 16), (2, 8), (2, 16), (3, 1), (3, 2), (3, 4),
             (3, 8), (4, 8), (4, 16), (6, 8), (6, 16)]


@pytest.mark.parametrize("interlace", [False, True])
@pytest.mark.parametrize("ctype,depth", PNG_KINDS)
def test_every_png_kind_equals_jax(tmp_path, ctype, depth, interlace):
  """Each colour type at each bit depth, Adam7 or not, at sizes down to 1x1:
  read_png equals JAX's read_png (PIL), with and without a tRNS chunk, and
  the native decode equals JAX's native decode (no tRNS: JAX's overruns)."""
  png_bytes = _png_writer()
  rng = np.random.default_rng(100 * ctype + depth + interlace)
  channels = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}[ctype]
  for h, w in [(1, 1), (1, 9), (7, 1), (9, 17), (23, 14)]:
    samples = rng.integers(0, 2**depth, (h, w, channels))
    palette = rng.integers(0, 256, (max(1, 2**depth - 3), 3)) if ctype == 3 else None
    path = str(tmp_path / f"{h}x{w}.png")
    with open(path, "wb") as f:
      f.write(png_bytes(samples, depth, ctype, interlace, palette=palette))
    got = data_lib.read_png(path)
    assert got.shape == (h, w, 3)
    np.testing.assert_array_equal(got, jax_data.read_png(path))
    native = dataio.decode_image(path)
    np.testing.assert_array_equal(native, jax_dataio.decode_image(path))
    if ctype in (0, 2, 3):
      trns = bytes(3) if ctype == 3 else bytes(2 * channels)
      with open(path, "wb") as f:
        f.write(png_bytes(samples, depth, ctype, interlace, palette=palette, trns=trns))
      np.testing.assert_array_equal(data_lib.read_png(path), jax_data.read_png(path))
      np.testing.assert_array_equal(dataio.decode_image(path), native)


def test_16bit_grey_follows_each_jax_path():
  """JAX's two paths disagree on 16-bit grey, and the port follows each: the
  whole-image read clips as PIL does, the native decode keeps the high
  byte as libpng's png_set_strip_16 does."""
  path = os.path.join(FIXTURES, "grey16.png")
  with Image.open(path) as im:
    raw = np.asarray(im).astype(np.int64)  # mode I;16
  whole, native = data_lib.read_png(path), dataio.decode_image(path)
  np.testing.assert_array_equal(whole[..., 0], np.minimum(raw, 255))
  np.testing.assert_array_equal(native[..., 0], raw >> 8)
  np.testing.assert_array_equal(whole, jax_data.read_png(path))
  np.testing.assert_array_equal(native, jax_dataio.decode_image(path))
  assert (whole != native).any()


def _cut_after_header(src, dst):
  """The file up to its JPEG frame header or PNG IHDR: no pixel data."""
  with open(src, "rb") as f:
    data = f.read()
  end = 33
  if data[:2] == b"\xff\xd8":
    end = 2
    while data[end + 1] not in (0xC0, 0xC1, 0xC2):  # segment by segment to the frame
      end += 2 + int.from_bytes(data[end + 2:end + 4], "big")
    end += 2 + int.from_bytes(data[end + 2:end + 4], "big")
  with open(dst, "wb") as f:
    f.write(data[:end])


@pytest.mark.parametrize("name", NAMES)
def test_image_dimensions_from_the_header(tmp_path, name):
  """image_dimensions equals PIL's size; it reads the header alone, so it
  holds for the file cut after its header, which cannot be decoded."""
  path = os.path.join(FIXTURES, name)
  with Image.open(path) as im:
    w, h = im.size
  assert data_lib.image_dimensions(path) == jax_data.image_dimensions(path) == (h, w)
  cut = str(tmp_path / name)
  _cut_after_header(path, cut)
  assert data_lib.image_dimensions(cut) == dataio.image_dims(cut) == (h, w)
  with pytest.raises(ValueError, match=name):
    data_lib.read_png(cut)


@pytest.mark.parametrize("threads", [1, 4])
def test_decode_crop_batch_equals_jax(threads):
  """Random crops (std::mt19937_64 per seed) and centre crops (seed -1) of
  the 640x480 JPEGs equal JAX's, at 1 and 4 threads; centre crops equal
  the same window of the whole decode."""
  seeds = [0, 2**62 - 1, -1, 12345, -1, 7, 99, 2**40 + 3]
  got = dataio.decode_crop_batch(COCO, PATCH, seeds, threads=threads)
  ref = jax_dataio.decode_crop_batch(COCO, PATCH, seeds, threads=threads)
  assert got.shape == (8, PATCH, PATCH, 3)
  np.testing.assert_array_equal(got, ref)
  np.testing.assert_array_equal(got, dataio.decode_crop_batch(COCO, PATCH, seeds, threads=8))
  y0, x0 = (480 - PATCH) // 2, (640 - PATCH) // 2
  for i in (2, 4):
    whole = dataio.decode_image(COCO[i])
    np.testing.assert_array_equal(got[i], whole[y0:y0 + PATCH, x0:x0 + PATCH])


@pytest.mark.parametrize("raw_uint8", [False, True])
@pytest.mark.parametrize("split,seed", [("train", 0), ("train", 9), ("test", 0)])
def test_native_branch_equals_jax(split, seed, raw_uint8):
  """A store whose cache_limit is under 10x the compressed bytes takes the
  native branch in both packages; the batches are JAX's byte for byte, and
  the random crops differ from the cached branch's."""
  train = split == "train"
  kw = dict(shuffle=train, repeat=train, drop_remainder=train, seed=seed, raw_uint8=raw_uint8)
  small = sum(os.path.getsize(f) for f in COCO) * 10 - 1
  ds = data_lib.DatasetIterable(data_lib.ImageStore(COCO, cache_limit_bytes=small), split, 3,
                                PATCH, **kw)
  ref = jax_data.DatasetIterable(jax_data._ImageStore(COCO, cache_limit_bytes=small), split, 3,
                                 PATCH, **kw)
  assert ds.store.cache_limit == small
  assert ds._native_loader_usable() and ref._native_loader_usable()
  n = 5 if train else 3
  got = list(itertools.islice(ds, n))
  want = list(itertools.islice(ref, n))
  assert len(got) == n and [b.shape[0] for b in got] == [b.shape[0] for b in want]
  for g, r in zip(got, want):
    assert g.dtype == r.dtype == (np.uint8 if raw_uint8 else np.float32)
    assert g.tobytes() == r.tobytes()
  cached = data_lib.DatasetIterable(data_lib.ImageStore(COCO), split, 3, PATCH, **kw)
  assert not cached._native_loader_usable()
  first = next(iter(cached))
  assert (first.tobytes() != got[0].tobytes()) == train


def test_cocotrain_reads_jpegs_as_jax(tmp_path, monkeypatch):
  """The flagship config's dataset name, resolved to a directory of the
  JPEGs (small enough for the cache): get_dataset gives JAX's batches."""
  coco = tmp_path / "coco" / "train2017"
  coco.mkdir(parents=True)
  for f in COCO:
    os.symlink(f, coco / os.path.basename(f))
  glob_ = str(coco / "*.jpg")
  monkeypatch.setitem(data_lib.project_configs.dataset_to_globs, "cocotrain", glob_)
  got = list(itertools.islice(data_lib.get_dataset("cocotrain", "train", 8, PATCH, seed=3), 2))
  want = list(itertools.islice(jax_data.get_dataset(glob_, "train", 8, PATCH, seed=3), 2))
  assert len(got) == 2
  for g, r in zip(got, want):
    assert g.shape == (8, PATCH, PATCH, 3) and g.tobytes() == r.tobytes()


def test_decode_releases_the_gil():
  """DatasetIterable's prefetch thread decodes while the train step runs
  Python: during one long decode_crop_batch call in a thread, the main
  thread keeps running (its longest stall stays well under the call)."""
  paths = COCO * 8
  done = threading.Event()
  took = []

  def decode():
    t = time.perf_counter()
    dataio.decode_crop_batch(paths, PATCH, list(range(len(paths))), threads=1)
    took.append(time.perf_counter() - t)
    done.set()

  dataio.decode_image(COCO[0])  # the library is built and loaded
  thread = threading.Thread(target=decode)
  stamps = [time.perf_counter()]
  thread.start()
  while not done.is_set():
    stamps.append(time.perf_counter())
  stamps.append(time.perf_counter())
  thread.join(timeout=60)
  assert not thread.is_alive() and took
  assert max(np.diff(stamps)) < 0.5 * took[0], (max(np.diff(stamps)), took[0])


def test_codec_cli_reads_jpeg_input():
  """The codec CLI takes a JPEG as JAX's does (compress.py reads any image
  through read_png)."""
  from shallow_ntc_tpu_torch import compress

  path = os.path.join(FIXTURES, "s422.jpg")
  np.testing.assert_array_equal(compress.load_image(path), jax_data.read_png(path))


def test_failures_raise_naming_the_file(tmp_path):
  missing = str(tmp_path / "missing.jpg")
  cmyk = os.path.join(FIXTURES, "cmyk.jpg")
  assert jax_dataio.decode_image(cmyk) is None  # JAX's native path fails on it too
  with Image.open(cmyk) as im:  # which PIL, JAX's cached path, reads
    assert im.mode == "CMYK" and np.asarray(im.convert("RGB")).shape == (149, 211, 3)
  with pytest.raises(FileNotFoundError, match="missing.jpg"):
    data_lib.read_png(missing)
  with pytest.raises(FileNotFoundError, match="missing.jpg"):
    dataio.decode_image(missing)
  with pytest.raises(ValueError, match="cmyk.jpg.*CMYK"):
    data_lib.read_png(cmyk)
  text = str(tmp_path / "notes.png")
  with open(text, "w") as f:
    f.write("not an image")
  with pytest.raises(ValueError, match="notes.png"):
    dataio.decode_image(text)
  with pytest.raises(RuntimeError, match="3 of 4") as err:
    dataio.decode_crop_batch([COCO[0], cmyk, missing, os.path.join(FIXTURES, "grey1.png")],
                             PATCH, [1, 2, 3, 4])
  assert "cmyk.jpg" in str(err.value) and "missing.jpg" in str(err.value)
  assert "grey1.png is 37x53" in str(err.value) and "coco_000" not in str(err.value)


def test_failed_build_raises_naming_the_header(tmp_path, monkeypatch):
  """No fallback: a source that cannot compile raises with the compiler's
  message and the header it missed."""
  src = tmp_path / "loader.cc"
  src.write_text("#include <no_such_header_zz.h>\nint x;\n")
  monkeypatch.setattr(dataio, "SOURCE", str(src))
  monkeypatch.setattr(dataio.cuda_build, "BUILD_DIR", str(tmp_path / "build"))
  with pytest.raises(RuntimeError, match="needs the header no_such_header_zz.h"):
    dataio.build()


_FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "orbax", "ml_collections", "absl", "PIL",
              "tensorflow", "shallow_ntc_tpu"}


def _imported_roots(path):
  with open(path) as f:
    tree = ast.parse(f.read(), path)
  for node in ast.walk(tree):
    if isinstance(node, ast.Import):
      yield from (a.name.split(".")[0] for a in node.names)
    elif isinstance(node, ast.ImportFrom) and node.level == 0:
      yield node.module.split(".")[0]


def test_port_scripts_and_smoke_import_no_jax_or_pil():
  """Every import statement of the port (dataio/ included, also those inside
  functions), of scripts/torch_*.py and of chip_smoke.py, tensorboardX only
  in utils/writers.py; then a process that reads a JPEG and a native batch
  and imports the profiling and writer modules has loaded no JAX or PIL
  module, nor tensorboardX."""
  files = (glob.glob(os.path.join(REPO, "shallow_ntc_tpu_torch", "**", "*.py"), recursive=True)
           + glob.glob(os.path.join(REPO, "scripts", "torch_*.py"))
           + [os.path.join(REPO, "chip_smoke.py")])
  assert any(f.endswith(os.path.join("dataio", "__init__.py")) for f in files)
  # The R-D result tools: the package module and its CLIs.
  assert {os.path.join("shallow_ntc_tpu_torch", "results.py")} | {
      os.path.join("scripts", f"torch_{name}.py") for name in (
          "itinf_to_results", "measure_codec_overhead", "int8_quality", "vis_syn_filters",
          "recompute_itinf_metrics")} <= {os.path.relpath(f, REPO) for f in files}
  bad = {os.path.relpath(f, REPO): sorted(set(_imported_roots(f)) & _FORBIDDEN) for f in files}
  assert not {k: v for k, v in bad.items() if v}
  tensorboard = [os.path.relpath(f, REPO) for f in files if "tensorboardX" in _imported_roots(f)]
  assert tensorboard == [os.path.join("shallow_ntc_tpu_torch", "utils", "writers.py")]
  code = ("import sys\n"
          "from shallow_ntc_tpu_torch import data, dataio\n"
          "from shallow_ntc_tpu_torch.utils import profiling, writers\n"
          "assert 'tensorboardX' not in sys.modules\n"
          f"assert data.read_png({COCO[0]!r}).shape == (480, 640, 3)\n"
          f"assert dataio.decode_crop_batch({COCO[:2]!r}, 64, [1, -1]).shape == (2, 64, 64, 3)\n"
          f"bad = sorted(n for n in sys.modules if n.split('.')[0] in {sorted(_FORBIDDEN)!r})\n"
          "assert not bad, bad\n")
  proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True,
                        timeout=120)
  assert proc.returncode == 0, proc.stderr
