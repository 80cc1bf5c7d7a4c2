"""The port's PNG reader and writer, its reading of the images it once
refused (JPEG, 16-bit, sub-byte, Adam7), its glob datasets, its name
resolution and its dead-leaves generator against the JAX package (PIL) and
scripts/make_deadleaves_dataset.py, on the CPU.

Pixels are compared exactly, batches byte for byte.
"""

import importlib.util
import json
import os
import subprocess
import sys

import numpy as np
import pytest
from PIL import Image

from shallow_ntc_tpu import data as jax_data
from shallow_ntc_tpu_torch import data as data_lib
from shallow_ntc_tpu_torch import deadleaves

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SIZES = [(1, 9), (7, 1), (13, 17), (40, 33)]


def _pil_image(arr, mode):
  im = Image.fromarray(arr)
  if mode == "P":
    return im.convert("P", palette=Image.ADAPTIVE, colors=200)
  return im.convert(mode)


@pytest.mark.parametrize("mode", ["RGB", "RGBA", "L", "LA", "P"])
def test_read_png_of_pil_files_equals_jax(tmp_path, mode):
  """PNGs that PIL writes (adaptive filters 0-4; palettes saved at 8 bits)
  read to JAX's read_png pixels, down to 1xN and Nx1."""
  rng = np.random.default_rng(len(mode))
  for h, w in SIZES:
    arr = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
    arr[h // 2:, : w // 2] = arr[0, 0]  # flat regions, so rows take other filters
    path = str(tmp_path / f"{mode}_{h}x{w}.png")
    _pil_image(arr, mode).save(path, **({"bits": 8} if mode == "P" else {}))
    got = data_lib.read_png(path)
    assert got.dtype == np.uint8 and got.shape == (h, w, 3)
    np.testing.assert_array_equal(got, jax_data.read_png(path))
    assert data_lib.image_dimensions(path) == jax_data.image_dimensions(path) == (h, w)


@pytest.mark.parametrize("channels", [1, 2, 3, 4])
def test_write_png_is_read_by_jax(tmp_path, channels):
  """The port's PNGs (per-row filter choice) hold the array's pixels for PIL,
  and JAX's read_png gives the port's read_png."""
  rng = np.random.default_rng(channels)
  for h, w in SIZES + [(64, 96)]:
    arr = rng.integers(0, 256, (h, w, channels), dtype=np.uint8)
    arr[:, w // 3:] = np.sort(arr[:, w // 3:], axis=1)  # smooth rows: Sub/Avg/Paeth win
    path = str(tmp_path / f"{channels}_{h}x{w}.png")
    data_lib.write_png(path, arr[..., 0] if channels == 1 else arr)
    with Image.open(path) as im:
      np.testing.assert_array_equal(np.asarray(im).reshape(h, w, channels), arr)
    np.testing.assert_array_equal(data_lib.read_png(path), jax_data.read_png(path))
    assert data_lib.image_dimensions(path) == jax_data.image_dimensions(path)


@pytest.mark.parametrize("ftype", range(5))
def test_read_png_undoes_each_filter(tmp_path, ftype):
  """Every row under one filter type (None, Sub, Up, Average, Paeth), at
  1, 2, 3 and 4 samples a pixel: PIL and JAX's read_png read the array back,
  and so does the port."""
  rng = np.random.default_rng(ftype)
  for bpp in (1, 2, 3, 4):
    for h, w in SIZES:
      arr = rng.integers(0, 256, (h, w, bpp), dtype=np.uint8)
      path = str(tmp_path / f"f{ftype}_{bpp}_{h}x{w}.png")
      with open(path, "wb") as f:
        f.write(data_lib._png_bytes(np.full(h, ftype), data_lib._filter_rows(arr)[ftype], w, bpp))
      with Image.open(path) as im:
        np.testing.assert_array_equal(np.asarray(im).reshape(h, w, bpp), arr)
      np.testing.assert_array_equal(data_lib.read_png(path), jax_data.read_png(path))


def _adam7(path, arr):
  """An Adam7-interlaced 8-bit RGB PNG (PIL writes none), by the fixtures'
  writer."""
  sys.path.insert(0, os.path.join(REPO, "scripts"))
  try:
    import make_jpeg_fixtures
  finally:
    sys.path.pop(0)
  with open(path, "wb") as f:
    f.write(make_jpeg_fixtures.png_bytes(arr, 8, 2, interlace=True))


@pytest.mark.parametrize("kind", ["16bit", "1bit", "4bit_palette", "interlaced", "jpeg",
                                  "truncated"])
def test_unsupported_images_raise_naming_the_file(tmp_path, kind):
  """The images the port's reader once refused (16-bit, 1-bit, 4-bit palette,
  Adam7, JPEG) read to JAX's read_png pixels and header size; a truncated
  PNG still raises, naming the file."""
  arr = np.random.default_rng(0).integers(0, 256, (8, 12, 3), dtype=np.uint8)
  path = str(tmp_path / f"img_{kind}.{'jpg' if kind == 'jpeg' else 'png'}")
  if kind == "16bit":
    Image.fromarray(arr[..., 0].astype(np.uint16) * 257).convert("I;16").save(path)
  elif kind == "1bit":
    Image.fromarray(arr).convert("1").save(path)
  elif kind == "4bit_palette":
    Image.fromarray(arr).convert("P", palette=Image.ADAPTIVE, colors=8).save(path)
  elif kind == "interlaced":
    _adam7(path, arr)
  elif kind == "jpeg":
    Image.fromarray(arr).save(path)
  else:
    data_lib.write_png(path, arr)
    with open(path, "rb") as f:
      data = f.read()
    with open(path, "wb") as f:
      f.write(data[:-20])
    with pytest.raises(ValueError, match=os.path.basename(path)):
      data_lib.read_png(path)
    return
  got = data_lib.read_png(path)
  assert got.dtype == np.uint8 and got.shape == (8, 12, 3)
  np.testing.assert_array_equal(got, jax_data.read_png(path))
  assert data_lib.image_dimensions(path) == jax_data.image_dimensions(path) == (8, 12)


# Six images, two of them smaller than the patch on one side.
_DATASET = [(40, 56), (32, 32), (24, 70), (64, 48), (30, 90), (50, 50)]
PATCH = 32


@pytest.fixture(scope="module")
def png_dir(tmp_path_factory):
  d = tmp_path_factory.mktemp("pngs")
  rng = np.random.default_rng(7)
  for i, (h, w) in enumerate(_DATASET):
    Image.fromarray(rng.integers(0, 256, (h, w, 3), dtype=np.uint8)).save(d / f"im{i}.png")
  return str(d / "*.png")


def _take(ds, n):
  out = []
  for batch in ds:
    out.append(np.asarray(batch))
    if len(out) == n:
      break
  return out


@pytest.mark.parametrize("seed", [0, 3])
@pytest.mark.parametrize("raw_uint8", [False, True])
def test_train_batches_equal_jax(png_dir, seed, raw_uint8):
  """The first five train batches (shuffled epochs, the remainder dropped,
  random crops) equal JAX's byte for byte, as uint8 and as float."""
  got = _take(data_lib.get_dataset(png_dir, "train", 3, PATCH, seed=seed, raw_uint8=raw_uint8),
              5)
  ref = _take(jax_data.get_dataset(png_dir, "train", 3, PATCH, seed=seed, raw_uint8=raw_uint8),
              5)
  assert len(got) == 5
  for g, r in zip(got, ref):
    assert g.dtype == r.dtype and g.shape == r.shape == (3, PATCH, PATCH, 3)
    assert g.tobytes() == r.tobytes()


@pytest.mark.parametrize("patchsize", [PATCH, None])
def test_test_split_equals_jax(png_dir, patchsize):
  """The test split, centre-cropped or whole (differing sizes one at a time)."""
  got = list(data_lib.get_dataset(png_dir, "test", 2, patchsize))
  ref = list(jax_data.get_dataset(png_dir, "test", 2, patchsize))
  assert len(got) == len(ref) == (2 if patchsize else 6)
  for g, r in zip(got, ref):
    assert g.dtype == r.dtype and g.shape == r.shape and g.tobytes() == r.tobytes()


def test_tfds_names_raise_and_npy_globs_keep_their_sources(tmp_path):
  for name in ("clic", "mnist", "cifar10", "cifar100"):
    with pytest.raises(ValueError, match="tensorflow_datasets"):
      data_lib.get_dataset(name, "test", 1, None)
  np.save(tmp_path / "a.npy", np.zeros((40, 40, 3), np.uint8))
  assert isinstance(data_lib.get_dataset(str(tmp_path / "*.npy"), "train", 2, 32),
                    data_lib.NpyRandomCrops)
  with pytest.raises(RuntimeError, match="No images found"):
    data_lib.get_dataset(str(tmp_path / "*.png"), "test", 1, None)


def test_dataset_names_resolve_as_jax(tmp_path):
  """SHALLOW_NTC_DATA_DIR / SHALLOW_NTC_PROJECT_DIR move the names' globs the
  same way in both packages (a fresh process imports both), and the eval
  split of a generated dead-leaves name reads the same pixels in both."""
  dl = tmp_path / "proj" / "data" / "deadleaves"
  code = (
      "import json, jax, numpy as np\n"
      "jax.config.update('jax_platforms', 'cpu')\n"
      "from shallow_ntc_tpu import project_configs as j, data as jd\n"
      "from shallow_ntc_tpu_torch import project_configs as p, data as pd\n"
      "from shallow_ntc_tpu_torch import deadleaves\n"
      f"deadleaves.main(['--out', {str(dl)!r}, '--num_train', '0', '--num_valid', '0',\n"
      "                  '--num_eval', '2', '--eval_hw', '24x40', '--workers', '1'])\n"
      "a = list(pd.get_dataset('deadleaves_eval', 'test', 1, None))\n"
      "b = list(jd.get_dataset('deadleaves_eval', 'test', 1, None))\n"
      "print(json.dumps([j.dataset_to_globs == p.dataset_to_globs, j.project_dir == p.project_dir,\n"
      "                  j.slurm_jobs_dir == p.slurm_jobs_dir, p.dataset_to_globs,\n"
      "                  len(a), all(x.tobytes() == y.tobytes() for x, y in zip(a, b))]))\n")
  env = dict(os.environ, SHALLOW_NTC_DATA_DIR=str(tmp_path / "data"),
             SHALLOW_NTC_PROJECT_DIR=str(tmp_path / "proj"), JAX_PLATFORMS="cpu",
             PYTHONPATH=REPO)
  proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env, capture_output=True,
                        text=True, timeout=300)
  assert proc.returncode == 0, proc.stderr
  same_globs, same_project, same_jobs, globs, n, same_pixels = json.loads(
      proc.stdout.strip().splitlines()[-1])
  assert same_globs and same_project and same_jobs
  assert globs["kodak"] == os.path.join(str(tmp_path / "data"), "kodak", "*.png")
  assert globs["deadleaves_eval"] == str(dl / "eval" / "*.png")
  assert n == 2 and same_pixels


def test_deadleaves_image_equals_the_script():
  spec = importlib.util.spec_from_file_location(
      "make_deadleaves_dataset", os.path.join(REPO, "scripts", "make_deadleaves_dataset.py"))
  script = importlib.util.module_from_spec(spec)
  spec.loader.exec_module(script)
  for seed in (1000, 900001):
    np.testing.assert_array_equal(deadleaves.deadleaves_image(seed, 48, 64),
                                  script.deadleaves_image(seed, 48, 64))
