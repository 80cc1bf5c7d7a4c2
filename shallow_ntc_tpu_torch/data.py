"""Image sources of the port: synthetic images and .npy files.

SyntheticDataset is a copy of shallow_ntc_tpu/data.py:SyntheticDataset.
Training takes random crops of .npy images (NpyRandomCrops). PNG reading
waits: the GPU machine has no image library.
"""

import glob as glob_lib
import os

import numpy as np


def normalize_image(image):
  return image / 255.0 - 0.5


class SyntheticDataset:
  """Deterministic random-image source for tests/benchmarks (no files needed)."""

  def __init__(self, batchsize, patchsize, num_batches=None, seed=0,
               normalize=True, raw_uint8=False):
    self.batchsize = batchsize
    self.patchsize = patchsize
    self.num_batches = num_batches
    self.seed = seed
    self.normalize = normalize
    self.raw_uint8 = raw_uint8

  def __iter__(self):
    rng = np.random.default_rng(self.seed)
    i = 0
    while self.num_batches is None or i < self.num_batches:
      img = rng.integers(
          0, 256, (self.batchsize, self.patchsize, self.patchsize, 3)
      )
      if self.raw_uint8:
        yield img.astype(np.uint8)
      else:
        img = img.astype(np.float32)
        yield normalize_image(img) if self.normalize else img
      i += 1


def npy_images(file_glob: str):
  """Yield normalized [1, H, W, 3] float32 images from .npy files of 0..255 pixels."""
  files = sorted(glob_lib.glob(os.path.expanduser(file_glob)))
  if not files:
    raise RuntimeError(f"No images found with glob '{file_glob}'.")
  for path in files:
    img = np.load(path)
    if img.ndim == 3:
      img = img[None]
    if img.ndim != 4 or img.shape[-1] != 3:
      raise ValueError(f"{path}: expected [H, W, 3] or [1, H, W, 3], got {img.shape}")
    yield normalize_image(img.astype(np.float32))


def _load_npy(path: str) -> np.ndarray:
  img = np.load(path, mmap_mode="r")
  if img.ndim == 4 and img.shape[0] == 1:
    img = img[0]
  if img.ndim != 3 or img.shape[-1] != 3:
    raise ValueError(f"{path}: expected [H, W, 3] or [1, H, W, 3], got {img.shape}")
  return img


class NpyRandomCrops:
  """Endless batches of random patchsize x patchsize crops from .npy images
  of 0..255 pixels, normalized; images and offsets drawn by a seeded numpy
  generator. Images smaller than the patch are skipped, as the JAX
  pipeline's small-image filter skips them."""

  def __init__(self, file_glob: str, batchsize: int, patchsize: int, seed: int = 0):
    files = sorted(glob_lib.glob(os.path.expanduser(file_glob)))
    if not files:
      raise RuntimeError(f"No images found with glob '{file_glob}'.")
    self.files = [f for f in files if min(_load_npy(f).shape[:2]) >= patchsize]
    if not self.files:
      raise RuntimeError(f"No image of '{file_glob}' is at least {patchsize} px on each side.")
    self.batchsize = batchsize
    self.patchsize = patchsize
    self.seed = seed

  def __iter__(self):
    rng = np.random.default_rng(self.seed)
    p = self.patchsize
    while True:
      batch = []
      for i in rng.integers(0, len(self.files), self.batchsize):
        img = _load_npy(self.files[i])
        y = rng.integers(0, img.shape[0] - p + 1)
        x = rng.integers(0, img.shape[1] - p + 1)
        batch.append(np.asarray(img[y : y + p, x : x + p], np.float32))
      yield normalize_image(np.stack(batch))


def get_dataset(data_spec: str, split: str, batchsize: int, patchsize, seed: int = 0):
  """"synthetic" or a glob of .npy images (shallow_ntc_tpu/data.py:get_dataset).

  train: endless random crops; test: 16 synthetic images, or each .npy image
  whole, one at a time.
  """
  train = split == "train"
  if data_spec == "synthetic":
    return SyntheticDataset(batchsize, patchsize or 256, num_batches=None if train else 16,
                            seed=seed)
  if train:
    return NpyRandomCrops(data_spec, batchsize, patchsize or 256, seed)
  return npy_images(data_spec)
