"""Image sources of the port's eval: synthetic images and .npy files.

SyntheticDataset is a copy of shallow_ntc_tpu/data.py:SyntheticDataset.
PNG reading waits: the GPU machine has no image library.
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
