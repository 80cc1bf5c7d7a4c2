"""Image sources of the port: JPEG and PNG files, .npy files and synthetic
images (mirrors shallow_ntc_tpu/data.py).

read_png reads a JPEG or a PNG to uint8 RGB, as the JAX package's read_png
does through PIL. JPEG goes through the port's native loader (dataio/, its
own libjpeg-equal decoder); PNG through the zlib and numpy reader below, at
every bit depth and colour type, interlaced or not, with PIL's
convert("RGB") rules (grey replicated, alpha and tRNS dropped, palette
looked up, sub-byte grey scaled, 16-bit samples' high byte, except 16-bit
grey, which PIL clips to 255). write_png writes 8-bit PNG.

get_dataset resolves names as the JAX package does: "synthetic", then a
name of project_configs.dataset_to_globs, then a glob. A glob of .npy files
keeps the port's own sources (NpyRandomCrops for training, npy_images for
testing); a glob of JPEGs or PNGs goes through DatasetIterable, the JAX
package's pipeline. It draws from one np.random.default_rng(seed) in JAX's
order (the epoch's permutation, then each image's crop), and it takes JAX's
branch: a corpus too large for the RAM cache (compressed bytes x 10 over
ImageStore's cache_limit, as COCO train2017 is) is decoded and cropped
batch by batch on the native loader's threads, with crop seeds drawn from
the same generator; a smaller one is decoded once into the cache and
cropped with numpy. So the same files and seed give JAX's batches byte for
byte on either branch. The tfds names (clic, mnist, cifar10, cifar100)
raise: tensorflow_datasets is not a dependency of the port.
"""

import glob as glob_lib
import os
import queue
import struct
import threading
import zlib
from typing import Iterator, List, Optional, Sequence, Tuple

import numpy as np

from shallow_ntc_tpu_torch import dataio, project_configs

_PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"
_JPEG_SIGNATURE = b"\xff\xd8"
# Colour type -> samples per pixel: grey, RGB, palette, grey + alpha, RGBA.
_PNG_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}
# Colour type -> the bit depths the PNG spec allows for it.
_PNG_DEPTHS = {0: (1, 2, 4, 8, 16), 2: (8, 16), 3: (1, 2, 4, 8), 4: (8, 16), 6: (8, 16)}
# Adam7's passes: (first column, first row, column step, row step).
_ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4), (0, 2, 2, 4), (1, 0, 2, 2),
          (0, 1, 1, 2))
_TFDS_NAMES = ("clic", "mnist", "cifar10", "cifar100")
# Batches made ahead by DatasetIterable's thread (the JAX loader's default).
_PREFETCH = 4


def normalize_image(image):
  return image / 255.0 - 0.5


# ---------------------------------------------------------------------------
# PNG
# ---------------------------------------------------------------------------
def _png_header(head: bytes, filename) -> Tuple[int, int, int, int, int, int, int]:
  """(width, height, bit depth, colour type, compression, filter method,
  interlace) of the IHDR chunk that follows the signature in `head`."""
  if head[:8] != _PNG_SIGNATURE:
    raise ValueError(f"{filename}: neither a PNG nor a JPEG file")
  if len(head) < 33 or head[12:16] != b"IHDR":
    raise ValueError(f"{filename}: truncated PNG (no IHDR chunk)")
  return struct.unpack(">IIBBBBB", head[16:29])


def _png_chunks(data: bytes, filename):
  """Yield (type, payload) of each chunk after the signature, CRCs checked."""
  pos = 8
  while pos + 12 <= len(data):
    (length,) = struct.unpack(">I", data[pos:pos + 4])
    kind = data[pos + 4:pos + 8]
    payload = data[pos + 8:pos + 8 + length]
    (crc,) = struct.unpack(">I", data[pos + 8 + length:pos + 12 + length] or b"\0\0\0\0")
    if len(payload) != length or zlib.crc32(kind + payload) != crc:
      raise ValueError(f"{filename}: corrupt PNG chunk {kind!r} at byte {pos}")
    yield kind, payload
    if kind == b"IEND":
      return
    pos += 12 + length
  raise ValueError(f"{filename}: truncated PNG (no IEND chunk)")


def _paeth(a, b, c):
  p = a + b - c
  pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
  return np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))


def _unfilter(ftype: np.ndarray, filt: np.ndarray, bpp: int, filename) -> np.ndarray:
  """The pixel bytes [H, W * bpp] of filtered scanlines (PNG spec 9.2).

  Any of the five filters is undone along anti-diagonals, where every
  pixel's left, upper and upper-left neighbours are done: H + W - 1 vector
  steps instead of H * W scalar ones (Average and Paeth need the
  reconstructed pixel to the left). The diagonals are columns of a skewed
  copy, pixel (y, x) at s[y + 1, x + y + 2], whose row 0 and left columns
  stay zero as the spec's bytes outside the image."""
  if ftype.size and ftype.max() > 4:
    raise ValueError(f"{filename}: unknown PNG filter type {int(ftype.max())}")
  h, stride = filt.shape
  w = stride // bpp
  f = filt.reshape(h, w, bpp).astype(np.int16)
  s = np.zeros((h + 1, w + h + 1, bpp), np.int16)
  fs = np.zeros((h, w + h + 1, bpp), np.int16)
  for y in range(h):
    fs[y, y + 2:y + 2 + w] = f[y]
  masks = [(ftype == t)[:, None] for t in (1, 2, 3, 4)]
  for d in range(h + w - 1):
    y0, y1 = max(0, d - w + 1), min(h - 1, d) + 1
    a = s[y0 + 1:y1 + 1, d + 1]  # left
    b = s[y0:y1, d + 1]  # up
    c = s[y0:y1, d]  # up-left
    m1, m2, m3, m4 = (m[y0:y1] for m in masks)
    pred = np.where(m1, a, np.where(m2, b, np.where(m3, (a + b) >> 1,
                                                    np.where(m4, _paeth(a, b, c), 0))))
    s[y0 + 1:y1 + 1, d + 2] = (fs[y0:y1, d + 2] + pred) & 255
  out = np.empty((h, w, bpp), np.uint8)
  for y in range(h):
    out[y] = s[y + 1, y + 2:y + 2 + w]
  return out.reshape(h, stride)


def _png_samples(rows: np.ndarray, width: int, channels: int, depth: int) -> np.ndarray:
  """Unfiltered scanlines [H, rowbytes] as samples [H, width, channels]."""
  if depth == 16:
    return rows.view(">u2").reshape(rows.shape[0], width, channels)
  if depth == 8:
    return rows.reshape(rows.shape[0], width, channels)
  bits = np.unpackbits(rows, axis=1).reshape(rows.shape[0], -1, depth)
  weights = (1 << np.arange(depth - 1, -1, -1)).astype(np.uint8)
  return (bits @ weights)[:, :width, None].astype(np.uint8)


def _read_png(filename, data: bytes) -> np.ndarray:
  """A PNG's pixels as uint8 [H, W, 3], by PIL's convert("RGB") rules."""
  width, height, depth, ctype, compression, filter_method, interlace = _png_header(
      data[:33], filename)
  if depth not in _PNG_DEPTHS.get(ctype, ()) or compression or filter_method or interlace > 1:
    raise ValueError(f"{filename}: invalid PNG header (bit depth {depth}, colour type {ctype}, "
                     f"compression {compression}, filter {filter_method}, interlace {interlace})")
  idat, palette = [], None
  for kind, payload in _png_chunks(data, filename):
    if kind == b"IDAT":
      idat.append(payload)
    elif kind == b"PLTE":
      palette = np.frombuffer(payload, np.uint8).reshape(-1, 3)
  if ctype == 3 and palette is None:
    raise ValueError(f"{filename}: palette PNG without a PLTE chunk")
  channels = _PNG_CHANNELS[ctype]
  bpp = max(1, channels * depth // 8)  # the filters' byte distance
  passes = _ADAM7 if interlace else ((0, 0, 1, 1),)
  sizes = [(-(-(height - y0) // dy), -(-(width - x0) // dx)) for x0, y0, dx, dy in passes]
  rowbytes = [-(-pw * channels * depth // 8) for _, pw in sizes]
  expected = sum(ph * (rb + 1) for (ph, pw), rb in zip(sizes, rowbytes) if ph > 0 and pw > 0)
  try:
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
  except zlib.error as e:
    raise ValueError(f"{filename}: corrupt PNG image data ({e})") from None
  if raw.size != expected:
    raise ValueError(f"{filename}: PNG image data of {raw.size} bytes, expected {expected}")
  samples = np.empty((height, width, channels), np.uint16 if depth == 16 else np.uint8)
  pos = 0
  for (x0, y0, dx, dy), (ph, pw), rb in zip(passes, sizes, rowbytes):
    if ph <= 0 or pw <= 0:
      continue
    rows = raw[pos:pos + ph * (rb + 1)].reshape(ph, rb + 1)
    pos += ph * (rb + 1)
    unfiltered = _unfilter(rows[:, 0], rows[:, 1:], bpp, filename)
    samples[y0::dy, x0::dx] = _png_samples(unfiltered, pw, channels, depth)
  if ctype == 3:
    lut = np.zeros((256, 3), np.uint8)
    lut[:len(palette)] = palette[:256]
    return lut[samples[..., 0]]
  if depth == 16:  # PIL keeps the high byte, but clips 16-bit grey ("I;16")
    samples = np.minimum(samples, 255) if ctype == 0 else samples >> 8
  elif depth < 8:  # grey 1, 2, 4 bits scaled to 0..255
    samples = samples * (255 // ((1 << depth) - 1))
  samples = samples.astype(np.uint8)
  if ctype in (0, 4):
    return np.repeat(samples[..., :1], 3, axis=-1)
  return np.ascontiguousarray(samples[..., :3])


def read_png(filename) -> np.ndarray:
  """Load a JPEG or PNG file to a uint8 [H, W, 3] RGB array (the JAX
  package's read_png, data.py:31-37)."""
  with open(filename, "rb") as f:
    data = f.read()
  if data[:2] == _JPEG_SIGNATURE:
    return dataio.decode_image(filename)
  return _read_png(filename, data)


def _png_chunk(kind: bytes, payload: bytes) -> bytes:
  return struct.pack(">I", len(payload)) + kind + payload + struct.pack(
      ">I", zlib.crc32(kind + payload))


def _filter_rows(image: np.ndarray) -> np.ndarray:
  """Each row of a uint8 [H, W, C] image under each of the five filters:
  [5, H, W * C] bytes, held as int16."""
  h, w, bpp = image.shape
  x = image.reshape(h, w * bpp).astype(np.int16)
  a = np.zeros_like(x)
  a[:, bpp:] = x[:, :-bpp]
  b = np.zeros_like(x)
  b[1:] = x[:-1]
  c = np.zeros_like(x)
  c[1:, bpp:] = x[:-1, :-bpp]
  return np.stack([x, x - a, x - b, x - ((a + b) >> 1), x - _paeth(a, b, c)]) & 255


def _png_bytes(ftype: np.ndarray, filtered: np.ndarray, width: int, bpp: int) -> bytes:
  """A PNG file of filtered scanlines [H, W * C] under the filter types
  `ftype` [H]."""
  h = filtered.shape[0]
  scanlines = np.empty((h, width * bpp + 1), np.uint8)
  scanlines[:, 0] = ftype
  scanlines[:, 1:] = filtered
  ctype = {1: 0, 2: 4, 3: 2, 4: 6}[bpp]
  return (_PNG_SIGNATURE
          + _png_chunk(b"IHDR", struct.pack(">IIBBBBB", width, h, 8, ctype, 0, 0, 0))
          + _png_chunk(b"IDAT", zlib.compress(scanlines.tobytes(), 6))
          + _png_chunk(b"IEND", b""))


def write_png(filename, image: np.ndarray):
  """Save a uint8 [H, W] or [H, W, C] array (C = 1 grey, 2 grey + alpha,
  3 RGB, 4 RGBA) as PNG, each row under the filter whose bytes have the
  least sum of magnitudes (the PNG spec's heuristic)."""
  image = np.asarray(image, dtype=np.uint8)
  if image.ndim == 2:
    image = image[..., None]
  if image.ndim != 3 or image.shape[-1] not in (1, 2, 3, 4):
    raise ValueError(f"{filename}: cannot write an image of shape {image.shape} as PNG")
  h, w, bpp = image.shape
  filtered = _filter_rows(image)
  magnitude = np.minimum(filtered, 256 - filtered).sum(axis=-1)  # [5, H]
  choice = magnitude.argmin(axis=0)
  png = _png_bytes(choice, filtered[choice, np.arange(h)], w, bpp)
  os.makedirs(os.path.dirname(os.path.abspath(filename)), exist_ok=True)
  with open(filename, "wb") as f:
    f.write(png)


def image_dimensions(filename) -> Tuple[int, int]:
  """(height, width) from the PNG IHDR or the JPEG frame header alone,
  without decoding pixels (as PIL's lazy open in the JAX package)."""
  with open(filename, "rb") as f:
    head = f.read(33)
  if head[:2] == _JPEG_SIGNATURE:
    return dataio.image_dims(filename)
  width, height = _png_header(head, filename)[:2]
  return height, width


def check_image_size(image: np.ndarray, patchsize: int) -> bool:
  return image.shape[0] >= patchsize and image.shape[1] >= patchsize and image.shape[-1] == 3


def process_image(image: np.ndarray, crop: Optional[str] = None,
                  patchsize: Optional[int] = None,
                  rng: Optional[np.random.Generator] = None,
                  keep_uint8: bool = False) -> np.ndarray:
  """Crop ("random": offsets drawn from `rng`, rows first; "center"), then
  cast to float32 and normalize, unless keep_uint8."""
  if crop is not None:
    if not patchsize or patchsize <= 0:
      raise ValueError(f"a {crop} crop needs a positive patchsize, got {patchsize}")
    h, w = image.shape[:2]
    if crop == "random":
      i = rng.integers(0, h - patchsize + 1)
      j = rng.integers(0, w - patchsize + 1)
    elif crop == "center":
      i = (h - patchsize) // 2
      j = (w - patchsize) // 2
    else:
      raise NotImplementedError(crop)
    image = image[i:i + patchsize, j:j + patchsize]
  if keep_uint8:
    return np.ascontiguousarray(image)
  return normalize_image(image.astype(np.float32))


class ImageStore:
  """Decoded images by index, cached in RAM (uint8) up to cache_limit_bytes
  (shallow_ntc_tpu/data.py:_ImageStore)."""

  def __init__(self, files: Sequence[str], cache_limit_bytes: int = 8 << 30):
    self.files = list(files)
    self._cache = {}
    self._cache_bytes = 0
    self._cache_limit = cache_limit_bytes
    self._lock = threading.Lock()

  @property
  def cache_limit(self) -> int:
    return self._cache_limit

  def __len__(self):
    return len(self.files)

  def get(self, idx: int) -> np.ndarray:
    f = self.files[idx]
    with self._lock:
      hit = self._cache.get(f)
    if hit is not None:
      return hit
    arr = read_png(f)
    with self._lock:
      if self._cache_bytes + arr.nbytes <= self._cache_limit:
        self._cache[f] = arr
        self._cache_bytes += arr.nbytes
    return arr

  def dimensions(self, idx: int) -> Tuple[int, int]:
    """(height, width) without decoding pixels (unless already cached)."""
    f = self.files[idx]
    with self._lock:
      hit = self._cache.get(f)
    if hit is not None:
      return hit.shape[0], hit.shape[1]
    return image_dimensions(f)


class DatasetIterable:
  """Batches of JPEG or PNG images (shallow_ntc_tpu/data.py:DatasetIterable):
  images smaller than the patch are left out by their header size; a train
  split crops at random, a test split at the centre (or not at all without
  a patchsize, yielding images of differing sizes one at a time). Crops of
  a corpus too large for the store's cache are decoded batch by batch by
  the native loader (_native_loader_usable); others come from the cache.
  A background thread keeps up to _PREFETCH batches ready.
  """

  def __init__(self, store: ImageStore, split: str, batchsize: int, patchsize: Optional[int],
               shuffle: bool = False, repeat: bool = False, drop_remainder: bool = False,
               seed: int = 0, raw_uint8: bool = False):
    self.store = store
    self.split = split
    self.batchsize = batchsize
    self.patchsize = patchsize
    self.shuffle = shuffle
    self.repeat = repeat
    self.drop_remainder = drop_remainder
    self.seed = seed
    self.raw_uint8 = raw_uint8
    self.crop = None
    if patchsize is not None:
      self.crop = "random" if split == "train" else "center"

  def _eligible_indices(self) -> List[int]:
    idxs = []
    for i in range(len(self.store)):
      if self.patchsize is not None:
        h, w = self.store.dimensions(i)
        if h < self.patchsize or w < self.patchsize:
          continue
      idxs.append(i)
    if not idxs:
      raise RuntimeError("No images large enough for the requested patchsize.")
    return idxs

  def _native_loader_usable(self) -> bool:
    """Whether crops come from the native loader's decode + crop fan-out
    (shallow_ntc_tpu/data.py:188-206): only for fixed-size crops of a
    corpus whose decoded size (compressed bytes x ~10) exceeds the cache,
    which would otherwise be decoded again every epoch."""
    if self.crop is None:
      return False
    try:
      compressed = sum(os.path.getsize(f) for f in self.store.files)
    except OSError:
      return True
    return compressed * 10 > self.store.cache_limit

  def _batches(self) -> Iterator[np.ndarray]:
    rng = np.random.default_rng(self.seed)
    idxs = self._eligible_indices()
    use_native = self._native_loader_usable()
    while True:
      order = list(idxs)
      if self.shuffle:
        order = list(rng.permutation(order))
      for start in range(0, len(order), self.batchsize):
        chunk = order[start:start + self.batchsize]
        if len(chunk) < self.batchsize and self.drop_remainder:
          continue
        if use_native:
          if self.crop == "random":
            seeds = rng.integers(0, 2**62, len(chunk))
          else:
            seeds = [-1] * len(chunk)
          batch = dataio.decode_crop_batch([self.store.files[i] for i in chunk],
                                           self.patchsize, seeds)
          yield batch if self.raw_uint8 else normalize_image(batch.astype(np.float32))
          continue
        imgs = [process_image(self.store.get(i), crop=self.crop, patchsize=self.patchsize,
                              rng=rng, keep_uint8=self.raw_uint8)
                for i in chunk]
        if self.crop is None and len({im.shape for im in imgs}) > 1:
          for im in imgs:
            yield im[None]
          continue
        yield np.stack(imgs, axis=0)
      if not self.repeat:
        return

  def __iter__(self) -> Iterator[np.ndarray]:
    q: "queue.Queue" = queue.Queue(maxsize=_PREFETCH)
    stop = threading.Event()
    done = object()

    def put(item):
      while not stop.is_set():
        try:
          q.put(item, timeout=0.1)
          return True
        except queue.Full:
          continue
      return False

    def producer():
      try:
        for batch in self._batches():
          if not put(batch):
            return
        put(done)
      except Exception as e:  # handed to the consumer, which raises it
        put(e)

    thread = threading.Thread(target=producer, daemon=True)
    thread.start()
    try:
      while True:
        item = q.get()
        if item is done:
          return
        if isinstance(item, Exception):
          raise item
        yield item
    finally:
      stop.set()


def get_dataset_from_glob(file_glob: str, shuffle: bool, repeat: bool, drop_remainder: bool,
                          batchsize: int, crop=None, patchsize=None, seed: int = 0,
                          raw_uint8: bool = False) -> DatasetIterable:
  """The JPEG/PNG pipeline over the sorted files of `file_glob`."""
  files = sorted(glob_lib.glob(os.path.expanduser(file_glob)))
  if not files:
    raise RuntimeError(f"No images found with glob '{file_glob}'.")
  return DatasetIterable(ImageStore(files), split="train" if crop == "random" else "test",
                         batchsize=batchsize, patchsize=patchsize, shuffle=shuffle, repeat=repeat, drop_remainder=drop_remainder,
                         seed=seed, raw_uint8=raw_uint8)


# ---------------------------------------------------------------------------
# Synthetic images and .npy files
# ---------------------------------------------------------------------------
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


def get_dataset(data_spec: str, split: str, batchsize: int, patchsize: Optional[int],
                seed: int = 0, raw_uint8: bool = False):
  """The dataset of a name or glob (shallow_ntc_tpu/data.py:get_dataset).

  train: shuffled, repeated, the remainder dropped, random crops; test: one
  pass in file order, centre crops (none without a patchsize). "synthetic"
  is 16 test images or endless train batches of patchsize (256) pixels.
  A glob of .npy images: train endless random crops (NpyRandomCrops), test
  each image whole, one at a time.
  """
  train = split == "train"
  if data_spec == "synthetic":
    return SyntheticDataset(batchsize, patchsize or 256, num_batches=None if train else 16,
                            seed=seed, raw_uint8=raw_uint8)
  if data_spec in _TFDS_NAMES:
    raise ValueError(f"dataset {data_spec!r} is a tensorflow_datasets name; the port reads "
                     "file globs and the names of project_configs.dataset_to_globs")
  file_glob = project_configs.dataset_to_globs.get(data_spec, data_spec)
  files = sorted(glob_lib.glob(os.path.expanduser(file_glob)))
  if files and all(f.endswith(".npy") for f in files):
    if train:
      return NpyRandomCrops(file_glob, batchsize, patchsize or 256, seed)
    return npy_images(file_glob)
  return get_dataset_from_glob(
      file_glob, shuffle=train, repeat=train, drop_remainder=train, batchsize=batchsize,
      crop=("random" if train else "center") if patchsize is not None else None,
      patchsize=patchsize, seed=seed, raw_uint8=raw_uint8)
