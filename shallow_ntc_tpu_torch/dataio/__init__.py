"""ctypes binding of the port's native image loader (dataio/loader.cc).

Mirrors shallow_ntc_tpu/dataio: the same three C entry points, decode_image,
image_dims and decode_crop_batch, with their semantics (JPEG and PNG to
8-bit RGB, a batch of centre or seeded random crops decoded on std::threads;
ctypes releases the GIL for the call, so a prefetch thread decodes while the
train step runs). The library is compiled once by g++ into
shallow_ntc_tpu_torch/_build/ under a name that carries the source's hash,
as codec/bindings.py builds the rANS coder. It needs zlib's header only:
JPEG is decoded by the source's own libjpeg-equal decoder. A failed build
raises with the compiler's message; there is no other JPEG reader in the
port.
"""

import ctypes
import hashlib
import os
import re
import shutil
import threading
from typing import Sequence, Tuple

import numpy as np

from shallow_ntc_tpu_torch.ops import cuda_build

SOURCE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "loader.cc")
CXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17", "-pthread")

# loader.cc's status codes.
_ERRORS = {
    -1: "cannot be read",
    -3: "is neither a JPEG nor a PNG file",
    -4: "is a JPEG that cannot be decoded to RGB (CMYK/YCCK, arithmetic-coded, lossless or "
        "12-bit)",
    -5: "is corrupt or truncated",
}

_lock = threading.Lock()
_lib = None


def library_path() -> str:
  """Where the library built from loader.cc lives."""
  with open(SOURCE, "rb") as f:
    digest = hashlib.sha256(f.read() + " ".join(CXX_FLAGS).encode()).hexdigest()[:16]
  return os.path.join(cuda_build.BUILD_DIR, f"libloader_{digest}.so")


def build() -> str:
  """Compile loader.cc with g++ unless its library exists; return its path."""
  out = library_path()
  if os.path.exists(out):
    return out
  cxx = shutil.which("g++")
  if cxx is None:
    raise RuntimeError("g++ not found: the image loader (dataio/loader.cc) needs a C++ compiler")
  try:
    return cuda_build.compile_library([cxx, *CXX_FLAGS, SOURCE, "-lz"], out)
  except RuntimeError as e:
    missing = re.search(r"fatal error: (\S+): No such file", str(e))
    if missing:
      raise RuntimeError(f"the image loader needs the header {missing.group(1)} (zlib's "
                         f"development files), which the compiler did not find:\n{e}") from None
    raise


def _get_lib() -> ctypes.CDLL:
  global _lib
  with _lock:
    if _lib is None:
      lib = ctypes.CDLL(build())
      c_int_p = ctypes.POINTER(ctypes.c_int)
      u8 = ctypes.POINTER(ctypes.c_uint8)
      lib.decode_image.restype = ctypes.c_int
      lib.decode_image.argtypes = [ctypes.c_char_p, u8, ctypes.c_int64, c_int_p, c_int_p]
      lib.image_dims.restype = ctypes.c_int
      lib.image_dims.argtypes = [ctypes.c_char_p, c_int_p, c_int_p]
      lib.decode_crop_batch.restype = ctypes.c_int
      lib.decode_crop_batch.argtypes = [
          ctypes.POINTER(ctypes.c_char_p), ctypes.c_int, ctypes.c_int,
          ctypes.POINTER(ctypes.c_int64), u8, ctypes.c_int]
      _lib = lib
  return _lib


def _raise(path, rc: int):
  msg = f"{path} {_ERRORS.get(rc, f'failed to decode (status {rc})')}"
  raise (FileNotFoundError if rc == -1 else ValueError)(msg)


def image_dims(path) -> Tuple[int, int]:
  """(height, width) from the file's JPEG frame header or PNG IHDR, without
  decoding pixels."""
  h, w = ctypes.c_int(), ctypes.c_int()
  rc = _get_lib().image_dims(os.fsencode(path), ctypes.byref(h), ctypes.byref(w))
  if rc:
    _raise(path, rc)
  return h.value, w.value


def decode_image(path) -> np.ndarray:
  """Decode one JPEG or PNG to a uint8 [H, W, 3] RGB array, in a buffer sized
  from the file's header."""
  h, w = image_dims(path)
  out = np.empty((h, w, 3), np.uint8)
  got_h, got_w = ctypes.c_int(), ctypes.c_int()
  rc = _get_lib().decode_image(os.fsencode(path),
                               out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), out.nbytes,
                               ctypes.byref(got_h), ctypes.byref(got_w))
  if rc:
    _raise(path, rc)
  return out


def _fails(path, patch: int) -> str:
  """Why `path` cannot give a patch x patch crop, or "" if it can."""
  try:
    h, w = decode_image(path).shape[:2]
  except (OSError, ValueError) as e:
    return str(e)
  return f"{path} is {h}x{w}" if min(h, w) < patch else ""


def decode_crop_batch(paths: Sequence[str], patch: int, seeds: Sequence[int],
                      threads: int = 8) -> np.ndarray:
  """Decode + crop a batch to uint8 [N, patch, patch, 3] on `threads` C++
  threads. seeds[i] < 0 takes the centre crop, otherwise std::mt19937_64
  seeded with it draws the offsets. Raises naming every image that failed
  (unreadable, undecodable or smaller than the patch)."""
  n = len(paths)
  if len(seeds) != n:
    raise ValueError(f"{n} paths but {len(seeds)} seeds")
  out = np.empty((n, patch, patch, 3), np.uint8)
  c_paths = (ctypes.c_char_p * n)(*[os.fsencode(p) for p in paths])
  c_seeds = np.ascontiguousarray(seeds, np.int64)
  nfail = _get_lib().decode_crop_batch(
      c_paths, n, patch, c_seeds.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
      out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), threads)
  if nfail:
    failed = [_fails(p, patch) for p in paths]
    raise RuntimeError(f"native loader: {nfail} of {n} images failed: "
                       f"{'; '.join(filter(None, failed))}")
  return out
