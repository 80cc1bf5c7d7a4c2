"""ctypes binding of the host rANS coder (codec/rans.cc), built at first use.

Mirrors shallow_ntc_tpu/codec/bindings.py: the same CDF tables, decode LUT,
stripe rule and thread pool, so that both packages write the same bytes.
The library is compiled once by g++ into shallow_ntc_tpu_torch/_build/
under a name that carries the source's hash, as the CUDA sources are
(ops/cuda_build.compile_library: a temporary file moved into place, so a
concurrent build never loads a partial file). A missing compiler raises:
there is no pure-Python coder.
"""

import ctypes
import hashlib
import os
import shutil
import threading
from concurrent.futures import ThreadPoolExecutor

import numpy as np

from shallow_ntc_tpu_torch.ops import cuda_build

SOURCE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "rans.cc")
CXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")

_lock = threading.Lock()
_lib = None


def library_path() -> str:
  """Where the library built from rans.cc lives."""
  with open(SOURCE, "rb") as f:
    digest = hashlib.sha256(f.read() + " ".join(CXX_FLAGS).encode()).hexdigest()[:16]
  return os.path.join(cuda_build.BUILD_DIR, f"librans_{digest}.so")


def build() -> str:
  """Compile rans.cc with g++ unless its library exists; return its path."""
  out = library_path()
  if os.path.exists(out):
    return out
  cxx = shutil.which("g++")
  if cxx is None:
    raise RuntimeError("g++ not found: the rANS coder (codec/rans.cc) needs a C++ compiler")
  return cuda_build.compile_library([cxx, *CXX_FLAGS, SOURCE], out)


def _get_lib():
  global _lib
  with _lock:
    if _lib is None:
      lib = ctypes.CDLL(build())
      i32, i64 = ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int64)
      u8, u32 = ctypes.POINTER(ctypes.c_uint8), ctypes.POINTER(ctypes.c_uint32)
      tables = [u32, i64, i32, ctypes.c_int32]  # cdfs, cdf_offsets, cdf_sizes, num_tables
      lib.rans_encode.restype = ctypes.c_int64
      lib.rans_encode.argtypes = [i32, i32, ctypes.c_int64, *tables, u8, ctypes.c_int64]
      lib.rans_decode.restype = ctypes.c_int32
      lib.rans_decode.argtypes = [u8, ctypes.c_int64, i32, ctypes.c_int64, *tables, i32, i32]
      lib.rans_decode_multi.restype = ctypes.c_int32
      # bytes (stripes back to back), byte_offsets [S+1], sym_offsets [S+1],
      # num_stripes, indexes (whole tensor), tables, bucket LUT, symbols_out
      lib.rans_decode_multi.argtypes = [u8, i64, i64, ctypes.c_int32, i32, *tables, i32, i32]
      lib.rans_build_lut.restype = None
      lib.rans_build_lut.argtypes = [*tables, i32]
      _lib = lib
  return _lib


def _ptr(arr, ctype):
  return arr.ctypes.data_as(ctypes.POINTER(ctype))


class CdfTables:
  """Concatenated quantized CDF tables (each: cdf[0]=0 .. cdf[size]=65536).

  The last slot of every table is the escape symbol (out-of-range values are
  raw-coded with ~34 bits).
  """

  LUT_BITS = 12  # must match kLutBits in rans.cc

  def __init__(self, cdfs_list):
    if not all(c[0] == 0 and c[-1] == 65536 for c in cdfs_list):
      raise ValueError("every CDF must run from 0 to 65536")
    self.sizes = np.asarray([len(c) - 1 for c in cdfs_list], np.int32)
    self.offsets = np.zeros(len(cdfs_list), np.int64)
    np.cumsum([len(c) for c in cdfs_list[:-1]], out=self.offsets[1:])
    self.cdfs = np.concatenate(cdfs_list).astype(np.uint32)
    self._lut = None

  @property
  def num_tables(self):
    return len(self.sizes)

  def _args(self):
    return (_ptr(self.cdfs, ctypes.c_uint32), _ptr(self.offsets, ctypes.c_int64),
            _ptr(self.sizes, ctypes.c_int32), ctypes.c_int32(self.num_tables))

  @property
  def lut(self) -> np.ndarray:
    """Bucket lookup table for O(1) decode-side symbol search, built once per
    table set."""
    if self._lut is None:
      lut = np.empty(self.num_tables << self.LUT_BITS, np.int32)
      _get_lib().rans_build_lut(*self._args(), _ptr(lut, ctypes.c_int32))
      self._lut = lut
    return self._lut


def _check_indexes(indexes: np.ndarray, tables: CdfTables):
  if indexes.size and (indexes.min() < 0 or indexes.max() >= tables.num_tables):
    raise ValueError(f"table indexes must lie in [0, {tables.num_tables})")


def rans_encode(symbols, indexes, tables: CdfTables) -> bytes:
  """Entropy-code int32 `symbols` (table-local alphabet) under per-element
  `indexes` into a byte string."""
  symbols = np.ascontiguousarray(symbols, np.int32).ravel()
  indexes = np.ascontiguousarray(indexes, np.int32).ravel()
  if symbols.shape != indexes.shape:
    raise ValueError(f"{symbols.size} symbols for {indexes.size} indexes")
  _check_indexes(indexes, tables)
  n = symbols.size
  capacity = max(1024, n * 8 + 64)  # escape worst case ~ 34 bits/symbol
  out = np.empty(capacity, np.uint8)
  nbytes = _get_lib().rans_encode(
      _ptr(symbols, ctypes.c_int32), _ptr(indexes, ctypes.c_int32), ctypes.c_int64(n),
      *tables._args(), _ptr(out, ctypes.c_uint8), ctypes.c_int64(capacity))
  if nbytes < 0:
    raise RuntimeError(f"rans_encode failed with code {nbytes}")
  return out[:nbytes].tobytes()


def rans_decode(data: bytes, indexes, tables: CdfTables) -> np.ndarray:
  """Inverse of rans_encode; returns int32 symbols shaped like `indexes`."""
  indexes = np.ascontiguousarray(indexes, np.int32)
  _check_indexes(indexes, tables)
  flat = indexes.ravel()
  out = np.empty(flat.size, np.int32)
  buf = np.frombuffer(data, np.uint8)
  rc = _get_lib().rans_decode(
      _ptr(buf, ctypes.c_uint8), ctypes.c_int64(buf.size), _ptr(flat, ctypes.c_int32),
      ctypes.c_int64(flat.size), *tables._args(), _ptr(tables.lut, ctypes.c_int32),
      _ptr(out, ctypes.c_int32))
  if rc != 0:
    raise RuntimeError(f"rans_decode failed with code {rc}")
  return out.reshape(indexes.shape)


# ---------------------------------------------------------------------------
# Striped (multi-stream) coding: N independent rANS streams over contiguous
# symbol stripes, encoded and decoded on a thread pool (ctypes releases the
# GIL for each C call). Stripe bounds are a function of (n, num_streams), so
# only the stream count travels in the container.
# ---------------------------------------------------------------------------
STRIPE_MIN_SYMBOLS = 32768   # don't split tiny tensors
STREAM_FIXED_BYTES = 8       # 4-byte length prefix + 4-byte rANS flush
MAX_STREAMS = 16

_pool = None


def _get_pool():
  global _pool
  with _lock:
    if _pool is None:
      _pool = ThreadPoolExecutor(max_workers=MAX_STREAMS)
  return _pool


def stripe_bounds(n: int, num_streams: int):
  return [(i * n) // num_streams for i in range(num_streams + 1)]


def rans_encode_striped(symbols, indexes, tables: CdfTables,
                        max_streams: int = MAX_STREAMS,
                        overhead_frac: float = 0.0015):
  """Encode as a list of independent per-stripe streams (length >= 1).

  The stream count gives decode parallelism wherever the tensor is big
  enough, while the per-stream fixed cost (length prefix + state flush)
  stays below `overhead_frac` of the payload: after a first pass the count
  is cut and the tensor encoded again if the budget is exceeded.
  """
  symbols = np.ascontiguousarray(symbols, np.int32).ravel()
  indexes = np.ascontiguousarray(indexes, np.int32).ravel()
  n = symbols.size

  def encode_with(s):
    bounds = stripe_bounds(n, s)
    jobs = [(symbols[bounds[i]:bounds[i + 1]], indexes[bounds[i]:bounds[i + 1]])
            for i in range(s)]
    if s == 1:
      return [rans_encode(*jobs[0], tables)]
    return list(_get_pool().map(lambda a: rans_encode(a[0], a[1], tables), jobs))

  s = max(1, min(int(max_streams), n // STRIPE_MIN_SYMBOLS))
  chunks = encode_with(s)
  if s > 1:
    payload = sum(len(c) for c in chunks)
    s_budget = max(1, int(overhead_frac * payload / STREAM_FIXED_BYTES))
    if s_budget < s:
      chunks = encode_with(s_budget)
  return chunks


def _decode_multi(chunks, flat_indexes, sym_offsets, tables: CdfTables, out: np.ndarray):
  """One rans_decode_multi call over a run of stripes (interleaved in C)."""
  data = np.frombuffer(b"".join(chunks), np.uint8)
  byte_offsets = np.zeros(len(chunks) + 1, np.int64)
  np.cumsum([len(c) for c in chunks], out=byte_offsets[1:])
  sym_offsets = np.ascontiguousarray(sym_offsets, np.int64)
  rc = _get_lib().rans_decode_multi(
      _ptr(data, ctypes.c_uint8), _ptr(byte_offsets, ctypes.c_int64),
      _ptr(sym_offsets, ctypes.c_int64), ctypes.c_int32(len(chunks)),
      _ptr(flat_indexes, ctypes.c_int32), *tables._args(), _ptr(tables.lut, ctypes.c_int32),
      _ptr(out, ctypes.c_int32))
  if rc != 0:
    raise RuntimeError(f"rans_decode_multi failed with code {rc}")


def rans_decode_striped(chunks, indexes, tables: CdfTables) -> np.ndarray:
  """Inverse of rans_encode_striped: stripes split over threads in contiguous
  groups, each group one rans_decode_multi call."""
  indexes = np.ascontiguousarray(indexes, np.int32)
  _check_indexes(indexes, tables)
  flat = indexes.ravel()
  n = flat.size
  s = len(chunks)
  if s == 1:
    return rans_decode(chunks[0], flat, tables).reshape(indexes.shape)
  bounds = np.asarray(stripe_bounds(n, s), np.int64)
  out = np.empty(n, np.int32)
  workers = min(s, os.cpu_count() or 1)
  if workers <= 1:
    _decode_multi(chunks, flat, bounds, tables, out)
    return out.reshape(indexes.shape)
  group_edges = [(w * s) // workers for w in range(workers + 1)]

  def run(w):
    lo, hi = group_edges[w], group_edges[w + 1]
    _decode_multi(chunks[lo:hi], flat, bounds[lo:hi + 1], tables, out)

  list(_get_pool().map(run, range(workers)))
  return out.reshape(indexes.shape)
