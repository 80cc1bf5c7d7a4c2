"""A reader of TensorFlow's checkpoint format (TensorBundle) in Python and
numpy, for machines without TensorFlow.

A checkpoint `prefix` (what `tf.train.Checkpoint.save` returns, e.g.
`.../ckpt-1`) is two kinds of file:
  <prefix>.index                 a sorted table in LevelDB's format (the one
                                 tensorflow/core/lib/io/table writes): key ""
                                 holds a BundleHeaderProto, every other key a
                                 tensor's name and its BundleEntryProto;
  <prefix>.data-%05d-of-%05d     the shards, the tensors' raw bytes.
The table ends in a 48-byte footer (two block handles, then the magic
0xdb4775248b80fb57); its index block maps each data block's last key to the
block's handle. A block holds prefix-compressed entries (shared, unshared
and value lengths as varints, then the key's unshared bytes and the value),
an array of restart offsets and their count, and a 5-byte trailer: the
compression type and the masked crc32c (Castagnoli) of the block and that
type byte. Every block and every tensor read is held to its crc32c; a
compressed block, a partitioned (sliced) tensor, a big-endian bundle, a bad
magic or a size that does not fit raises TFCheckpointError naming the file
and the key. String tensors are listed, never decoded.

  latest_checkpoint(dir)   the prefix that `<dir>/checkpoint` names, as
                           tf.train.latest_checkpoint gives it;
  list_variables(prefix)   {name: (dtype name, shape)};
  read_variables(prefix)   {name: ndarray} of the numeric tensors.
"""

import codecs
import functools
import math
import os
import re
import struct
from typing import Dict, Iterable, Iterator, List, Optional, Tuple

import numpy as np

_TABLE_MAGIC = 0xDB4775248B80FB57
_FOOTER_BYTES = 48
_TRAILER_BYTES = 5  # compression type + masked crc32c
_CRC_MASK_DELTA = 0xA282EAD8
_CRC_POLY = 0x82F63B78  # Castagnoli, reflected
_STRING, _BFLOAT16 = 7, 14  # DT_STRING, DT_BFLOAT16
# DataType enum (tensorflow/core/framework/types.proto) -> (name, numpy dtype
# of the stored bytes). bfloat16 is read as uint16 and widened to float32.
_DTYPES = {1: ("float32", "<f4"), 2: ("float64", "<f8"), 3: ("int32", "<i4"),
           9: ("int64", "<i8"), 14: ("bfloat16", "<u2"), 19: ("float16", "<f2")}
_NAMES = {7: "string", 10: "bool", 4: "uint8", 6: "int8", 5: "int16", 17: "uint16",
          22: "uint32", 23: "uint64", 8: "complex64", 18: "complex128"}


class TFCheckpointError(ValueError):
  """A checkpoint file that this reader cannot or must not read."""


# ---------------------------------------------------------------------------
# crc32c, vectorised
# ---------------------------------------------------------------------------
def _byte_table() -> np.ndarray:
  t = np.arange(256, dtype=np.uint32)
  for _ in range(8):
    t = np.where(t & 1, (t >> 1) ^ np.uint32(_CRC_POLY), t >> 1).astype(np.uint32)
  return t


_TABLE = _byte_table()


def _apply(cols: np.ndarray, v: np.ndarray) -> np.ndarray:
  """The GF(2)-linear map whose image of bit k is cols[k], applied to v."""
  out = np.zeros_like(v)
  for k in range(32):
    out ^= ((v >> np.uint32(k)) & np.uint32(1)) * cols[k]
  return out


@functools.lru_cache(maxsize=None)
def _shift_cols(log2_bytes: int) -> np.ndarray:
  """The crc register's map over 2**log2_bytes zero bytes, as 32 columns."""
  if log2_bytes == 0:
    bits = np.uint32(1) << np.arange(32, dtype=np.uint32)
    return _TABLE[bits & np.uint32(0xFF)] ^ (bits >> np.uint32(8))
  half = _shift_cols(log2_bytes - 1)
  return _apply(half, half)


def _shift(v: np.ndarray, n_bytes: int) -> np.ndarray:
  """The register v after n_bytes zero bytes."""
  j = 0
  while n_bytes:
    if n_bytes & 1:
      v = _apply(_shift_cols(j), v)
    n_bytes >>= 1
    j += 1
  return v


def crc32c(data) -> int:
  """crc32c (Castagnoli) of a bytes-like object.

  The register from 0 is linear in the data and unmoved by leading zero
  bytes, so the data, padded in front to m rows of L bytes, is run through
  the byte table one column at a time for all rows at once, and the rows'
  registers are folded pairwise, the left one shifted over its right
  neighbour's bytes. The initial 0xffffffff is then shifted over all n bytes.
  """
  buf = np.frombuffer(data, np.uint8)
  n = buf.size
  if n == 0:
    return 0
  row = 1 << max(0, round(math.log2(max(1, math.isqrt(n // 256)))))
  m = -(-n // row)
  cols = np.zeros(m * row, np.uint8)
  cols[m * row - n:] = buf
  cols = np.ascontiguousarray(cols.reshape(m, row).T)
  reg = np.zeros(m, np.uint32)
  for col in cols:
    reg = _TABLE[(reg ^ col) & np.uint32(0xFF)] ^ (reg >> np.uint32(8))
  width = row
  while reg.size > 1:
    if reg.size % 2:
      reg = np.concatenate([np.zeros(1, np.uint32), reg])
    reg = _apply(_shift_cols(int(math.log2(width))), reg[0::2]) ^ reg[1::2]
    width *= 2
  start = _shift(np.array([0xFFFFFFFF], np.uint32), n)
  return int((reg[0] ^ start[0]) ^ np.uint32(0xFFFFFFFF))


def masked_crc32c(data) -> int:
  """crc32c as TF and LevelDB store it: rotated right by 15, plus a constant."""
  crc = crc32c(data)
  return (((crc >> 15) | (crc << 17)) + _CRC_MASK_DELTA) & 0xFFFFFFFF


# ---------------------------------------------------------------------------
# Varints, protobuf fields, table blocks
# ---------------------------------------------------------------------------
def _varint(buf: bytes, pos: int) -> Tuple[int, int]:
  value = shift = 0
  while True:
    if pos >= len(buf) or shift > 63:
      raise ValueError("truncated or overlong varint")
    byte = buf[pos]
    pos += 1
    value |= (byte & 0x7F) << shift
    shift += 7
    if byte < 0x80:
      return value, pos


def _fields(buf: bytes) -> Iterator[Tuple[int, object]]:
  """(field number, value) of a serialized protobuf message."""
  pos = 0
  while pos < len(buf):
    tag, pos = _varint(buf, pos)
    number, wire = tag >> 3, tag & 7
    if wire == 0:
      value, pos = _varint(buf, pos)
    elif wire == 1:
      value, pos = struct.unpack_from("<Q", buf, pos)[0], pos + 8
    elif wire == 2:
      size, pos = _varint(buf, pos)
      value, pos = buf[pos:pos + size], pos + size
    elif wire == 5:
      value, pos = struct.unpack_from("<I", buf, pos)[0], pos + 4
    else:
      raise ValueError(f"wire type {wire} of field {number}")
    if pos > len(buf):
      raise ValueError("truncated message")
    yield number, value


def _int64(v: int) -> int:
  return v - (1 << 64) if v >= 1 << 63 else v


def _shape(buf: bytes) -> Tuple[int, ...]:
  """TensorShapeProto: repeated Dim dim = 2 (int64 size = 1)."""
  dims = []
  for number, value in _fields(buf):
    if number == 2:
      size = 0
      for n, v in _fields(value):
        if n == 1:
          size = _int64(v)
      dims.append(size)
  return tuple(dims)


def _entry(buf: bytes) -> Dict[str, object]:
  """BundleEntryProto: dtype 1, shape 2, shard_id 3, offset 4, size 5,
  crc32c 6 (fixed32), slices 7."""
  entry = dict(dtype=0, shape=(), shard_id=0, offset=0, size=0, crc32c=0, slices=0)
  for number, value in _fields(buf):
    if number == 1:
      entry["dtype"] = value
    elif number == 2:
      entry["shape"] = _shape(value)
    elif number == 3:
      entry["shard_id"] = value
    elif number == 4:
      entry["offset"] = _int64(value)
    elif number == 5:
      entry["size"] = _int64(value)
    elif number == 6:
      entry["crc32c"] = value
    elif number == 7:
      entry["slices"] += 1
  return entry


def _block(data: bytes, handle: Tuple[int, int], path: str, what: str) -> bytes:
  """The contents of the block at handle (offset, size), its trailer checked."""
  offset, size = handle
  end = offset + size + _TRAILER_BYTES
  if offset < 0 or end > len(data):
    raise TFCheckpointError(f"{path}: {what} block [{offset}, {end}) lies past the file's "
                            f"{len(data)} bytes")
  ctype = data[offset + size]
  stored = struct.unpack_from("<I", data, offset + size + 1)[0]
  if masked_crc32c(data[offset:offset + size + 1]) != stored:
    raise TFCheckpointError(f"{path}: {what} block at {offset}: crc32c mismatch")
  if ctype != 0:
    raise TFCheckpointError(f"{path}: {what} block at {offset} has compression type {ctype}; "
                            "only uncompressed tables are read")
  return data[offset:offset + size]


def _block_entries(block: bytes, path: str, what: str) -> Iterator[Tuple[bytes, bytes]]:
  """(key, value) of a block's entries; each key shares a prefix with the
  one before it."""
  if len(block) < 4:
    raise TFCheckpointError(f"{path}: {what} block of {len(block)} bytes")
  n_restarts = struct.unpack_from("<I", block, len(block) - 4)[0]
  limit = len(block) - 4 * (1 + n_restarts)
  if limit < 0:
    raise TFCheckpointError(f"{path}: {what} block: {n_restarts} restarts in {len(block)} bytes")
  key, pos = b"", 0
  while pos < limit:
    shared, pos = _varint(block, pos)
    unshared, pos = _varint(block, pos)
    value_len, pos = _varint(block, pos)
    if shared > len(key) or pos + unshared + value_len > limit:
      raise TFCheckpointError(f"{path}: {what} block: a corrupt entry at {pos}")
    key = key[:shared] + block[pos:pos + unshared]
    pos += unshared
    yield key, block[pos:pos + value_len]
    pos += value_len


def _data_block_handles(data: bytes, path: str) -> List[Tuple[int, int]]:
  """The handles of the table's data blocks, from the footer's index block."""
  if len(data) < _FOOTER_BYTES:
    raise TFCheckpointError(f"{path}: {len(data)} bytes, shorter than a table footer")
  footer = data[-_FOOTER_BYTES:]
  if struct.unpack_from("<Q", footer, _FOOTER_BYTES - 8)[0] != _TABLE_MAGIC:
    raise TFCheckpointError(f"{path}: bad table magic")
  pos = 0
  handles = []
  for _ in range(2):  # metaindex, index
    offset, pos = _varint(footer, pos)
    size, pos = _varint(footer, pos)
    handles.append((offset, size))
  out = []
  for _, value in _block_entries(_block(data, handles[1], path, "index"), path, "index"):
    offset, pos = _varint(value, 0)
    size, _ = _varint(value, pos)
    out.append((offset, size))
  return out


def _read_index(prefix: str) -> Tuple[int, Dict[str, Dict[str, object]]]:
  """(number of shards, {tensor name: entry}) of `<prefix>.index`."""
  path = prefix + ".index"
  with open(path, "rb") as f:
    data = f.read()
  entries, header = {}, None
  for handle in _data_block_handles(data, path):
    for key, value in _block_entries(_block(data, handle, path, "data"), path, "data"):
      if key == b"":
        header = dict(num_shards=1, endianness=0)
        for number, v in _fields(value):
          if number == 1:
            header["num_shards"] = v
          elif number == 2:
            header["endianness"] = v
        continue
      name = key.decode("utf-8")
      entry = _entry(value)
      if entry["slices"]:
        raise TFCheckpointError(f"{path}: {name!r} is partitioned ({entry['slices']} slices); "
                                "sliced variables are not read")
      entries[name] = entry
  if header is None:
    raise TFCheckpointError(f"{path}: no header entry (key \"\")")
  if header["endianness"] != 0:
    raise TFCheckpointError(f"{path}: a big-endian bundle")
  return header["num_shards"], entries


def _dtype_name(dtype: int) -> str:
  return _DTYPES[dtype][0] if dtype in _DTYPES else _NAMES.get(dtype, f"DataType {dtype}")


# ---------------------------------------------------------------------------
# The three entry points
# ---------------------------------------------------------------------------
def latest_checkpoint(checkpoint_dir: str) -> Optional[str]:
  """The prefix named by `model_checkpoint_path` in <checkpoint_dir>/checkpoint,
  joined to checkpoint_dir when relative; None when that file, the field or
  the prefix's index is missing (tf.train.latest_checkpoint)."""
  state = os.path.join(checkpoint_dir, "checkpoint")
  if not os.path.isfile(state):
    return None
  with open(state, encoding="utf-8") as f:
    text = f.read()
  match = re.search(r'^\s*model_checkpoint_path\s*:\s*"((?:[^"\\]|\\.)*)"', text, re.M)
  if match is None:
    return None
  path = codecs.escape_decode(match.group(1).encode("utf-8"))[0].decode("utf-8")
  if not os.path.isabs(path):
    path = os.path.join(checkpoint_dir, path)
  return path if os.path.isfile(path + ".index") else None


def list_variables(prefix: str) -> Dict[str, Tuple[str, Tuple[int, ...]]]:
  """{tensor name: (TF dtype name, shape)} of every tensor in the checkpoint."""
  _, entries = _read_index(prefix)
  return {name: (_dtype_name(e["dtype"]), e["shape"]) for name, e in entries.items()}


def read_variables(prefix: str, names: Optional[Iterable[str]] = None) -> Dict[str, np.ndarray]:
  """{tensor name: ndarray} of the checkpoint's numeric tensors, or of
  `names` only. Each tensor's bytes are held to its crc32c; bfloat16 comes
  back widened to float32 (exactly)."""
  num_shards, entries = _read_index(prefix)
  index = prefix + ".index"
  if names is None:
    names = [n for n, e in entries.items() if e["dtype"] != _STRING]
  else:
    names = list(names)
    unknown = [n for n in names if n not in entries]
    if unknown:
      raise KeyError(f"{index}: no tensors {unknown}")
  out = {}
  shards = {}
  try:
    for name in sorted(names, key=lambda n: (entries[n]["shard_id"], entries[n]["offset"])):
      e = entries[name]
      if e["dtype"] not in _DTYPES:
        raise TFCheckpointError(f"{index}: {name!r} has dtype {_dtype_name(e['dtype'])}, "
                                f"not one of {sorted(v[0] for v in _DTYPES.values())}")
      if not 0 <= e["shard_id"] < num_shards:
        raise TFCheckpointError(f"{index}: {name!r} in shard {e['shard_id']} of {num_shards}")
      shard = f"{prefix}.data-{e['shard_id']:05d}-of-{num_shards:05d}"
      dtype = np.dtype(_DTYPES[e["dtype"]][1])
      n_bytes = math.prod(e["shape"]) * dtype.itemsize
      if n_bytes != e["size"]:
        raise TFCheckpointError(f"{shard}: {name!r} of shape {e['shape']} and dtype "
                                f"{_dtype_name(e['dtype'])} needs {n_bytes} bytes, the entry "
                                f"says {e['size']}")
      if shard not in shards:
        shards[shard] = open(shard, "rb")
      f = shards[shard]
      buf = bytearray(n_bytes)
      if e["offset"] < 0 or f.seek(e["offset"]) != e["offset"] or f.readinto(buf) != n_bytes:
        raise TFCheckpointError(f"{shard}: {name!r} at [{e['offset']}, "
                                f"{e['offset'] + n_bytes}) lies past the file's end")
      if masked_crc32c(buf) != e["crc32c"]:
        raise TFCheckpointError(f"{shard}: {name!r}: crc32c mismatch")
      arr = np.frombuffer(buf, dtype).reshape(e["shape"])
      if e["dtype"] == _BFLOAT16:
        arr = (arr.astype(np.uint32) << np.uint32(16)).view(np.float32)
      out[name] = arr.astype(arr.dtype.newbyteorder("="), copy=False)
  finally:
    for f in shards.values():
      f.close()
  return out
