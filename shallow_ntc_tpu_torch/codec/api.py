"""Model-level compress/decompress of both model families (mirrors
shallow_ntc_tpu/codec/api.py: MSHyperCodec, FactorizedCodec and their
container).

MSHyperCodec, the mean-scale hyperprior:
  Encode:
    device: x -> analysis -> y; y -> hyper-analysis -> z
    host:   rANS-encode round(z - o) under the factorized tables; z_hat = k + o
    device: z_hat -> hyper-synthesis -> (mu, sigma index)
    host:   rANS-encode round(y - mu) under the scale-indexed Gaussian tables
  Decode:
    host:   rANS-decode the z symbols -> z_hat
    device: z_hat -> hyper-synthesis -> (mu, sigma index)
    host:   rANS-decode the y symbols -> y_hat = k + mu
    device: y_hat -> synthesis -> image
FactorizedCodec, the factorized prior: one tensor, y, coded as z is above
under the per-channel tables of the model's prior (family byte 0); no
device leg sits between the host halves.

The container is byte-compatible with the JAX package's: a blob written by
one package parses in the other.
"""

import contextlib
import struct
from dataclasses import dataclass
from typing import Callable, List, Optional, Tuple

import numpy as np
import torch

from shallow_ntc_tpu_torch.codec import bindings, tables as tables_lib
from shallow_ntc_tpu_torch.models import base as models_base
from shallow_ntc_tpu_torch.models import factorized
from shallow_ntc_tpu_torch.models import mshyper
from shallow_ntc_tpu_torch.ops import entropy

MAGIC = b"SNTC"
VERSION = 2  # v2: each tensor is N interleaved rANS stripes (parallel decode)
FACTORIZED_FAMILY = 0  # the family byte of the header
MSHYPER_FAMILY = 1

# Fixed (rate-independent) bytes of a bitstream: the container framing plus
# the rANS final-state flush per stream. Everything else is payload.
HEADER_BYTES = 10  # MAGIC + <BBHH>(version, family, h, w)
STREAMS_COUNT_BYTES = 1  # <B> stream count per tensor
CHUNK_LEN_BYTES = 4  # <I> length prefix per stream
RANS_FLUSH_BYTES = 4  # 32-bit final state per stream (rans.cc flush())


def fixed_overhead_bytes(stream_counts) -> int:
  """Exact rate-independent byte count of a bitstream whose tensors carry
  `stream_counts` (one entry per tensor) rANS stripes."""
  return HEADER_BYTES + sum(
      STREAMS_COUNT_BYTES + int(s) * (CHUNK_LEN_BYTES + RANS_FLUSH_BYTES)
      for s in stream_counts)


def stream_counts(blob: bytes) -> List[int]:
  """Per-tensor stripe counts parsed back out of a bitstream."""
  _, _, _, _, rest = _unpack_header(blob)
  counts = []
  off = 0
  while off < len(rest):
    (s,) = struct.unpack_from("<B", rest, off)
    off += 1
    counts.append(s)
    for _ in range(s):
      (ln,) = struct.unpack_from("<I", rest, off)
      off += 4 + ln
  return counts


def _pack_header(version, family_id, h, w) -> bytes:
  return MAGIC + struct.pack("<BBHH", version, family_id, h, w)


def _unpack_header(blob: bytes):
  if blob[:4] != MAGIC or len(blob) < HEADER_BYTES:
    raise ValueError("not a shallow_ntc_tpu bitstream")
  version, family_id, h, w = struct.unpack("<BBHH", blob[4:HEADER_BYTES])
  return version, family_id, h, w, blob[HEADER_BYTES:]


def _pack_tensor(chunks) -> bytes:
  """One tensor: <B>(num stripes) then each stripe length-prefixed."""
  out = struct.pack("<B", len(chunks))
  for c in chunks:
    out += struct.pack("<I", len(c)) + c
  return out


def _unpack_tensors(data: bytes, num_tensors: int):
  """Inverse of `num_tensors` consecutive _pack_tensor blocks: a list of
  per-tensor stripe lists."""
  tensors = []
  off = 0
  for _ in range(num_tensors):
    (s,) = struct.unpack_from("<B", data, off)
    off += 1
    chunks = []
    for _ in range(s):
      (ln,) = struct.unpack_from("<I", data, off)
      if off + 4 + ln > len(data):
        raise ValueError("truncated bitstream")
      chunks.append(data[off + 4 : off + 4 + ln])
      off += 4 + ln
    tensors.append(chunks)
  return tensors


@dataclass
class CompressionResult:
  bitstring: bytes
  # uint8 [H, W, 3] encoder-side decode; None in compress_batch(...,
  # reconstruct=False), which skips the synthesis.
  reconstruction: Optional[np.ndarray]
  bpp: float


@contextlib.contextmanager
def coding_numerics():
  """The numerics of every device computation whose bits the decoder must
  reproduce (the tables, the hyper-synthesis and the synthesis): TF32 off
  for cuDNN and matmuls, cuDNN deterministic with its heuristic algorithm
  choice (no benchmarking). Restores the caller's settings on exit."""
  tf32 = torch.backends.cuda.matmul.allow_tf32
  torch.backends.cuda.matmul.allow_tf32 = False
  try:
    with torch.backends.cudnn.flags(enabled=True, benchmark=False, deterministic=True,
                                    allow_tf32=False):
      yield
  finally:
    torch.backends.cuda.matmul.allow_tf32 = tf32


# Batch paths dispatch at most this many device chunks ahead of the host
# consumer: enough to overlap host rANS with the device transforms, while
# device memory stays O(lookahead * chunk_size), not O(len(images)).
_LOOKAHEAD_CHUNKS = 2


def _equal_shape_chunks(shapes, chunk_size):
  """Split indexes 0..n-1 into runs of equal shape, each <= chunk_size.

  A batch stage stacks a chunk's tensors into one device call, so a chunk
  must be shape-uniform; mixed sizes give shorter chunks."""
  chunks = []
  i = 0
  while i < len(shapes):
    j = i + 1
    while j < len(shapes) and j - i < chunk_size and shapes[j] == shapes[i]:
      j += 1
    chunks.append(list(range(i, j)))
    i = j
  return chunks


def _drain_recs(pending, keep, hw, out):
  """Fetch queued (idxs, uint8-synthesis future) pairs until <= `keep`
  remain; out[i] gets the [h, w, 3] crop of row i, hw[i] = (h, w)."""
  while len(pending) > keep:
    idxs, fut = pending.pop(0)
    (rec,) = fut()
    for row, i in enumerate(idxs):
      h, w = hw[i]
      out[i] = rec[row, :h, :w]


class _ModelCodec:
  """What both families' codecs share: the model (float32), uploads and
  fetches, and the synthesis to uint8."""

  def __init__(self, model):
    if any(p.dtype != torch.float32 for p in model.parameters()):
      raise ValueError("the codec runs the model in float32")
    self.model = model
    self.device = next(model.parameters()).device

  def _upload(self, a: np.ndarray) -> torch.Tensor:
    t = torch.from_numpy(np.ascontiguousarray(a, np.float32))
    if self.device.type == "cuda":
      return t.pin_memory().to(self.device, non_blocking=True)
    return t.to(self.device)

  def _fetch(self, *tensors: torch.Tensor) -> Callable[[], Tuple[np.ndarray, ...]]:
    """Start copying `tensors` to the host; return the call that waits for
    them and gives them as numpy arrays. On the card the copies go into
    pinned buffers behind an event, so the host goes on meanwhile."""
    if self.device.type != "cuda":
      arrays = tuple(t.cpu().numpy() for t in tensors)
      return lambda: arrays
    outs = [torch.empty(t.shape, dtype=t.dtype, pin_memory=True) for t in tensors]
    for o, t in zip(outs, tensors):
      o.copy_(t, non_blocking=True)
    done = torch.cuda.Event()
    done.record()

    def wait():
      done.synchronize()
      return tuple(o.numpy() for o in outs)

    return wait

  @torch.no_grad()
  def _synth_u8(self, y_hat: np.ndarray) -> torch.Tensor:
    """y_hat [B, ...] -> uint8 [B, H_pad, W_pad, 3] on the device (1 byte a
    pixel to fetch)."""
    with coding_numerics():
      rec = self.model.synthesize(self._upload(y_hat))
      return models_base.floats_to_pixels(rec, training=False).to(torch.uint8)

  def _reconstruct(self, y_hat: np.ndarray, h: int, w: int) -> np.ndarray:
    (rec,) = self._fetch(self._synth_u8(y_hat))()
    return rec[0, :h, :w]

  @staticmethod
  def _as_batch(image) -> np.ndarray:
    x = np.asarray(image, np.float32)
    x = x[None] if x.ndim == 3 else x
    if x.ndim != 4 or x.shape[0] != 1 or x.shape[-1] != 3:
      raise ValueError(f"expected one [H, W, 3] or [1, H, W, 3] image, got {x.shape}")
    return x


class MSHyperCodec(_ModelCodec):
  """Compress/decompress with a mean-scale hyperprior model (float32).

  DETERMINISM CONTRACT: (mu, indexes) select the rANS coding tables, so the
  encoder and the decoder must compute them bit-identically: one flipped
  scale index derails the stream from that symbol on. So every path runs
  the hyper-synthesis at batch 1, in float32, under coding_numerics(), on the
  host-canonical z_hat (the latent the decoder rebuilds from the symbols),
  never on the device's own rounding of z. Only the synthesis may batch:
  pixels carry no coding state. The analysis is the encoder's alone and runs
  under the caller's settings.
  """

  def __init__(self, model: mshyper.Model):
    super().__init__(model)
    with coding_numerics():
      self.z_tables = tables_lib.build_factorized_tables(
          model._prior, offset_heuristic=model.offset_heuristic)
    self.y_tables = tables_lib.build_gaussian_tables()

  # --- device programs -------------------------------------------------------
  @torch.no_grad()
  def _analyze(self, x: np.ndarray):
    """[B, H, W, 3] normalized floats -> (z, y) on the device."""
    latents = self.model.infer_latent_rvs(self._upload(x))
    return latents.uq[0].loc, latents.uq[1].loc

  @torch.no_grad()
  def _hyper_dec(self, z_hat: np.ndarray):
    """The canonical coding-table program (see the class docstring):
    host-canonical z_hat [1, ...] -> (mu, clipped scale indexes) on the device."""
    if z_hat.shape[0] != 1:
      raise ValueError("the hyper-synthesis of the codec runs at batch 1")
    with coding_numerics():
      mu, indexes = self.model.hyper_synthesize(self._upload(z_hat))
      return mu, entropy.normalize_indexes(indexes)

  # --- host halves -----------------------------------------------------------
  def _encode_z_host(self, z: np.ndarray):
    """Host z encode of ONE image: (z_chunks, z_hat), z_hat the coding-grid
    latent that _decode_z_host reproduces (the only valid hyper input)."""
    z_syms = self.z_tables.symbols_from_latent(z)
    z_idx = self.z_tables.channel_indexes(z.shape)
    z_chunks = bindings.rans_encode_striped(z_syms, z_idx, self.z_tables.tables)
    return z_chunks, self.z_tables.latent_from_symbols(z_syms)

  def _encode_y_host(self, z_chunks, y, mu, indexes, h, w):
    """Host y encode of ONE image; returns (blob, y_hat)."""
    y_idx = self.y_tables.snap_indexes(indexes)
    y_syms = self.y_tables.symbols_from_latent(y, mu, y_idx)
    y_chunks = bindings.rans_encode_striped(y_syms, y_idx, self.y_tables.tables)
    # z's extent follows from the padded image size; only H, W travel.
    blob = (_pack_header(VERSION, MSHYPER_FAMILY, h, w)
            + _pack_tensor(z_chunks) + _pack_tensor(y_chunks))
    return blob, self.y_tables.latent_from_symbols(y_syms, mu, y_idx)

  def _latent_shapes(self, h, w):
    d = self.model.downsample_factor
    ph, pw = -(-h // d) * d, -(-w // d) * d
    fa = self.model._analysis.downsample_factor
    fh = self.model._hyper_analysis.downsample_factor
    yh, yw = ph // fa, pw // fa
    return (1, yh // fh, yw // fh, self.z_tables.channels), (1, yh, yw, None)

  def _decode_z_host(self, blob: bytes):
    """Header + z rANS decode -> (h, w, z_hat, y_chunks)."""
    version, family_id, h, w, rest = _unpack_header(blob)
    if version != VERSION or family_id != MSHYPER_FAMILY:
      raise ValueError(f"bitstream version {version}, family {family_id}: this codec reads "
                       f"version {VERSION}, family {MSHYPER_FAMILY} (mshyper)")
    z_chunks, y_chunks = _unpack_tensors(rest, 2)
    z_shape, _ = self._latent_shapes(h, w)
    z_idx = self.z_tables.channel_indexes(z_shape)
    z_syms = bindings.rans_decode_striped(z_chunks, z_idx, self.z_tables.tables)
    return h, w, self.z_tables.latent_from_symbols(z_syms), y_chunks

  def _decode_y_host(self, y_chunks, mu, indexes):
    """y rANS decode under (mu, sigma index) -> y_hat."""
    y_idx = self.y_tables.snap_indexes(indexes)
    y_syms = bindings.rans_decode_striped(y_chunks, y_idx, self.y_tables.tables)
    return self.y_tables.latent_from_symbols(y_syms, mu, y_idx)

  # --- per image -------------------------------------------------------------
  def compress(self, image: np.ndarray) -> CompressionResult:
    """image: [H, W, 3] or [1, H, W, 3], normalized floats (x/255 - 0.5)."""
    x = self._as_batch(image)
    h, w = x.shape[1], x.shape[2]
    z, y = self._fetch(*self._analyze(x))()
    z_chunks, z_hat = self._encode_z_host(z)
    mu, indexes = self._fetch(*self._hyper_dec(z_hat))()
    blob, y_hat = self._encode_y_host(z_chunks, y, mu, indexes, h, w)
    return CompressionResult(blob, self._reconstruct(y_hat, h, w), len(blob) * 8.0 / (h * w))

  def decompress(self, blob: bytes) -> np.ndarray:
    """Returns the uint8 [H, W, 3] reconstruction."""
    h, w, y_hat = self.decode_latent(blob)
    return self._reconstruct(y_hat, h, w)

  def decode_latent(self, blob: bytes):
    """(h, w, y_hat): the decoded latent, before the synthesis."""
    h, w, z_hat, y_chunks = self._decode_z_host(blob)
    mu, indexes = self._fetch(*self._hyper_dec(z_hat))()
    return h, w, self._decode_y_host(y_chunks, mu, indexes)

  # --- batches ---------------------------------------------------------------
  def compress_batch(self, images, reconstruct: bool = False,
                     chunk_size: int = 8) -> List[CompressionResult]:
    """Pipelined multi-image compress.

    The analyses of a chunk of images are dispatched at most
    _LOOKAHEAD_CHUNKS chunks ahead, so the device transforms chunk g+1 while
    the host rANS-encodes chunk g; the coding-table inputs come from the
    canonical batch-1 hyper-synthesis per image, also dispatched ahead of the
    host. Each analysis runs at batch 1, as compress() runs it: a stacked
    analysis lets cuDNN pick another algorithm, which rounds z and y
    otherwise and can flip a symbol. So the bitstreams and latents equal the
    per-image path's. reconstruct=True stacks the synthesis of equal-shaped
    runs (a pixel may round the other way, +-1); reconstruct=False skips it.
    """
    xs = [self._as_batch(im) for im in images]
    chunks = _equal_shape_chunks([x.shape for x in xs], chunk_size)
    analysis_futs = {}

    def dispatch_analysis(g):
      for i in chunks[g]:
        analysis_futs[i] = self._fetch(*self._analyze(xs[i]))

    for g in range(min(_LOOKAHEAD_CHUNKS, len(chunks))):
      dispatch_analysis(g)

    results: List[Optional[CompressionResult]] = [None] * len(xs)
    y_hats = {}
    pending = []  # (i, z_chunks, hyper future, y row), <= ~1 chunk deep

    def finish(item):
      i, z_chunks, hyper_fut, y_row = item
      mu, indexes = hyper_fut()
      h, w = xs[i].shape[1], xs[i].shape[2]
      blob, y_hats[i] = self._encode_y_host(z_chunks, y_row, mu, indexes, h, w)
      results[i] = CompressionResult(blob, None, len(blob) * 8.0 / (h * w))

    for g, idxs in enumerate(chunks):
      if g + _LOOKAHEAD_CHUNKS < len(chunks):
        dispatch_analysis(g + _LOOKAHEAD_CHUNKS)
      for i in idxs:
        z, y = analysis_futs.pop(i)()
        z_chunks, z_hat = self._encode_z_host(z)
        pending.append((i, z_chunks, self._fetch(*self._hyper_dec(z_hat)), y))
      while len(pending) > chunk_size:
        finish(pending.pop(0))
    for item in pending:
      finish(item)

    if reconstruct:
      hw = [x.shape[1:3] for x in xs]
      recs = [None] * len(xs)
      rec_pending = []
      for idxs in chunks:
        yb = np.concatenate([y_hats[i] for i in idxs], 0)
        rec_pending.append((idxs, self._fetch(self._synth_u8(yb))))
        _drain_recs(rec_pending, _LOOKAHEAD_CHUNKS - 1, hw, recs)
      _drain_recs(rec_pending, 0, hw, recs)
      for r, rec in zip(results, recs):
        r.reconstruction = rec
    return results

  def decompress_batch(self, blobs, chunk_size: int = 8,
                       strict: bool = False) -> List[np.ndarray]:
    """Pipelined multi-image decompress; returns [uint8 [H, W, 3]].

    The canonical batch-1 hyper-synthesis calls are dispatched with a
    bounded lookahead, so the host rANS-decodes other images meanwhile;
    equal-shaped runs of decoded latents stack into one synthesis call per
    chunk, fetched as uint8. y_hat equals the per-image decompress's; a
    batched synthesis may round a reconstruction pixel the other way (+-1).
    strict=True runs the synthesis per image, as decompress() does, so the
    reconstructions are bit-identical to it.
    """
    stage1 = [self._decode_z_host(b) for b in blobs]
    hw = [(s[0], s[1]) for s in stage1]
    chunks = _equal_shape_chunks(hw, chunk_size)
    hyper_futs = {}

    def dispatch_hypers(g):
      for i in chunks[g]:
        hyper_futs[i] = self._fetch(*self._hyper_dec(stage1[i][2]))

    for g in range(min(_LOOKAHEAD_CHUNKS, len(chunks))):
      dispatch_hypers(g)

    out: List[Optional[np.ndarray]] = [None] * len(blobs)
    rec_pending = []  # (idxs, future), drained with a one-chunk lag
    for g, idxs in enumerate(chunks):
      if g + _LOOKAHEAD_CHUNKS < len(chunks):
        dispatch_hypers(g + _LOOKAHEAD_CHUNKS)
      y_hats = []
      for i in idxs:
        mu, indexes = hyper_futs.pop(i)()
        y_hats.append(self._decode_y_host(stage1[i][3], mu, indexes))
      if strict:
        for i, y_hat in zip(idxs, y_hats):
          out[i] = self._reconstruct(y_hat, *hw[i])
      else:
        rec_pending.append((idxs, self._fetch(self._synth_u8(np.concatenate(y_hats, 0)))))
        _drain_recs(rec_pending, 1, hw, out)
    _drain_recs(rec_pending, 0, hw, out)
    return out


class FactorizedCodec(_ModelCodec):
  """Compress/decompress with a factorized-prior model (float32).

  The coding tables are per-channel constants of the prior, built once under
  coding_numerics(), so no device computation selects a table per image: the
  decoder needs the blob and the tables only. The analysis runs at batch 1
  on every path, as in MSHyperCodec, so the batch paths' bitstreams equal
  the per-image path's; only the synthesis batches.
  """

  def __init__(self, model: factorized.Model):
    super().__init__(model)
    with coding_numerics():
      self.tables = tables_lib.build_factorized_tables(
          model._prior, offset_heuristic=model.offset_heuristic)

  @torch.no_grad()
  def _analyze(self, x: np.ndarray) -> torch.Tensor:
    """[B, H, W, 3] normalized floats -> y on the device."""
    return self.model.infer_latent_rvs(self._upload(x)).uq[0].loc

  def _encode_host(self, y: np.ndarray, h: int, w: int):
    """Host encode of ONE image's y: (blob, y_hat on the coding grid)."""
    syms = self.tables.symbols_from_latent(y)
    chunks = bindings.rans_encode_striped(syms, self.tables.channel_indexes(y.shape),
                                          self.tables.tables)
    blob = _pack_header(VERSION, FACTORIZED_FAMILY, h, w) + _pack_tensor(chunks)
    return blob, self.tables.latent_from_symbols(syms)

  def decode_latent(self, blob: bytes):
    """Header + y rANS decode -> (h, w, y_hat)."""
    version, family_id, h, w, rest = _unpack_header(blob)
    if version != VERSION or family_id != FACTORIZED_FAMILY:
      raise ValueError(f"bitstream version {version}, family {family_id}: this codec reads "
                       f"version {VERSION}, family {FACTORIZED_FAMILY} (factorized)")
    (chunks,) = _unpack_tensors(rest, 1)
    d = self.model.downsample_factor
    shape = (1, -(-h // d), -(-w // d), self.tables.channels)
    syms = bindings.rans_decode_striped(chunks, self.tables.channel_indexes(shape),
                                        self.tables.tables)
    return h, w, self.tables.latent_from_symbols(syms)

  def compress(self, image: np.ndarray) -> CompressionResult:
    """image: [H, W, 3] or [1, H, W, 3], normalized floats (x/255 - 0.5)."""
    x = self._as_batch(image)
    h, w = x.shape[1], x.shape[2]
    (y,) = self._fetch(self._analyze(x))()
    blob, y_hat = self._encode_host(y, h, w)
    return CompressionResult(blob, self._reconstruct(y_hat, h, w), len(blob) * 8.0 / (h * w))

  def decompress(self, blob: bytes) -> np.ndarray:
    """Returns the uint8 [H, W, 3] reconstruction."""
    h, w, y_hat = self.decode_latent(blob)
    return self._reconstruct(y_hat, h, w)

  def compress_batch(self, images, reconstruct: bool = False,
                     chunk_size: int = 8) -> List[CompressionResult]:
    """Pipelined multi-image compress: the analyses are dispatched at most
    _LOOKAHEAD_CHUNKS chunks ahead of the host's rANS, each at batch 1;
    reconstruct=True stacks the synthesis of equal-shaped runs (a pixel may
    round the other way, +-1)."""
    xs = [self._as_batch(im) for im in images]
    chunks = _equal_shape_chunks([x.shape for x in xs], chunk_size)
    analysis_futs = {}

    def dispatch_analysis(g):
      for i in chunks[g]:
        analysis_futs[i] = self._fetch(self._analyze(xs[i]))

    for g in range(min(_LOOKAHEAD_CHUNKS, len(chunks))):
      dispatch_analysis(g)
    results: List[Optional[CompressionResult]] = [None] * len(xs)
    hw = [x.shape[1:3] for x in xs]
    recs = [None] * len(xs)
    rec_pending = []
    for g, idxs in enumerate(chunks):
      if g + _LOOKAHEAD_CHUNKS < len(chunks):
        dispatch_analysis(g + _LOOKAHEAD_CHUNKS)
      y_hats = []
      for i in idxs:
        (y,) = analysis_futs.pop(i)()
        blob, y_hat = self._encode_host(y, *hw[i])
        results[i] = CompressionResult(blob, None, len(blob) * 8.0 / (hw[i][0] * hw[i][1]))
        y_hats.append(y_hat)
      if reconstruct:
        rec_pending.append((idxs, self._fetch(self._synth_u8(np.concatenate(y_hats, 0)))))
        _drain_recs(rec_pending, _LOOKAHEAD_CHUNKS - 1, hw, recs)
    _drain_recs(rec_pending, 0, hw, recs)
    if reconstruct:
      for r, rec in zip(results, recs):
        r.reconstruction = rec
    return results

  def decompress_batch(self, blobs, chunk_size: int = 8,
                       strict: bool = False) -> List[np.ndarray]:
    """Multi-image decompress; returns [uint8 [H, W, 3]]. Equal-shaped runs of
    decoded latents stack into one synthesis call (a pixel may round the
    other way, +-1); strict=True synthesizes per image, bit-identical to
    decompress()."""
    stage1 = [self.decode_latent(b) for b in blobs]
    hw = [(s[0], s[1]) for s in stage1]
    out: List[Optional[np.ndarray]] = [None] * len(blobs)
    rec_pending = []
    for idxs in _equal_shape_chunks(hw, chunk_size):
      if strict:
        for i in idxs:
          out[i] = self._reconstruct(stage1[i][2], *hw[i])
      else:
        yb = np.concatenate([stage1[i][2] for i in idxs], 0)
        rec_pending.append((idxs, self._fetch(self._synth_u8(yb))))
        _drain_recs(rec_pending, _LOOKAHEAD_CHUNKS - 1, hw, out)
    _drain_recs(rec_pending, 0, hw, out)
    return out


def make_codec(model):
  """The codec of a model, by its family; TypeError for anything else, as
  the JAX package's make_codec."""
  if isinstance(model, mshyper.Model):
    return MSHyperCodec(model)
  if isinstance(model, factorized.Model):
    return FactorizedCodec(model)
  raise TypeError(type(model))
