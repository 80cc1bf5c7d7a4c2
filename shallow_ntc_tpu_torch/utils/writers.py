"""Metric writers (mirrors shallow_ntc_tpu/utils/writers.py).

The JAX package's observability surface: a logging writer, TensorBoard
when tensorboardX imports, and line-buffered JSONL (`record.jsonl`, one
{"step": ..., metric: ...} object per line). Python `logging` takes the
place of CLU's LoggingWriter; writes are synchronous (CLU's AsyncWriter is
not ported).
"""

import json
import logging
import os
from typing import Any, Mapping, Optional

import numpy as np
import torch

from shallow_ntc_tpu_torch.utils.runname import MyJSONEncoder

_log = logging.getLogger(__name__)


def _numpy(v) -> np.ndarray:
  return v.detach().cpu().numpy() if isinstance(v, torch.Tensor) else np.asarray(v)


class LoggingWriter:
  """Scalars to Python logging at INFO ("[step] collection: key=value, ...")."""

  def __init__(self, collection: Optional[str] = None):
    self._prefix = f"{collection}: " if collection else ""

  def write_scalars(self, step: int, scalars: Mapping[str, Any]):
    if _log.isEnabledFor(logging.INFO):
      _log.info("[%d] %s%s", step, self._prefix,
                ", ".join(f"{k}={_numpy(v)}" for k, v in scalars.items()))

  def write_images(self, step: int, images: Mapping[str, Any]):
    pass

  def write_hparams(self, hparams: Mapping[str, Any]):
    _log.info("%sHyperparameters: %s", self._prefix, hparams)

  def flush(self):
    pass

  def close(self):
    pass


class JsonlWriter:
  """record.jsonl: one {"step": ..., metric: ...} object per line, and an
  {"hparams": ...} line (writers.py:21-65)."""

  def __init__(self, logdir: str, filename: str = "record.jsonl"):
    os.makedirs(logdir, exist_ok=True)
    self.path = os.path.join(logdir, filename)
    self._file = open(self.path, "a", buffering=1)

  def write_scalars(self, step: int, scalars: Mapping[str, Any]):
    # CLU's steps_per_sec-only records are dropped, as in JAX.
    if not scalars or set(scalars) == {"steps_per_sec"}:
      return
    record = {"step": int(step)}
    for k, v in scalars.items():
      a = _numpy(v)
      record[k] = float(a) if a.ndim == 0 else a.tolist()
    self._file.write(json.dumps(record, cls=MyJSONEncoder) + "\n")

  def write_images(self, step: int, images: Mapping[str, Any]):
    pass  # images go to TensorBoard only

  def write_hparams(self, hparams: Mapping[str, Any]):
    self._file.write(json.dumps({"hparams": hparams}, cls=MyJSONEncoder, default=str) + "\n")

  def flush(self):
    self._file.flush()

  def close(self):
    self._file.close()


class TensorboardXWriter:
  """TensorBoard event files through tensorboardX (no TensorFlow): scalars
  and HWC uint8 images (writers.py:68-113)."""

  def __init__(self, logdir: str):
    import tensorboardX

    self._tb = tensorboardX.SummaryWriter(logdir)

  def write_scalars(self, step: int, scalars: Mapping[str, Any]):
    for k, v in scalars.items():
      self._tb.add_scalar(k, float(_numpy(v)), global_step=int(step))

  def write_images(self, step: int, images: Mapping[str, Any]):
    for k, v in images.items():
      arr = _numpy(v)
      if arr.ndim == 4:
        arr = arr[0]
      if arr.dtype != np.uint8:
        arr = np.clip(arr, 0, 255).astype(np.uint8)
      self._tb.add_image(k, arr, global_step=int(step), dataformats="HWC")

  def write_hparams(self, hparams: Mapping[str, Any]):
    pass

  def flush(self):
    self._tb.flush()

  def close(self):
    self._tb.close()


class MultiWriter:
  """Every call goes to each writer in turn."""

  def __init__(self, writers):
    self.writers = list(writers)

  def write_scalars(self, step: int, scalars: Mapping[str, Any]):
    for w in self.writers:
      w.write_scalars(step, scalars)

  def write_images(self, step: int, images: Mapping[str, Any]):
    for w in self.writers:
      w.write_images(step, images)

  def write_hparams(self, hparams: Mapping[str, Any]):
    for w in self.writers:
      w.write_hparams(hparams)

  def flush(self):
    for w in self.writers:
      w.flush()

  def close(self):
    for w in self.writers:
      w.close()


def create_default_writer(logdir: Optional[str] = None, just_logging: bool = False,
                          collection: Optional[str] = None) -> MultiWriter:
  """Logging, TensorBoard (skipped when tensorboardX does not import) and
  JSONL under <logdir>/<collection>/ (writers.py:116-135)."""
  writers = [LoggingWriter(collection)]
  if logdir is not None and not just_logging:
    if collection:
      logdir = os.path.join(logdir, collection)
    try:
      writers.append(TensorboardXWriter(logdir))
    except ImportError:
      pass
    writers.append(JsonlWriter(logdir))
  return MultiWriter(writers)
