"""The port's metric writers (shallow_ntc_tpu_torch/utils/writers.py) and the
val image grids (ops/metrics_ops.visualize_image_batch, center_crop_image,
train_lib.Metrics) against the JAX package's, on the CPU."""

import json
import os
import sys
import types

import numpy as np
import pytest
import torch

from shallow_ntc_tpu.ops import metrics_ops as jax_metrics_ops
from shallow_ntc_tpu.utils import writers as jax_writers
from shallow_ntc_tpu_torch import itinf_lib, train_lib
from shallow_ntc_tpu_torch.ops import metrics_ops
from shallow_ntc_tpu_torch.utils import writers
from tests.torch_parity import SMALL_CONFIG


@pytest.mark.parametrize("batch", [1, 3, 4, 6, 8])
@pytest.mark.parametrize("crop", [None, 16])
def test_visualize_image_batch_equals_jax(batch, crop):
  images = np.random.default_rng(batch).uniform(0, 255, (batch, 20, 30, 3)).astype(np.float32)
  got = metrics_ops.visualize_image_batch(images, crop_to_max_dim=crop)
  want = jax_metrics_ops.visualize_image_batch(images, crop_to_max_dim=crop)
  assert got.shape == want.shape and np.array_equal(got, want)


@pytest.mark.parametrize("batch,ncol", [(6, 1), (6, 2), (6, 3), (4, 2), (3, 3)])
def test_visualize_image_batch_with_ncol_equals_jax(batch, ncol):
  images = np.random.default_rng(7).integers(0, 256, (batch, 9, 5, 3)).astype(np.uint8)
  got = metrics_ops.visualize_image_batch(images, ncol=ncol)
  assert np.array_equal(got, jax_metrics_ops.visualize_image_batch(images, ncol=ncol))


@pytest.mark.parametrize("hw", [(20, 30), (21, 31), (9, 9)])
def test_center_crop_image_equals_jax(hw):
  images = np.random.default_rng(1).uniform(size=(2, *hw, 3))
  for th, tw in ((9, 9), (5, 8), (hw[0], hw[1])):
    assert np.array_equal(metrics_ops.center_crop_image(images, th, tw),
                          jax_metrics_ops.center_crop_image(images, th, tw))
  assert np.array_equal(metrics_ops.center_crop_image(images[0], 4, 6),
                        jax_metrics_ops.center_crop_image(images[0], 4, 6))


def _records(vectors: bool):
  """The same scalars for both packages: JAX gets numpy, the port torch
  too; with `vectors`, an array record (JsonlWriter only: TensorBoard takes
  scalars in both packages)."""
  vec = np.random.default_rng(0).standard_normal(3).astype(np.float32)
  records = [
      (1, {"rd_loss": 1.5, "bpp": np.float32(0.25), "psnr": np.float64(30.125)},
       {"rd_loss": 1.5, "bpp": torch.tensor(0.25), "psnr": np.float64(30.125)}),
      (2, {"steps_per_sec": 3.0}, {"steps_per_sec": 3.0}),
      (4, {"n": np.int32(7), "steps_per_sec": 2.5},
       {"n": torch.tensor(7, dtype=torch.int32), "steps_per_sec": 2.5}),
  ]
  if vectors:
    records.append((5, {"vec": vec}, {"vec": torch.from_numpy(vec)}))
  return records


HPARAMS = {"lmbda": 0.01, "channels": (12, 3), "nested": {"a": [1, 2]}, "k": np.float32(0.5),
           "dtype": np.dtype("float32")}


def _write(writer, port: bool, vectors: bool = False):
  writer.write_hparams(HPARAMS)
  for step, jax_scalars, port_scalars in _records(vectors):
    writer.write_scalars(step, port_scalars if port else jax_scalars)
  writer.write_images(5, {"reconstruction": np.zeros((4, 6, 3), np.float32)})
  writer.flush()
  writer.close()


def _lines(path):
  with open(path) as f:
    return f.read().splitlines()


def test_jsonl_writer_equals_jax(tmp_path):
  _write(writers.JsonlWriter(str(tmp_path / "port")), port=True, vectors=True)
  _write(jax_writers.JsonlWriter(str(tmp_path / "jax")), port=False, vectors=True)
  lines = _lines(tmp_path / "port" / "record.jsonl")
  assert lines == _lines(tmp_path / "jax" / "record.jsonl") and len(lines) == 4


@pytest.mark.parametrize("tensorboard", [True, False])
def test_create_default_writer_record_equals_jax(tmp_path, monkeypatch, tensorboard):
  """<logdir>/<collection>/record.jsonl holds JAX's JsonlWriter's lines,
  with tensorboardX importable (an event file beside it) and with its
  import failing (skipped, as JAX's create_default_writer does)."""
  if not tensorboard:
    monkeypatch.setitem(sys.modules, "tensorboardX", None)  # import raises ImportError
  _write(writers.create_default_writer(str(tmp_path / "port"), collection="val"), port=True)
  _write(jax_writers.JsonlWriter(str(tmp_path / "jax")), port=False)
  port_lines = _lines(tmp_path / "port" / "val" / "record.jsonl")
  assert port_lines == _lines(tmp_path / "jax" / "record.jsonl")
  assert len(port_lines) == 3 and json.loads(port_lines[0])["hparams"]["lmbda"] == 0.01
  events = [f for f in os.listdir(tmp_path / "port" / "val") if "tfevents" in f]
  assert bool(events) == tensorboard


def test_just_logging_writes_no_files(tmp_path):
  writer = writers.create_default_writer(str(tmp_path), just_logging=True, collection="train")
  writer.write_scalars(1, {"rd_loss": 1.0})
  writer.close()
  assert not os.listdir(tmp_path)


class _FakeSummaryWriter:
  """tensorboardX.SummaryWriter's calls, kept in `calls`."""

  calls = []

  def __init__(self, logdir):
    self.logdir = logdir

  def add_scalar(self, tag, value, global_step):
    self.calls.append(("scalar", self.logdir, tag, global_step, value))

  def add_image(self, tag, value, global_step, dataformats):
    self.calls.append(("image", self.logdir, tag, global_step, value, dataformats))

  def flush(self):
    pass

  def close(self):
    pass


@pytest.fixture
def fake_tensorboardx(monkeypatch):
  _FakeSummaryWriter.calls = []
  monkeypatch.setitem(sys.modules, "tensorboardX",
                      types.SimpleNamespace(SummaryWriter=_FakeSummaryWriter))
  return _FakeSummaryWriter.calls


def test_two_train_steps_record_a_reconstruction_grid(tmp_path, fake_tensorboardx):
  """2 CPU steps of the narrow flagship on synthetic data: the val pass
  writes the grid of its first batch's reconstruction, of that batch's
  shape (3 images of 48x64 in one row), beside its scalars."""
  rng = np.random.default_rng(0)
  model, opt_cfg = train_lib.build_model(dict(SMALL_CONFIG, scheduled_num_steps=2),
                                         init_seed=0, device="cpu")
  train_batches = iter([rng.uniform(-0.5, 0.5, (2, 64, 64, 3)).astype(np.float32)
                        for _ in range(2)])
  val_batch = rng.uniform(-0.5, 0.5, (3, 48, 64, 3)).astype(np.float32)
  cfg = dict(num_steps=2, log_metrics_every_steps=1, eval_every_steps=2,
             checkpoint_every_steps=2, max_validation_steps=1)
  state = train_lib.simple_train_eval_loop(cfg, str(tmp_path), model, opt_cfg, train_batches,
                                           lambda: [val_batch])
  images = [c for c in fake_tensorboardx if c[0] == "image"]
  assert len(images) == 1
  _, logdir, tag, step, grid, fmt = images[0]
  assert (logdir, tag, step, fmt) == (str(tmp_path / "val"), "reconstruction", 2, "HWC")
  assert grid.shape == (48, 3 * 64, 3) and grid.dtype == np.uint8
  _, rec = train_lib.make_eval_step(model)(state, torch.from_numpy(val_batch))
  want = np.clip(metrics_ops.visualize_image_batch(rec.numpy(), crop_to_max_dim=256), 0, 255)
  assert np.array_equal(grid, want.astype(np.uint8))
  scalar_dirs = {c[1] for c in fake_tensorboardx if c[0] == "scalar"}
  assert scalar_dirs == {str(tmp_path / "train"), str(tmp_path / "val")}
  assert len(_lines(tmp_path / "val" / "record.jsonl")) == 1


def test_images_grid_crops_to_256():
  """Metrics.images_grid: each image center-cropped to 256x256, 4 as 2x2."""
  m = train_lib.Metrics()
  images = np.random.default_rng(2).uniform(0, 255, (4, 300, 400, 3))
  m.record_image("reconstruction", images)
  grid = m.images_grid()["reconstruction"]
  assert grid.shape == (512, 512, 3)
  assert np.array_equal(grid, jax_metrics_ops.visualize_image_batch(images, 256))


def test_itinf_writers_go_through_create_default_writer(tmp_path, fake_tensorboardx):
  """SGA's train and val writers: record.jsonl as before, and TensorBoard
  scalars under <workdir>/train and <workdir>/val."""
  model, _ = train_lib.build_model(SMALL_CONFIG, init_seed=0, device="cpu")
  batch = np.random.default_rng(1).uniform(-0.5, 0.5, (1, 64, 64, 3)).astype(np.float32)
  itinf_lib.itinf_on_data_batch(model.eval(), batch,
                                dict(num_steps=4, log_metrics_every_steps=2, eval_every_steps=4),
                                dict(learning_rate=1e-3), workdir=str(tmp_path))
  assert [json.loads(s)["step"] for s in _lines(tmp_path / "train" / "record.jsonl")] == [2, 4]
  assert [json.loads(s)["step"] for s in _lines(tmp_path / "val" / "record.jsonl")] == [4]
  assert {c[1] for c in fake_tensorboardx} == {str(tmp_path / "train"), str(tmp_path / "val")}
