"""The port's import of the reference's TF checkpoints against TensorFlow and
the JAX package's converter, on the CPU.

shallow_ntc_tpu_torch/utils/tf_checkpoint.py reads TF's TensorBundle format
without TensorFlow; it is held here to tf.train.load_checkpoint bit for bit
(names, dtypes, shapes, values) on checkpoints that TF 2 writes: every
numeric dtype it reads, a scalar, a zero-size tensor, a string it lists,
an index table of more than one data block, and the full-width flagship
written by tests/tf_mirror.TFModelMirror. Corrupted files raise. The
converter (shallow_ntc_tpu_torch/convert_tf_checkpoint.py) gives JAX's
translation table for every config script of both packages (or raises the
same exception type), JAX's converted parameters bit for bit on the
committed fixture tests/data/tf_ckpt/ (tests/make_tf_checkpoint_fixture.py),
the TF model's outputs at JAX's tolerances, and JAX's eval metrics.
"""

import hashlib
import json
import os
import struct
import time

import numpy as np
import pytest
import torch

tf = pytest.importorskip("tensorflow")

from scripts import convert_tf_checkpoint as jax_convert  # noqa: E402
from shallow_ntc_tpu import data as jax_data  # noqa: E402
from shallow_ntc_tpu import eval_lib as jax_eval_lib  # noqa: E402
from shallow_ntc_tpu.utils import tf_convert as jax_tf_convert  # noqa: E402
from shallow_ntc_tpu_torch import configs  # noqa: E402
from shallow_ntc_tpu_torch import convert_tf_checkpoint as convert_lib  # noqa: E402
from shallow_ntc_tpu_torch import data as data_lib  # noqa: E402
from shallow_ntc_tpu_torch import eval as eval_cli  # noqa: E402
from shallow_ntc_tpu_torch import params as params_lib  # noqa: E402
from shallow_ntc_tpu_torch import train_lib  # noqa: E402
from shallow_ntc_tpu_torch.models import families  # noqa: E402
from shallow_ntc_tpu_torch.utils import config as config_lib  # noqa: E402
from shallow_ntc_tpu_torch.utils import tf_checkpoint  # noqa: E402
from shallow_ntc_tpu_torch.utils import tf_convert  # noqa: E402
from tests import tf_mirror  # noqa: E402
from tests.make_tf_checkpoint_fixture import CONFIG as FIXTURE_CONFIG  # noqa: E402
from tests.test_torch_config import SCRIPTS, _paths, jax_resolve  # noqa: E402
from tests.torch_parity import nest, to_numpy, to_torch  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURE = os.path.join(REPO, "tests", "data", "tf_ckpt")
FIXTURE_PREFIX = os.path.join(FIXTURE, "train", "checkpoints", "ckpt-1")


def assert_reads_like_tf(prefix):
  """list_variables and read_variables against tf.train.load_checkpoint."""
  reader = tf.train.load_checkpoint(prefix)
  shapes, dtypes = reader.get_variable_to_shape_map(), reader.get_variable_to_dtype_map()
  listed = tf_checkpoint.list_variables(prefix)
  assert listed == {k: (dtypes[k].name, tuple(shapes[k])) for k in shapes}
  values = tf_checkpoint.read_variables(prefix)
  assert set(values) == {k for k in shapes if dtypes[k] != tf.string}
  for name, value in values.items():
    ref = reader.get_tensor(name)
    if dtypes[name] == tf.bfloat16:  # widened exactly
      ref = ref.astype(np.float32)
    assert value.dtype == ref.dtype and value.shape == ref.shape, name
    assert value.tobytes() == np.ascontiguousarray(ref).tobytes(), name
  return values


# ---------------------------------------------------------------------------
# crc32c
# ---------------------------------------------------------------------------
def _crc32c_loop(data: bytes) -> int:
  crc = 0xFFFFFFFF
  for byte in data:
    crc ^= byte
    for _ in range(8):
      crc = (crc >> 1) ^ (0x82F63B78 if crc & 1 else 0)
  return crc ^ 0xFFFFFFFF


@pytest.mark.parametrize("n", [0, 1, 2, 7, 255, 256, 4097, 20011])
def test_crc32c_equals_the_bytewise_loop(n):
  data = np.random.default_rng(n).integers(0, 256, n, dtype=np.uint8).tobytes()
  assert tf_checkpoint.crc32c(data) == _crc32c_loop(data)
  assert tf_checkpoint.crc32c(b"123456789") == 0xE3069283  # the CRC-32C check value


# ---------------------------------------------------------------------------
# The reader against TensorFlow
# ---------------------------------------------------------------------------
DTYPE_CASES = {
    "f32": lambda r: r.standard_normal((3, 5)).astype(np.float32),
    "f64": lambda r: r.standard_normal((4, 2)),
    "i32": lambda r: r.integers(-2**31, 2**31 - 1, (7,), dtype=np.int32),
    "i64": lambda r: r.integers(-2**62, 2**62, (2, 3), dtype=np.int64),
    "f16": lambda r: r.standard_normal((5, 1, 2)).astype(np.float16),
    "bf16": lambda r: tf.constant(r.standard_normal((6, 3)), dtype=tf.bfloat16),
    "scalar": lambda r: np.float32(r.standard_normal()),
    "empty": lambda r: np.zeros((0, 4), np.float32),
    "text": lambda r: "a string tensor",
}


@pytest.fixture(scope="module")
def dtype_checkpoint(tmp_path_factory):
  rng = np.random.default_rng(0)
  module = tf.Module()
  for name, make in DTYPE_CASES.items():
    setattr(module, name, tf.Variable(make(rng)))
  return tf.train.Checkpoint(model=module).save(str(tmp_path_factory.mktemp("dtypes") / "ckpt"))


def test_reader_equals_tf_on_every_dtype(dtype_checkpoint):
  values = assert_reads_like_tf(dtype_checkpoint)
  listed = tf_checkpoint.list_variables(dtype_checkpoint)
  key = "model/{}/.ATTRIBUTES/VARIABLE_VALUE".format
  assert [listed[key(n)][0] for n in DTYPE_CASES] == [
      "float32", "float64", "int32", "int64", "float16", "bfloat16", "float32", "float32",
      "string"]
  assert values[key("scalar")].shape == () and values[key("empty")].shape == (0, 4)
  assert key("text") not in values


@pytest.mark.parametrize("name", sorted(set(DTYPE_CASES) - {"text"}))
def test_read_variables_by_name(dtype_checkpoint, name):
  key = f"model/{name}/.ATTRIBUTES/VARIABLE_VALUE"
  (value,) = tf_checkpoint.read_variables(dtype_checkpoint, [key]).values()
  ref = tf.train.load_checkpoint(dtype_checkpoint).get_tensor(key)
  np.testing.assert_array_equal(value, np.asarray(ref, value.dtype))


def test_read_variables_refuses_unknown_names_and_strings(dtype_checkpoint):
  with pytest.raises(KeyError, match="no_such"):
    tf_checkpoint.read_variables(dtype_checkpoint, ["no_such"])
  with pytest.raises(tf_checkpoint.TFCheckpointError, match="string"):
    tf_checkpoint.read_variables(dtype_checkpoint, ["model/text/.ATTRIBUTES/VARIABLE_VALUE"])


def test_reader_walks_several_index_blocks(tmp_path):
  """TF's bundle tables hold 256 KiB a block: 1600 names of ~200 bytes that
  differ early (little shared prefix) make more than one."""
  module = tf.Module()
  module.d = {f"{i:04d}_" + "x" * 180: tf.Variable(np.float32(i)) for i in range(1600)}
  prefix = tf.train.Checkpoint(model=module).save(str(tmp_path / "ckpt"))
  with open(prefix + ".index", "rb") as f:
    n_blocks = len(tf_checkpoint._data_block_handles(f.read(), prefix))
  assert n_blocks > 1
  values = assert_reads_like_tf(prefix)
  assert len(values) == 1601  # and save_counter


def test_reader_on_the_full_width_flagship(tmp_path):
  """The flagship (ELIC 192/192/192/320, synthesis (12, 3)): ~24M float32
  parameters in the reference's layout, read and held to TF."""
  cfg = dict(configs.TWO_LAYER_SYN_RD)
  tc = dict(cfg["transform_config"], hyper_analysis=dict(cls="HyperAnalysis"),
            hyper_synthesis=dict(cls="HyperSynthesis"))
  port, _ = families.build_model(cfg, "mshyper")
  flat = params_lib.init_params(port, 0)
  mirror = tf_mirror.TFModelMirror(tc, nest(flat))
  prefix = tf.train.Checkpoint(model=mirror).save(str(tmp_path / "ckpt"))
  del mirror
  t = time.perf_counter()
  tf_checkpoint.read_variables(prefix)
  seconds = time.perf_counter() - t
  n = sum(v.size for v in flat.values())
  print(f"read {n} float32 parameters ({os.path.getsize(prefix + '.data-00000-of-00001')} "
        f"bytes) in {seconds:.2f} s")
  assert n > 23_000_000 and seconds < 60
  values = assert_reads_like_tf(prefix)
  config = dict(model_config=dict(cfg, transform_config=tc))
  table = convert_lib.build_translation(config, "mshyper")
  rel = {k[len("model/"):-len("/.ATTRIBUTES/VARIABLE_VALUE")]: v
         for k, v in values.items() if k.startswith("model/")}
  assert sorted(name for name, _ in table.values()) == sorted(
      k.replace("/", ".") for k in flat)
  convert_lib.assign_variables(port, rel, table)
  for k, v in flat.items():
    np.testing.assert_array_equal(to_numpy(port.state_dict()[k.replace("/", ".")]), v, k)


# ---------------------------------------------------------------------------
# Corrupted and unsupported files
# ---------------------------------------------------------------------------
def _varint(v: int) -> bytes:
  out = bytearray()
  while True:
    out.append((v & 0x7F) | (0x80 if v > 0x7F else 0))
    v >>= 7
    if not v:
      return bytes(out)


def _field(number: int, value) -> bytes:
  if isinstance(value, bytes):
    return _varint(number << 3 | 2) + _varint(len(value)) + value
  return _varint(number << 3) + _varint(value)


def _block(entries) -> bytes:
  body, restarts = bytearray(), []
  for key, value in entries:  # a restart at every entry: no shared prefix
    restarts.append(len(body))
    body += _varint(0) + _varint(len(key)) + _varint(len(value)) + key + value
  body += b"".join(struct.pack("<I", r) for r in restarts) + struct.pack("<I", len(restarts))
  return bytes(body)


def _shape_proto(*dims):
  return b"".join(_field(2, _field(1, d)) for d in dims)


def _good_fields(data):
  """BundleEntryProto fields of a float32 [2, 3] tensor at offset 0 of shard 0."""
  return {1: 1, 2: _shape_proto(2, 3), 5: len(data), 6: tf_checkpoint.masked_crc32c(data)}


def _write(prefix, fields, data, endianness=0, ctype=0):
  """A bundle of one tensor "w" whose BundleEntryProto holds `fields`
  (number -> value; 6, the crc32c, is a fixed32), laid out as TF writes one:
  the header and the entry in one data block of compression type `ctype`,
  an empty metaindex block, the index block and the footer."""
  entry = b"".join(_varint(6 << 3 | 5) + struct.pack("<I", v) if n == 6 else _field(n, v)
                   for n, v in fields.items())
  header = _field(1, 1) + _field(2, endianness)
  out = bytearray()

  def emit(contents, block_type=0):
    offset = len(out)
    out.extend(contents + bytes([block_type]))
    out.extend(struct.pack("<I", tf_checkpoint.masked_crc32c(contents + bytes([block_type]))))
    return _varint(offset) + _varint(len(contents))

  data_handle = emit(_block([(b"", header), (b"w", entry)]), ctype)
  meta_handle = emit(_block([]))
  index_handle = emit(_block([(b"w", data_handle)]))
  footer = (meta_handle + index_handle).ljust(40, b"\0") + struct.pack("<Q", 0xDB4775248B80FB57)
  with open(prefix + ".index", "wb") as f:
    f.write(bytes(out) + footer)
  with open(prefix + ".data-00000-of-00001", "wb") as f:
    f.write(data)


DATA = np.arange(6, dtype="<f4").tobytes()


def test_hand_written_bundle_reads(tmp_path):
  prefix = str(tmp_path / "ok")
  _write(prefix, _good_fields(DATA), DATA)
  assert tf_checkpoint.list_variables(prefix) == {"w": ("float32", (2, 3))}
  np.testing.assert_array_equal(tf_checkpoint.read_variables(prefix)["w"],
                                np.arange(6, dtype=np.float32).reshape(2, 3))
  # TensorFlow reads the hand-written bundle too: the layout is TF's.
  np.testing.assert_array_equal(tf.train.load_checkpoint(prefix).get_tensor("w"),
                                np.arange(6, dtype=np.float32).reshape(2, 3))


@pytest.mark.parametrize("fault,match", [
    ("sliced", "partitioned"), ("compressed", "compression type 1"),
    ("big_endian", "big-endian"), ("size", "needs 24 bytes"), ("crc", "crc32c mismatch"),
    ("short_data", "past the file's end"), ("shard", "shard 1 of 1")])
def test_hand_written_bundle_faults_raise(tmp_path, fault, match):
  prefix = str(tmp_path / "bad")
  fields = _good_fields(DATA)
  kw = {}
  if fault == "sliced":
    fields[7] = _field(1, _field(1, 0))  # one TensorSliceProto
  elif fault == "compressed":
    kw["ctype"] = 1
  elif fault == "big_endian":
    kw["endianness"] = 1
  elif fault == "size":
    fields[5] = 20
  elif fault == "crc":
    fields[6] ^= 1
  elif fault == "short_data":
    fields[4] = 4
  elif fault == "shard":
    fields[3] = 1
  _write(prefix, fields, DATA, **kw)
  with pytest.raises(tf_checkpoint.TFCheckpointError, match=match) as info:
    tf_checkpoint.read_variables(prefix)
  assert os.path.basename(prefix) in str(info.value)


def test_flipped_data_byte_raises_crc(tmp_path):
  prefix = str(tmp_path / "copy" / "ckpt-1")
  os.makedirs(tmp_path / "copy")
  for suffix in (".index", ".data-00000-of-00001"):
    with open(FIXTURE_PREFIX + suffix, "rb") as f:
      data = bytearray(f.read())
    if suffix != ".index":
      data[len(data) // 2] ^= 0x10
    with open(prefix + suffix, "wb") as f:
      f.write(data)
  with pytest.raises(tf_checkpoint.TFCheckpointError, match="crc32c mismatch") as info:
    tf_checkpoint.read_variables(prefix)
  assert "ckpt-1.data-00000-of-00001" in str(info.value) and "model/" in str(info.value)


@pytest.mark.parametrize("where", ["block", "magic"])
def test_corrupted_index_raises(tmp_path, where):
  prefix = str(tmp_path / "ckpt-1")
  with open(FIXTURE_PREFIX + ".index", "rb") as f:
    index = bytearray(f.read())
  if where == "block":
    index[100] ^= 0x01
  else:
    index[-1] ^= 0x01
  with open(prefix + ".index", "wb") as f:
    f.write(index)
  match = "crc32c mismatch" if where == "block" else "bad table magic"
  with pytest.raises(tf_checkpoint.TFCheckpointError, match=match) as info:
    tf_checkpoint.list_variables(prefix)
  assert "ckpt-1.index" in str(info.value)


def test_latest_checkpoint_like_tf(tmp_path):
  module = tf.Module()
  module.v = tf.Variable(np.float32(1))
  ckpt = tf.train.Checkpoint(model=module)
  ckpt.save(str(tmp_path / "ckpt"))
  ckpt.save(str(tmp_path / "ckpt"))
  assert tf_checkpoint.latest_checkpoint(str(tmp_path)) == tf.train.latest_checkpoint(
      str(tmp_path)) == str(tmp_path / "ckpt-2")
  state = tmp_path / "checkpoint"
  state.write_text(f'model_checkpoint_path: "{tmp_path / "ckpt-1"}"\n')  # absolute
  assert tf_checkpoint.latest_checkpoint(str(tmp_path)) == tf.train.latest_checkpoint(
      str(tmp_path)) == str(tmp_path / "ckpt-1")
  state.write_text('model_checkpoint_path: "ckpt-9"\n')  # no such index
  assert tf_checkpoint.latest_checkpoint(str(tmp_path)) is None
  assert tf.train.latest_checkpoint(str(tmp_path)) is None
  state.unlink()
  assert tf_checkpoint.latest_checkpoint(str(tmp_path)) is None
  assert tf.train.latest_checkpoint(str(tmp_path)) is None


def test_fixture_digests():
  """tests/data/tf_ckpt_sha256.json: what TF reads from the committed
  fixture, and what the port's reader must give where there is no TF."""
  with open(os.path.join(REPO, "tests", "data", "tf_ckpt_sha256.json")) as f:
    digests = json.load(f)
  values = assert_reads_like_tf(FIXTURE_PREFIX)
  assert set(values) == set(digests)
  for name, value in values.items():
    assert digests[name] == dict(dtype=str(value.dtype), shape=list(value.shape),
                                 sha256=hashlib.sha256(value.tobytes()).hexdigest()), name
  assert "model/optimizer/iterations/.ATTRIBUTES/VARIABLE_VALUE" in digests


# ---------------------------------------------------------------------------
# The converter against JAX's
# ---------------------------------------------------------------------------
def _resolve_both(name, hid):
  jax_path, port_path = _paths(name)
  family = SCRIPTS[name][1]
  return (jax_resolve(jax_path, [], hid, family)[0],
          config_lib.resolve_config(port_path, [], hid), family)


def _table_or_error(build, config, family):
  try:
    return build(config, family), None
  except Exception as e:  # compared by type across the packages
    return None, type(e)


@pytest.mark.parametrize("name", sorted(SCRIPTS))
def test_translation_table_equals_jax(name):
  n_hids = len(config_lib.load_config_module(_paths(name)[1]).get_hyper())
  for hid in [None] + list(range(n_hids)):
    jax_cfg, port_cfg, family = _resolve_both(name, hid)
    ref, ref_err = _table_or_error(jax_convert.build_translation, jax_cfg, family)
    got, got_err = _table_or_error(convert_lib.build_translation, port_cfg, family)
    assert got_err is ref_err, (name, hid, got_err, ref_err)
    if ref is not None:
      assert got == {k: (".".join(p), d) for k, (p, d) in ref.items()}, (name, hid)
      model, _ = families.build_model(port_cfg["model_config"], family)
      assert sorted(n for n, _ in got.values()) == sorted(dict(model.named_parameters()))


def test_manifests_and_kernel_layouts_equal_jax():
  for channels in ((1, 2, 3), (1, 2, 3, 4)):
    for nrb in (0, 1, 3):
      assert (tf_convert.elic_analysis_manifest(channels, nrb)
              == jax_tf_convert.elic_analysis_manifest(channels, nrb))
      assert (tf_convert.elic_synthesis_manifest(channels, nrb)
              == jax_tf_convert.elic_synthesis_manifest(channels, nrb))
  assert ([(t, ".".join(p), d) for t, p, d in jax_tf_convert.enumerate_prior_paths()]
          == tf_convert.enumerate_prior_paths())
  k = np.random.default_rng(0).standard_normal((5, 5, 3, 7)).astype(np.float32)
  flax_k = tf_convert.conv_transpose_kernel_tf_to_flax(k)
  assert flax_k.flags.c_contiguous
  np.testing.assert_array_equal(flax_k, jax_tf_convert.conv_transpose_kernel_tf_to_flax(k))
  np.testing.assert_array_equal(tf_convert.conv_transpose_kernel_flax_to_tf(flax_k), k)
  np.testing.assert_array_equal(tf_convert.conv_kernel_tf_to_flax(k), k)


@pytest.fixture(scope="module")
def converted(tmp_path_factory):
  """The committed fixture converted by the port's CLI and by JAX's script."""
  root = tmp_path_factory.mktemp("converted")
  port_out, jax_out = str(root / "port"), str(root / "jax")
  convert_lib.main(["--workdir_tf", FIXTURE, "--out", port_out, "--device", "cpu"])
  jax_convert.convert(FIXTURE, jax_out, "mshyper")
  return dict(root=root, port=port_out, jax=jax_out)


def test_converted_params_equal_jax(converted):
  payload = train_lib.load_newest_checkpoint(train_lib.checkpoint_dir(converted["port"]))
  assert payload["step"] == 0 and payload["optimizer"]["count"] == 0
  with open(os.path.join(FIXTURE, "config.json")) as f:
    assert json.load(open(os.path.join(converted["port"], "config.json"))) == json.load(f)
  _, params, config = jax_eval_lib.load_latest_ckpt(converted["jax"])
  ref = params_lib.flatten_tree(params)
  got = payload["model"]
  assert sorted(got) == sorted(k.replace("/", ".") for k in ref)
  for key, value in ref.items():
    np.testing.assert_array_equal(got[key.replace("/", ".")].numpy(), value, err_msg=key)


def test_converted_transforms_match_the_tf_model(converted):
  """The TF mirror restored from the fixture computes what the converted
  port model computes (JAX's tolerances, tests/test_tf_parity.py:349-361)."""
  from shallow_ntc_tpu_torch import eval_lib

  model, _ = eval_lib.load_latest_ckpt(converted["port"], device="cpu")
  port_init, _ = families.build_model(FIXTURE_CONFIG["model_config"], "mshyper")
  mirror = tf_mirror.TFModelMirror(FIXTURE_CONFIG["model_config"]["transform_config"],
                                   nest(params_lib.init_params(port_init, 1)))
  tf.train.Checkpoint(model=mirror).restore(FIXTURE_PREFIX).assert_existing_objects_matched()
  rng = np.random.default_rng(21)
  x = (rng.standard_normal((1, 64, 64, 3)) * 0.3).astype(np.float32)
  z = rng.standard_normal((1, 4, 4, 14)).astype(np.float32)
  with torch.no_grad():
    y_tf = mirror._analysis(tf.constant(x)).numpy()
    np.testing.assert_allclose(to_numpy(model._analysis(to_torch(x))), y_tf,
                               rtol=1e-4, atol=2e-5)
    np.testing.assert_allclose(to_numpy(model._synthesis(to_torch(z))),
                               mirror._synthesis(tf.constant(z)).numpy(), rtol=1e-4, atol=1e-4)
    h_tf = mirror._hyper_analysis(tf.constant(y_tf)).numpy()
    np.testing.assert_allclose(to_numpy(model._hyper_analysis(to_torch(y_tf))), h_tf,
                               rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(to_numpy(model._hyper_synthesis(to_torch(h_tf))),
                               mirror._hyper_synthesis(tf.constant(h_tf)).numpy(),
                               rtol=1e-4, atol=1e-4)


def test_eval_of_the_converted_workdir_matches_jax(converted):
  rng = np.random.default_rng(5)
  yy, xx = np.meshgrid(np.linspace(0, 1, 64), np.linspace(0, 1, 96), indexing="ij")
  for i in range(2):
    img = 128 + 80 * np.sin((6 + i) * yy + 3 * xx)[..., None] * np.array([1.0, 0.7, -0.5])
    img = np.clip(img + rng.normal(0, 4, img.shape), 0, 255).round().astype(np.uint8)
    data_lib.write_png(str(converted["root"] / "images" / f"{i}.png"), img)
  pattern = str(converted["root"] / "images" / "*.png")
  path = eval_cli.main(["--workdir", converted["port"], "--dataset", pattern, "--device", "cpu",
                        "--results_dir", str(converted["root"] / "port_results")])
  ref_path = jax_eval_lib.eval_workdir(
      converted["jax"], jax_data.get_dataset(pattern, split="test", batchsize=1,
                                             patchsize=None, normalize=True),
      pattern, str(converted["root"] / "jax_results"))
  with open(path) as f:
    got = json.load(f)
  with open(ref_path) as f:
    ref = json.load(f)
  assert len(got) == len(ref) == 2
  for g, r in zip(got, ref):
    keys = sorted(k for k in r if isinstance(r[k], float))
    assert {"bpp", "psnr", "rd_loss"} <= set(keys) and set(keys) <= set(g)
    np.testing.assert_allclose([g[k] for k in keys], [r[k] for k in keys], rtol=1e-3,
                               err_msg=str(keys))


# ---------------------------------------------------------------------------
# Refusals and the CLI
# ---------------------------------------------------------------------------
def test_converter_rejects_unmatched(tmp_path):
  """A TF variable without a rule fails the conversion, as in JAX
  (tests/test_tf_parity.py:364-385); nothing is written."""
  workdir_tf = tmp_path / "tf_workdir"
  ckpt_dir = workdir_tf / "train" / "checkpoints"
  os.makedirs(ckpt_dir)
  with open(workdir_tf / "config.json", "w") as f:
    json.dump(FIXTURE_CONFIG, f)

  class Stray(tf.Module):
    def __init__(self):
      super().__init__()
      self._analysis = tf.Module()
      self._analysis.bogus = tf.Variable(np.zeros((3, 3), np.float32))

  tf.train.Checkpoint(model=Stray()).save(str(ckpt_dir / "ckpt"))
  with pytest.raises(RuntimeError, match="_analysis/bogus"):
    convert_lib.convert(str(workdir_tf), str(tmp_path / "out"), "mshyper", "cpu")
  assert not os.path.exists(tmp_path / "out")


@pytest.mark.parametrize("fault,match", [
    ("missing", "not covered by the checkpoint:\n  _analysis.Conv_0.bias"),
    ("shape", r"_synthesis/out_conv/kernel -> _synthesis.out_conv.kernel: shape"),
    ("stray", "no layout rule")])
def test_assign_variables_refuses(fault, match):
  tf_vars = convert_lib.read_tf_variables(FIXTURE_PREFIX)
  if fault == "missing":
    del tf_vars["_analysis/_transform/layer_with_weights-0/bias"]
  elif fault == "shape":
    tf_vars["_synthesis/out_conv/kernel"] = tf_vars["_synthesis/out_conv/kernel"][:, :4]
  else:
    tf_vars["_prior/_matrices/9"] = np.zeros(3, np.float32)
  model, _ = families.build_model(FIXTURE_CONFIG["model_config"], "mshyper")
  before = {k: v.clone() for k, v in model.state_dict().items()}
  table = convert_lib.build_translation(FIXTURE_CONFIG, "mshyper")
  with pytest.raises(RuntimeError, match=match):
    convert_lib.assign_variables(model, tf_vars, table)
  assert all(torch.equal(before[k], v) for k, v in model.state_dict().items())


def test_cli_dump_and_device(capsys, monkeypatch, tmp_path):
  convert_lib.main(["--workdir_tf", FIXTURE, "--dump"])
  lines = capsys.readouterr().out.splitlines()
  assert lines == [f"{name} {list(shape)} {dtype}" for name, (dtype, shape) in sorted(
      tf_checkpoint.list_variables(FIXTURE_PREFIX).items())]
  assert "_CHECKPOINTABLE_OBJECT_GRAPH [] string" in lines
  monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
  with pytest.raises(RuntimeError, match="CUDA is not available"):
    convert_lib.main(["--workdir_tf", FIXTURE, "--out", str(tmp_path / "o")])
  with open(tmp_path / "config.json", "w") as f:
    json.dump(FIXTURE_CONFIG, f)
  with pytest.raises(FileNotFoundError, match="No TF checkpoint"):
    convert_lib.main(["--workdir_tf", str(tmp_path), "--out", str(tmp_path / "o"),
                      "--device", "cpu"])
