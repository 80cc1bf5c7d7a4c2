"""Write the committed TF checkpoint fixture of the port's checkpoint import.

  python tests/make_tf_checkpoint_fixture.py [--out tests/data/tf_ckpt]

A reference-layout workdir (under 1 MB): <out>/config.json, the flagship
-style tiny mshyper config of tests/test_tf_parity.py (ELIC (8, 10, 12, 14)
with one residual block, TwoLayerResSynthesis (6, 3) k13s8 + k5s2 with
IGDN, the hyper transforms at bottleneck 14), and
<out>/train/checkpoints/{checkpoint, ckpt-1.index,
ckpt-1.data-00000-of-00001}, written by real TensorFlow through
tests/tf_mirror.TFModelMirror (the reference's object layout) from the
port's flax-style init of seed 0 with every leaf nudged
(tests/torch_parity.perturbed_init). Beside it the reference also keeps its
optimizer as a model attribute (reference models.py:85), so
`model/optimizer/iterations` is there for the converter to leave out.
Also writes tests/data/tf_ckpt_sha256.json: each numeric variable's dtype,
shape and the SHA-256 of its C-order bytes as tf.train.load_checkpoint reads
it, which the port's reader is held to on machines without TensorFlow
(chip_smoke.py).
"""

import argparse
import hashlib
import json
import os
import shutil
import sys

import numpy as np
import tensorflow as tf

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
from shallow_ntc_tpu_torch.models import families  # noqa: E402
from tests import tf_mirror  # noqa: E402
from tests.torch_parity import nest, perturbed_init  # noqa: E402

CONFIG = dict(
    model_family="mshyper",
    model_config=dict(
        scheduled_num_steps=100,
        rd_lambda=0.02,
        optimizer_config=dict(learning_rate=1e-4, warmup_until=0.0),
        transform_config=dict(
            analysis=dict(cls="ElicAnalysis", channels=(8, 10, 12, 14), num_residual_blocks=1),
            synthesis=dict(cls="TwoLayerResSynthesis", channels=(6, 3), strides=(8, 2),
                           kernel_sizes=(13, 5), activation_type="igdn", res_type="conv"),
            hyper_analysis=dict(cls="HyperAnalysis", bottleneck_size=14),
            hyper_synthesis=dict(cls="HyperSynthesis", bottleneck_size=14),
        ),
        latent_config=dict(uq=dict(method="unoise")),
    ),
)


def digests(prefix):
  """{name: {dtype, shape, sha256}} of every numeric variable, as TF reads it."""
  reader = tf.train.load_checkpoint(prefix)
  out = {}
  for name, dtype in sorted(reader.get_variable_to_dtype_map().items()):
    if dtype == tf.string:
      continue
    value = np.asarray(reader.get_tensor(name))
    out[name] = dict(dtype=dtype.name, shape=list(value.shape),
                     sha256=hashlib.sha256(value.tobytes()).hexdigest())
  return out


def main():
  parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
  parser.add_argument("--out", default=os.path.join(REPO, "tests", "data", "tf_ckpt"))
  parser.add_argument("--digests", default=os.path.join(REPO, "tests", "data",
                                                        "tf_ckpt_sha256.json"))
  args = parser.parse_args()
  port, _ = families.build_model(CONFIG["model_config"], "mshyper")
  mirror = tf_mirror.TFModelMirror(CONFIG["model_config"]["transform_config"],
                                   nest(perturbed_init(port, 0)))
  mirror.optimizer = tf.Module()
  mirror.optimizer.iterations = tf.Variable(np.int64(0))
  shutil.rmtree(args.out, ignore_errors=True)
  ckpt_dir = os.path.join(args.out, "train", "checkpoints")
  os.makedirs(ckpt_dir)
  with open(os.path.join(args.out, "config.json"), "w") as f:
    json.dump(CONFIG, f, indent=2)
  prefix = tf.train.Checkpoint(model=mirror).save(os.path.join(ckpt_dir, "ckpt"))
  with open(args.digests, "w") as f:
    json.dump(digests(prefix), f, indent=1, sort_keys=True)
    f.write("\n")
  size = sum(os.path.getsize(os.path.join(ckpt_dir, n)) for n in os.listdir(ckpt_dir))
  print(f"wrote {prefix} ({size} bytes) and {args.digests}")


if __name__ == "__main__":
  main()
