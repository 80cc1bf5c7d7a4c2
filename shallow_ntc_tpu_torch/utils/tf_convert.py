"""TF/Keras checkpoint paths -> the port's parameter names, and the kernel
layouts (the port's copy of shallow_ntc_tpu/utils/tf_convert.py).

Needed to import the reference's released TF checkpoints (HF
yiboyang/shallow-ntc-checkpoints, reference README.md:21). The port keeps
every parameter in the flax layout under its flax name (params.py), so a TF
path maps to the flax path with '/' read as '.', and only these layout facts
apply (held against tf.keras by the JAX package's tests):

  * Conv2D:          TF kernel [kh, kw, in, out] == the flax kernel.
  * Conv2DTranspose: TF stores [kh, kw, out, in] and computes the gradient of
                     a strided conv (a flipped correlation); the flax kernel is
                     [kh, kw, in, out], correlated unflipped over the dilated
                     input: transpose(0, 1, 3, 2) and a spatial flip.
  * GDN:             tfc's sqrt-reparameterized beta/gamma with pedestal 2^-18
                     are the stored values here too: copied.
  * DeepFactorized:  matrices, biases and factors, raw, (channels, f_out,
                     f_in) / (channels, f_out, 1) on both sides: copied.

The reference's keras-2.10 models are checkpointed with
tf.train.Checkpoint(model=model) (reference train_lib.py:123), so variable
paths follow the trackable object graph: tf.Module attributes by name, keras
Sequential children as `layer_with_weights-N` (weighted layers only, in
order), conv weights as kernel/bias, tfc.GDN passed as a conv's
`activation=` under `<conv>/activation/<beta|gamma>_parameter/variable`, and
tfc.DeepFactorized lists under `_prior/_matrices/N` etc.
`enumerate_transform_paths` gives, for one transform config, each TF path
in that layout with its parameter name and whether the kernel needs the
deconv flip and transpose: a structural mapping, not a match by shape
(which would misassign ELIC's many same-shaped 1x1 kernels).
"""

import numpy as np


def conv_kernel_tf_to_flax(tf_kernel: np.ndarray) -> np.ndarray:
  """tf.keras Conv2D kernel [kh, kw, in, out] -> the flax conv kernel."""
  return np.asarray(tf_kernel)


def _conv_entries(tf_prefix, our_prefix, deconv, use_bias=True):
  out = [(f"{tf_prefix}/kernel", f"{our_prefix}.kernel", deconv)]
  if use_bias:
    out.append((f"{tf_prefix}/bias", f"{our_prefix}.bias", False))
  return out


def _gdn_entries(tf_prefix, our_prefix):
  """tfc.GDN under `tf_prefix` -> the GDN module's params (storage-identical)."""
  return [
      (f"{tf_prefix}/beta_parameter/variable", f"{our_prefix}.beta", False),
      (f"{tf_prefix}/gamma_parameter/variable", f"{our_prefix}.gamma", False),
  ]


def _resblock_entries(tf_prefix, our_prefix):
  """Reference elic.ResidualBlock: `_block`, a Sequential of 3 convs."""
  out = []
  for j in range(3):
    out += _conv_entries(f"{tf_prefix}/_block/layer_with_weights-{j}",
                         f"{our_prefix}.Conv_{j}", deconv=False)
  return out


def _attention_entries(tf_prefix, our_prefix):
  """Reference elic.SimpleAttention: `_trunk` = 3 ResBlocks,
  `_attention_branch` = 3 ResBlocks + a sigmoid 1x1 conv. The module names
  the trunk blocks first (ResidualBlock_0..2), then the branch blocks
  (ResidualBlock_3..5), then the gate conv (Conv_0)."""
  out = []
  for j in range(3):
    out += _resblock_entries(f"{tf_prefix}/_trunk/layer_with_weights-{j}",
                             f"{our_prefix}.ResidualBlock_{j}")
  for j in range(3):
    out += _resblock_entries(f"{tf_prefix}/_attention_branch/layer_with_weights-{j}",
                             f"{our_prefix}.ResidualBlock_{3 + j}")
  out += _conv_entries(f"{tf_prefix}/_attention_branch/layer_with_weights-3",
                       f"{our_prefix}.Conv_0", deconv=False)
  return out


def elic_analysis_manifest(channels, num_residual_blocks):
  """Keras-layer-order manifest of ElicAnalysis._transform (reference
  elic.py:147-161): ("conv", name) / ("resblock", name) / ("attention",
  name), one per weighted Sequential child, in order."""
  nc = len(channels)
  if nc not in (3, 4):
    raise ValueError(f"ELIC uses 3 or 4 conv layers (not {channels}).")
  entries = []
  counters = {"conv": 0, "resblock": 0, "attention": 0}

  def add(kind):
    prefix = {"conv": "Conv", "resblock": "ResidualBlock", "attention": "SimpleAttention"}[kind]
    entries.append((kind, f"{prefix}_{counters[kind]}"))
    counters[kind] += 1

  def add_rbs():
    for _ in range(num_residual_blocks):
      add("resblock")

  if nc == 4:
    add("conv")
    add_rbs()
  add("conv")
  add_rbs()
  add("attention")
  add("conv")
  add_rbs()
  add("conv")
  add("attention")
  return entries


def elic_synthesis_manifest(channels, num_residual_blocks):
  """Keras-layer-order manifest of ElicSynthesis._transform (reference
  elic.py:218-236): SA, deconv0, RBs, deconv1, SA, RBs, deconv2 [, RBs,
  deconv3]. The deconvs are the FastConvTranspose_i modules."""
  nc = len(channels)
  if nc not in (3, 4):
    raise ValueError(f"ELIC uses 3 or 4 conv layers (not {channels}).")
  entries = []
  counters = {"deconv": 0, "resblock": 0, "attention": 0}

  def add(kind):
    prefix = {"deconv": "FastConvTranspose", "resblock": "ResidualBlock",
              "attention": "SimpleAttention"}[kind]
    entries.append((kind, f"{prefix}_{counters[kind]}"))
    counters[kind] += 1

  def add_rbs():
    for _ in range(num_residual_blocks):
      add("resblock")

  add("attention")
  add("deconv")
  add_rbs()
  add("deconv")
  add("attention")
  add_rbs()
  add("deconv")
  if nc == 4:
    add_rbs()
    add("deconv")
  return entries


def enumerate_transform_paths(cfg: dict, tf_attr: str, our_attr: str):
  """All (tf checkpoint path, parameter name, needs the deconv conversion)
  of one transform config dict, in the reference checkpoint layout.

  TF paths are relative to the checkpointed root object (which
  tf.train.Checkpoint prefixes with `model/`) and leave out the
  `/.ATTRIBUTES/...` suffix.
  """
  cls = cfg["cls"]
  out = []

  def seq_stack(specs):
    # (_ConvStack-based transforms) the reference's keras Sequential of convs.
    for i, deconv in enumerate(specs):
      out.extend(_conv_entries(f"{tf_attr}/layer_with_weights-{i}",
                               f"{our_attr}.stack.convs_{i}", deconv))

  if cls == "ElicAnalysis":
    channels = tuple(cfg.get("channels", (128, 160, 192, 192)))
    nrb = cfg.get("num_residual_blocks", 3)
    for i, (kind, name) in enumerate(elic_analysis_manifest(channels, nrb)):
      tf_prefix = f"{tf_attr}/_transform/layer_with_weights-{i}"
      if kind == "conv":
        out += _conv_entries(tf_prefix, f"{our_attr}.{name}", deconv=False)
      elif kind == "resblock":
        out += _resblock_entries(tf_prefix, f"{our_attr}.{name}")
      else:
        out += _attention_entries(tf_prefix, f"{our_attr}.{name}")
  elif cls == "ElicSynthesis":
    channels = tuple(cfg.get("channels", (192, 160, 128, 3)))
    nrb = cfg.get("num_residual_blocks", 3)
    for i, (kind, name) in enumerate(elic_synthesis_manifest(channels, nrb)):
      tf_prefix = f"{tf_attr}/_transform/layer_with_weights-{i}"
      if kind == "deconv":
        out += _conv_entries(tf_prefix, f"{our_attr}.{name}", deconv=True)
      elif kind == "resblock":
        out += _resblock_entries(tf_prefix, f"{our_attr}.{name}")
      else:
        out += _attention_entries(tf_prefix, f"{our_attr}.{name}")
  elif cls == "TwoLayerResSynthesis":
    act = cfg.get("activation_type", "igdn")
    out += _conv_entries(f"{tf_attr}/base_conv", f"{our_attr}.base_conv", True)
    if act and act.lower() in ("gdn", "gdn1", "igdn", "igdn1"):
      out += _gdn_entries(f"{tf_attr}/base_conv/activation", f"{our_attr}.base_act")
    if cfg.get("res_type", "conv") == "conv":
      out += _conv_entries(f"{tf_attr}/res", f"{our_attr}.res_conv", True)
    else:  # d2s: Sequential of [d2s, conv, d2s, conv, d2s]
      out += _conv_entries(f"{tf_attr}/res/layer_with_weights-0", f"{our_attr}.res_conv1",
                           False)
      out += _conv_entries(f"{tf_attr}/res/layer_with_weights-1", f"{our_attr}.res_conv2",
                           False)
    out += _conv_entries(f"{tf_attr}/out_conv", f"{our_attr}.out_conv", True)
  elif cls == "TwoLayerSynthesis":
    act = cfg.get("activation_type", "igdn")
    out += _conv_entries(f"{tf_attr}/conv1", f"{our_attr}.conv1", True)
    if act and act.lower() in ("gdn", "gdn1", "igdn", "igdn1"):
      out += _gdn_entries(f"{tf_attr}/conv1/activation", f"{our_attr}.act")
    out += _conv_entries(f"{tf_attr}/conv2", f"{our_attr}.conv2", True)
  elif cls in ("JPEGLikeSynthesis", "JPEGLikeHyperSynthesis"):
    use_bias = cfg.get("use_bias", True)
    out += _conv_entries(f"{tf_attr}/conv", f"{our_attr}.conv", True, use_bias)
  elif cls == "HyperAnalysis":
    seq_stack([False, False, False])
  elif cls == "HyperSynthesis":
    # All three layers are Conv2DTranspose (conv_t_k5s2 x2 + conv_t_k3s1,
    # reference transforms.py:222-232).
    seq_stack([True, True, True])
  elif cls == "CNNAnalysis":
    seq_stack([False] * 4)
  elif cls == "CNNSynthesis":
    seq_stack([True] * 4)
  else:
    raise NotImplementedError(
        f"No TF checkpoint layout rule for transform {cls}; run the converter "
        "with --dump and extend enumerate_transform_paths.")
  return out


def enumerate_prior_paths(num_filters=(3, 3, 3), our_attr: str = "_prior"):
  """tfc.DeepFactorized variable paths -> the DeepFactorizedPrior's params.

  Both store the raw (softplus-reparameterized) matrices, raw biases and raw
  factors with shapes (C, f_out, f_in) / (C, f_out, 1); copied.
  """
  out = []
  n = len(num_filters) + 1
  for i in range(n):
    out.append((f"_prior/_matrices/{i}", f"{our_attr}.matrix_{i}", False))
    out.append((f"_prior/_biases/{i}", f"{our_attr}.bias_{i}", False))
    if i < n - 1:
      out.append((f"_prior/_factors/{i}", f"{our_attr}.factor_{i}", False))
  return out


def conv_transpose_kernel_tf_to_flax(tf_kernel: np.ndarray) -> np.ndarray:
  """tf.keras Conv2DTranspose kernel [kh, kw, out, in] -> the flax deconv
  kernel [kh, kw, in, out] computing the same function (contiguous)."""
  k = np.transpose(np.asarray(tf_kernel), (0, 1, 3, 2))
  return np.ascontiguousarray(k[::-1, ::-1])


def conv_transpose_kernel_flax_to_tf(flax_kernel: np.ndarray) -> np.ndarray:
  """Inverse of conv_transpose_kernel_tf_to_flax (contiguous)."""
  k = np.asarray(flax_kernel)[::-1, ::-1]
  return np.ascontiguousarray(np.transpose(k, (0, 1, 3, 2)))
