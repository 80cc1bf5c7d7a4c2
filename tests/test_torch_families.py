"""The port's transforms of both families, its activations and the two added
mshyper configurations (two_layer_syn2 with the mixedq branch, mbt2018)
against the JAX package on the CPU, float32, at narrow widths.

Transforms and activations are held at atol 1e-4 * max(1, max|ref|), the
form tests/test_torch_transforms.py uses; model metrics and gradients as
tests/test_torch_train.py and tests/test_torch_model.py hold the flagship's.
"""

import copy
import logging

import jax
import numpy as np
import pytest
import torch

from shallow_ntc_tpu.models import base as jax_base
from shallow_ntc_tpu.models import mshyper as jax_mshyper
from shallow_ntc_tpu.models import transforms as jT
from shallow_ntc_tpu.ops import fast_deconv as jax_fd
from shallow_ntc_tpu.utils import cli as jax_cli
from shallow_ntc_tpu_torch import configs
from shallow_ntc_tpu_torch import params as params_lib
from shallow_ntc_tpu_torch.models import base
from shallow_ntc_tpu_torch.models import families
from shallow_ntc_tpu_torch.models import transforms as T
from shallow_ntc_tpu_torch.ops import fast_deconv as fd
from tests.test_torch_train import _batch, _flat, _jax_noise, check_two_train_steps_match_jax
from tests.torch_parity import (check_eval_matches_jax, images, models, nest, perturbed_init,
                                rand, to_numpy, to_torch)

TLS2 = dict(cls="TwoLayerSynthesis", channels=(12, 3), strides=(8, 2), kernel_sizes=(13, 5),
            activation_type="igdn")

# (config, input channels, input [B, H, W]): analyses at image sizes that are
# no multiple of their stride (BLS2017's k9s4 pads more on the high side),
# syntheses and hyper transforms at small latent grids.
TRANSFORMS = {
    "BLS2017Analysis": (dict(cls="BLS2017Analysis", num_filters=8), 3, (1, 37, 53)),
    "BLS2017Synthesis": (dict(cls="BLS2017Synthesis", num_filters=8), 8, (2, 3, 5)),
    "MBT2018Analysis": (dict(cls="MBT2018Analysis", channels_base=8, output_channels=12), 3,
                        (1, 35, 50)),
    "MBT2018Synthesis": (dict(cls="MBT2018Synthesis", channels_base=8, output_channels=3), 12,
                         (1, 3, 4)),
    "MBT2018Analysis n_layers=3": (dict(cls="MBT2018Analysis", channels_base=8, n_layers=3), 3,
                                   (2, 17, 22)),
    "CNNAnalysis": (dict(cls="CNNAnalysis", channels_base=8, output_channels=12), 3,
                    (1, 35, 50)),
    "CNNAnalysis prelu": (dict(cls="CNNAnalysis", channels_base=8, activation_type="prelu"), 3,
                          (1, 32, 48)),
    "CNNSynthesis": (dict(cls="CNNSynthesis", channels_base=8), 12, (1, 2, 3)),
    "CNNSynthesis gelu": (dict(cls="CNNSynthesis", channels_base=8, activation_type="gelu"), 12,
                          (1, 2, 3)),
    "HyperAnalysisSmall": (dict(cls="HyperAnalysisSmall", bottleneck_size=8), 12, (1, 5, 7)),
    "HyperSynthesisSmall": (dict(cls="HyperSynthesisSmall", bottleneck_size=8), 8, (1, 3, 4)),
    "TwoLayerSynthesis": (TLS2, 16, (1, 3, 4)),
    "TwoLayerSynthesis prelu": (dict(TLS2, activation_type="prelu"), 16, (2, 2, 3)),
    "TwoLayerSynthesis lrelu": (dict(TLS2, activation_type="lrelu"), 16, (2, 2, 3)),
    "TwoLayerSynthesis None": (dict(TLS2, activation_type=None), 16, (1, 2, 3)),
    # The last two of the JAX registry: ELIC's synthesis at 4 and 3 layers
    # (one residual block per chain), and the pixel-shuffle residual branch.
    "ElicSynthesis": (dict(cls="ElicSynthesis", channels=(16, 16, 16, 3),
                           num_residual_blocks=1), 16, (1, 2, 3)),
    "ElicSynthesis 3 layers": (dict(cls="ElicSynthesis", channels=(16, 16, 3),
                                    kernel_sizes=(5, 5, 5), strides=(2, 2, 2),
                                    num_residual_blocks=1), 16, (2, 2, 3)),
    "TwoLayerResSynthesis d2s": (dict(cls="TwoLayerResSynthesis", channels=(12, 3),
                                      res_type="d2s"), 16, (2, 2, 3)),
}


def _tol(ref):
  return 1e-4 * max(1.0, float(np.abs(ref).max()))


def _flax_paths(cfg, x):
  shapes = jax.eval_shape(lambda: jT.build_transform(dict(cfg)).init(
      jax.random.PRNGKey(0), x))["params"]
  return {"/".join(str(k.key) for k in path): tuple(leaf.shape)
          for path, leaf in jax.tree_util.tree_leaves_with_path(shapes)}


def _pair(cfg, in_c, bhw, seed=0, **port_extra):
  """(flax output, port output, the port module, flat params) on one seeded input."""
  x = rand(np.random.default_rng(seed), bhw + (in_c,))
  port = T.build_transform(dict(cfg), in_c, **port_extra)
  flat = perturbed_init(port, seed)
  params_lib.load_params(port, flat)
  ref = np.asarray(jax.jit(jT.build_transform(dict(cfg)).apply)({"params": nest(flat)}, x))
  with torch.no_grad():
    out = to_numpy(port(to_torch(x)))
  return ref, out, port, flat


@pytest.mark.parametrize("name", sorted(TRANSFORMS))
def test_param_paths_match_flax_init(name):
  """Every flax parameter path and shape has its state-dict key, and no more:
  MBT2018's convs_i / acts_i on the module with no last activation, the
  stacks' stack/convs_i, stack/acts_i, TwoLayerSynthesis's conv1, act, conv2,
  and no entry for a parameterless activation."""
  cfg, in_c, bhw = TRANSFORMS[name]
  port = T.build_transform(dict(cfg), in_c)
  assert _flax_paths(cfg, np.zeros(bhw + (in_c,), np.float32)) == {
      k.replace(".", "/"): tuple(v.shape) for k, v in port.state_dict().items()}


@pytest.mark.parametrize("name", sorted(TRANSFORMS))
def test_transform_matches_flax(name):
  cfg, in_c, bhw = TRANSFORMS[name]
  ref, out, port, _ = _pair(cfg, in_c, bhw)
  assert out.shape == ref.shape
  np.testing.assert_allclose(out, ref, atol=_tol(ref))
  jax_module = jT.build_transform(dict(cfg))
  for attr in ("downsample_factor", "upsample_factor", "output_depth"):
    if hasattr(type(jax_module), attr):
      assert getattr(port, attr) == getattr(jax_module, attr), attr


@pytest.mark.parametrize("batch,hw", [(1, (3, 4)), (2, (2, 3)), (4, (2, 2))])
def test_two_layer_synthesis_fused_route_matches_flax_and_unfused(batch, hw, monkeypatch):
  """The fused route (phase conv, IGDN per phase, final_deconv_phase, here its
  plain version on the CPU) against flax's fused route and the port's
  unfused one; batch 4 takes JAX's grouped-tap branch, which the port
  computes densely."""
  calls = []
  plain = T.final_deconv_phase
  monkeypatch.setattr(T, "final_deconv_phase", lambda *a: calls.append(1) or plain(*a))
  ref, out, _, flat = _pair(TLS2, 16, (batch,) + hw, seed=batch)
  assert out.shape == (batch, 16 * hw[0], 16 * hw[1], 3) and calls == [1]
  np.testing.assert_allclose(out, ref, atol=_tol(ref))
  unfused = T.build_transform(dict(TLS2), 16, fused=False)
  params_lib.load_params(unfused, flat)
  z = rand(np.random.default_rng(batch), (batch,) + hw + (16,))
  with torch.no_grad():
    np.testing.assert_allclose(to_numpy(unfused(to_torch(z))), out, atol=_tol(ref))
  assert calls == [1]
  flax_unfused = jT.build_transform(dict(TLS2), fused=False).apply({"params": nest(flat)}, z)
  np.testing.assert_allclose(to_numpy(unfused(to_torch(z)).detach()), np.asarray(flax_unfused),
                             atol=_tol(ref))


def test_prelu_does_not_fuse(monkeypatch):
  """With PReLU both synthesis classes take the unfused route, as in JAX."""
  monkeypatch.setattr(T, "final_deconv_phase", lambda *a: pytest.fail("fused with PReLU"))
  for cfg in (dict(TLS2, activation_type="prelu"),
              dict(cls="TwoLayerResSynthesis", channels=(12, 3), strides=(8, 2),
                   kernel_sizes=(13, 5), activation_type="prelu", res_type="conv")):
    ref, out, _, _ = _pair(cfg, 16, (1, 2, 3))
    np.testing.assert_allclose(out, ref, atol=_tol(ref))


@pytest.mark.parametrize("alpha,epsilon,inverse,rectify", [
    (1.0, 1.0, False, False), (1.0, 1.0, True, False), (2.0, 0.5, False, False),
    (2.0, 0.5, True, False), (1.5, 0.75, False, False), (2.0, 0.5, False, True)])
def test_gdn_matches_flax(alpha, epsilon, inverse, rectify):
  """The general GDN (|x| for alpha 1, x^2 for 2, |x|^alpha otherwise; sqrt for
  epsilon 0.5, a power otherwise), and its phase-space form against JAX's
  gdn_phase."""
  x = rand(np.random.default_rng(int(alpha * 10 + epsilon * 100)), (2, 3, 4, 8))
  port = T.GDN(8, inverse=inverse, alpha=alpha, epsilon=epsilon, rectify=rectify)
  flat = perturbed_init(port, 5)
  params_lib.load_params(port, flat)
  jax_gdn = jT.GDN(inverse=inverse, alpha=alpha, epsilon=epsilon, rectify=rectify)
  ref = np.asarray(jax_gdn.apply({"params": nest(flat)}, x))
  with torch.no_grad():
    out = to_numpy(port(to_torch(x)))
  np.testing.assert_allclose(out, ref, atol=_tol(ref))
  beta, gamma = port.effective_params(torch.float32)
  x_p = rand(np.random.default_rng(3), (1, 2, 3, 4 * 8))
  ref_p = jax_fd.gdn_phase(x_p, to_numpy(beta), to_numpy(gamma), 4, inverse, alpha, epsilon)
  out_p = fd.gdn_phase(to_torch(x_p), beta, gamma, 4, inverse, alpha, epsilon)
  np.testing.assert_allclose(to_numpy(out_p.detach()), np.asarray(ref_p), atol=_tol(ref_p))


@pytest.mark.parametrize("name", ["relu", "lrelu", "leaky_relu", "gelu", "silu", "swish", "elu",
                                  "selu", "softplus", "sigmoid", "tanh", "relu6",
                                  "hard_tanh", "prelu", "gdn", "igdn1"])
def test_make_activation_matches_jax(name):
  """Every name make_activation resolves: leaky relu at slope 0.2 (the
  reference's tf.nn.leaky_relu), jax.nn's others, PReLU with a learned slope,
  GDN1 and IGDN1. Parameterless ones register nothing."""
  x = rand(np.random.default_rng(len(name)), (2, 3, 5, 6), 3.0)
  port = T.make_activation(name, 6)
  flat = perturbed_init(port, 1) if list(port.parameters()) else {}
  params_lib.load_params(port, flat)
  jax_act = jT.make_activation(name)
  if flat:
    ref = np.asarray(jax_act.apply({"params": nest(flat)}, x))
  else:
    ref = np.asarray(jax_act(x))
  with torch.no_grad():
    np.testing.assert_allclose(to_numpy(port(to_torch(x))), ref, atol=_tol(ref))
  if name in ("lrelu", "leaky_relu"):
    np.testing.assert_allclose(to_numpy(port(torch.tensor([-1.0]))), [-0.2])
  with pytest.raises(ValueError, match="Unknown activation"):
    T.make_activation("no_such_activation", 6)


def test_build_transform_knows_every_jax_class_but_elic_synthesis():
  """Every class name of the JAX registry builds in the port (a bare config
  lacks required arguments: TypeError), ElicSynthesis too now; an unknown
  name raises KeyError, as JAX's registry does."""
  missing = []
  for cls in jT._classes:
    try:
      T.build_transform(dict(cls=cls.__name__), 8)
    except KeyError:
      missing.append(cls.__name__)
    except TypeError:
      pass
  assert missing == []
  with pytest.raises(KeyError, match="Unknown class"):
    T.build_transform(dict(cls="NoSuchTransform"), 8)


# --- the configurations ----------------------------------------------------------
JAX_CONFIGS = {
    "two_layer_syn2": ("shallow_ntc_tpu/mshyper/configs/two_layer_syn2.py", "TWO_LAYER_SYN2"),
    "mbt2018": ("shallow_ntc_tpu/mshyper/configs/mbt2018.py", "MBT2018"),
    "bls2017": ("shallow_ntc_tpu/factorized/configs/bls2017.py", "BLS2017"),
    "bls2017_rd": ("shallow_ntc_tpu/factorized/configs/bls2017_rd.py", "BLS2017_RD"),
}


@pytest.mark.parametrize("name", sorted(JAX_CONFIGS))
def test_config_is_its_jax_config_file(name):
  """The model config, family and run name of each added config equal its JAX
  config file's (read here, as ml_collections is a test-only dependency); its
  train config carries the file's optimizer and schedule."""
  path, attr = JAX_CONFIGS[name]
  ref = jax_cli.load_config_module(path).get_config()
  ref_model = copy.deepcopy(ref.model_config.to_dict())
  ref_optimizer = ref_model.pop("optimizer_config")
  model_config, runname, family = configs.eval_config(name)
  assert model_config is getattr(configs, attr)
  assert model_config == ref_model
  assert family == ref.model_family
  assert runname == jax_cli.get_runname(ref, path, family)
  train = configs.TRAIN_CONFIGS[name]
  assert train["model_family"] == family
  assert train["model_config"] == dict(ref_model, optimizer_config=ref_optimizer)
  for key, value in ref.train_eval_config.items():
    if key != "steps_per_dispatch":  # a TPU scan window the port does not take
      assert train["train_eval_config"][key] == value, key
  assert {k: train["train_data_config"][k] for k in ("batchsize", "patchsize")} == {
      k: ref.train_data_config[k] for k in ("batchsize", "patchsize")}


def test_itinf_factorized_is_the_itinf_file_on_bls2017_rd():
  ref = jax_cli.load_config_module("shallow_ntc_tpu/mshyper/configs/itinf.py").get_config()
  port = configs.ITINF_FACTORIZED
  assert port["model_family"] == "factorized" and configs.ITINF["model_family"] == "mshyper"
  assert port["model_config"] == {**copy.deepcopy(configs.BLS2017_RD),
                                  **ref.model_config.to_dict()}
  assert port["train_eval_config"] == configs.ITINF["train_eval_config"]
  assert configs.itinf_config("itinf_factorized") is port


@pytest.mark.parametrize("method,offset_heuristic", [
    ("mixedq", True), ("mixedq", False), ("unoise", True), ("soft_round", False)])
def test_effective_offset_heuristic_matches_jax(method, offset_heuristic, caplog):
  """mixedq turns the heuristic off, with JAX's warning; other methods keep it."""
  cfg = dict(offset_heuristic=offset_heuristic, latent_config=dict(uq=dict(method=method)))
  with caplog.at_level(logging.WARNING):
    ours = base.effective_offset_heuristic(cfg)
  assert ours == jax_base.effective_offset_heuristic(cfg)
  warned = "modifying offset_heuristic from True to False" in caplog.text
  assert warned == (method == "mixedq" and offset_heuristic)
  model, _ = families.build_model(dict(SMALL_TLS2, **cfg), "mshyper")
  assert model.offset_heuristic == ours
  assert (model.prior_quantization_offset() is None) == (not ours)


# --- the models: two_layer_syn2 (mixedq) and mbt2018 at narrow widths -------------
SMALL_TLS2 = copy.deepcopy(configs.TWO_LAYER_SYN2)
SMALL_TLS2["transform_config"]["analysis"].update(channels_base=8, output_channels=16)
SMALL_MBT = copy.deepcopy(configs.MBT2018)
SMALL_MBT["transform_config"]["analysis"].update(channels_base=8, output_channels=16)
SMALL_MBT["transform_config"]["synthesis"].update(channels_base=8)


@pytest.mark.parametrize("name,cfg,hw", [("two_layer_syn2", SMALL_TLS2, (80, 112)),
                                         ("mbt2018", SMALL_MBT, (64, 64))])
def test_eval_matches_jax(name, cfg, hw):
  """The eval path of each model against JAX's (tests/torch_parity.py:
  latents 1e-4, hyper-synthesis and synthesis from JAX's rounded latents
  1e-4, metrics rtol 1e-3). mixedq's eval is unoise's hard round."""
  check_eval_matches_jax(*models(cfg, seed=2), images(len(name) + hw[1], hw))


def test_numpy_init_has_the_flax_tree_with_prelu():
  """init_params gives exactly the flax Model.init tree of a mixedq model with
  PReLU in its CNN analysis, and PReLU's slope is flax's 0.25."""
  cfg = copy.deepcopy(SMALL_TLS2)
  cfg["transform_config"]["analysis"]["activation_type"] = "prelu"
  jax_model = jax_mshyper.Model(**cfg)
  shapes = jax.eval_shape(lambda: jax_model.init(
      jax.random.PRNGKey(0), np.zeros((1, 64, 64, 3), np.float32), training=False))["params"]
  flax_flat = {"/".join(str(k.key) for k in path): leaf
               for path, leaf in jax.tree_util.tree_leaves_with_path(shapes)}
  flat = params_lib.init_params(families.build_model(cfg, "mshyper")[0], seed=0)
  assert {k: v.shape for k, v in flat.items()} == {k: v.shape for k, v in flax_flat.items()}
  slopes = [k for k in flat if k.endswith("negative_slope")]
  assert len(slopes) == 3 and all(np.all(flat[k] == 0.25) for k in slopes)
  real = jT.PReLU().init(jax.random.PRNGKey(0), np.zeros((1, 2, 2, 8), np.float32))
  np.testing.assert_array_equal(flat[slopes[0]], np.asarray(real["params"]["negative_slope"]))


@pytest.mark.parametrize("cfg", [SMALL_TLS2, SMALL_MBT], ids=["two_layer_syn2", "mbt2018"])
def test_training_loss_and_gradients_match_jax(cfg):
  """The training=True loss (mixedq for two_layer_syn2: the bits of the noisy
  sample, the rounded latents onward; unoise for mbt2018) with JAX's noise:
  metrics rtol 1e-5; every gradient within 1e-4 * max(1, max|g|)."""
  jax_model, params, port = models(cfg, seed=3)
  port.train()
  x = _batch(4)
  key = jax.random.PRNGKey(1)

  def loss_fn(p):
    loss, metrics, _ = jax_model.apply({"params": p}, x, training=True,
                                       rng=jax.random.fold_in(key, 0), step=0,
                                       method=jax_mshyper.Model.end_to_end_frame_loss)
    return loss, metrics

  (_, m_j), g_j = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(params)
  loss_t, m_t, _ = port.end_to_end_frame_loss(to_torch(x), training=True, step=0,
                                              noise=_jax_noise(key, 0))
  loss_t.backward()
  assert set(m_t) == set(m_j)
  for k in m_j:
    np.testing.assert_allclose(float(m_t[k].detach()), float(m_j[k]), rtol=1e-5, err_msg=k)
  g_j = _flat(g_j)
  for name, p in port.named_parameters():
    g = g_j[name.replace(".", "/")]
    np.testing.assert_allclose(to_numpy(p.grad), g, rtol=0,
                               atol=1e-4 * max(1.0, float(np.abs(g).max())), err_msg=name)


def test_mixedq_decodes_the_rounded_latents():
  """mixedq in training: the synthesis reads round(y - mu) + mu, not the
  noisy sample, while the rate is the noisy sample's (as unoise's)."""
  _, _, port = models(SMALL_TLS2, seed=4)
  x = to_torch(_batch(5))
  noise = _jax_noise(jax.random.PRNGKey(2), 0)
  caught = []
  synthesize = port.synthesize
  port.synthesize = lambda y_hat: caught.append(y_hat) or synthesize(y_hat)
  with torch.no_grad():
    _, m_mixed, _ = port.end_to_end_frame_loss(x, training=True, noise=noise)
    port.latent_config = dict(uq=dict(method="unoise"))
    _, m_unoise, _ = port.end_to_end_frame_loss(x, training=True, noise=noise)
    rv = port.infer_latent_rvs(x)
    mu, _ = port.hyper_synthesize(torch.round(rv.uq[0].loc))
  del port.synthesize
  np.testing.assert_allclose(to_numpy(caught[0]), to_numpy(torch.round(rv.uq[1].loc - mu) + mu),
                             atol=1e-5)
  assert not torch.equal(caught[0], caught[1])
  # z's rate is the noisy sample's in both; y's follows the rounded z_hat.
  assert float(m_mixed["hyper_latent_bpp"]) == float(m_unoise["hyper_latent_bpp"])
  assert float(m_mixed["latent_bpp"]) != float(m_unoise["latent_bpp"])


def test_two_train_steps_of_two_layer_syn2_match_jax():
  """Two mixedq train steps at narrow widths, as tests/test_torch_train.py
  holds the flagship's."""
  train = configs.TRAIN_CONFIGS["two_layer_syn2"]
  check_two_train_steps_match_jax(SMALL_TLS2, train["model_config"]["optimizer_config"])
