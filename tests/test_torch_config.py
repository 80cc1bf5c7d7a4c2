"""The port's config scripts, their overrides and sweeps, run names and the
sweep combinators against the JAX package on the CPU.

Each of the ten config scripts of shallow_ntc_tpu_torch resolves, at its
defaults, at --hid 0 and at its last hid, with and without dot overrides,
to the dict that the JAX CLI resolves from its own script through
ml_collections' config flags (a fresh absl FlagValues per case), and to
the same run name. ml_collections and absl are read here only: the port
imports neither.
"""

import copy

import pytest
from absl import flags
from ml_collections import config_flags

from shallow_ntc_tpu import project_configs as jax_project_configs
from shallow_ntc_tpu.models import base as jax_base
from shallow_ntc_tpu.utils import cli as jax_cli
from shallow_ntc_tpu.utils import hyper as jax_hyper
from shallow_ntc_tpu.utils import runname as jax_runname
from shallow_ntc_tpu_torch import configs
from shallow_ntc_tpu_torch import project_configs
from shallow_ntc_tpu_torch.utils import cli
from shallow_ntc_tpu_torch.utils import config as config_lib
from shallow_ntc_tpu_torch.utils import hyper
from shallow_ntc_tpu_torch.utils import runname

SCRIPTS = {  # name -> (family directory, the family the entry module passes)
    "two_layer_syn": ("mshyper", "mshyper"), "two_layer_syn_rd": ("mshyper", "mshyper"),
    "two_layer_syn2": ("mshyper", "mshyper"), "jpegl": ("mshyper", "mshyper"),
    "jpegl_rd": ("mshyper", "mshyper"), "mbt2018": ("mshyper", "mshyper"),
    "smoke": ("mshyper", "mshyper"), "itinf": ("mshyper", "mshyper"),
    "bls2017": ("factorized", "factorized"), "bls2017_rd": ("factorized", "factorized"),
}

# Per script: an int, a float on the key the sweep sets (so the sweep must
# win at a hid), and a tuple or a str override.
_SECOND = {
    "two_layer_syn": ("model_config.transform_config.analysis.channels", "(8, 8, 8, 16)"),
    "two_layer_syn_rd": ("model_config.transform_config.synthesis.kernel_sizes", "(9,5)"),
    "two_layer_syn2": ("model_config.transform_config.synthesis.channels", "(6, 3)"),
    "jpegl": ("model_config.transform_config.analysis.channels", "(16,16,16,32)"),
    "jpegl_rd": ("val_data_config.dataset", "deadleaves_eval"),
    "mbt2018": ("train_data_config.dataset", "deadleaves_train"),
    "smoke": ("model_config.transform_config.synthesis.channels", "(4,3)"),
    "itinf": ("data_config.dataset", "deadleaves_eval"),
    "bls2017": ("val_data_config.dataset", "tecnick"),
    "bls2017_rd": ("model_config.transform_config.analysis",
                   "{'cls': 'BLS2017Analysis', 'num_filters': 64}"),
}


def _overrides(name):
  out = [("train_eval_config.num_steps", "7"), _SECOND[name]]
  if name == "itinf":
    out.append(("train_eval_config.warm_start_wid", "5"))
  else:
    out.append(("model_config.rd_lambda", "0.5"))
  return out


def _paths(name):
  fam = SCRIPTS[name][0]
  return (f"shallow_ntc_tpu/{fam}/configs/{name}.py",
          f"shallow_ntc_tpu_torch/{fam}/configs/{name}.py")


def jax_resolve(path, overrides, hid, family):
  """The JAX CLI's resolved config (plain dict) and run name."""
  argv = ["prog", f"--config={path}"] + [f"--config.{k}={v}" for k, v in overrides]
  if hid is not None:
    argv.append(f"--hid={hid}")
  fv = flags.FlagValues()
  config_flags.DEFINE_config_file("config", None, "", lock_config=True, flag_values=fv,
                                  sys_argv=argv)
  flags.DEFINE_integer("hid", None, "", flag_values=fv)
  fv(argv)
  cfg, filename = jax_cli.resolve_config(fv)
  return jax_base.to_plain_dict(cfg), jax_cli.get_runname(cfg, filename, family)


def port_resolve(path, overrides, hid, family):
  cfg = config_lib.resolve_config(path, overrides, hid)
  return cfg, cli.get_runname(cfg, path, family)


def _cases():
  for name in SCRIPTS:
    n = len(config_lib.load_config_module(_paths(name)[1]).get_hyper())
    for hid in (None, 0, n - 1):
      for with_overrides in (False, True):
        yield name, hid, with_overrides


@pytest.mark.parametrize("name,hid,with_overrides", list(_cases()))
def test_resolved_config_and_runname_equal_jax(name, hid, with_overrides):
  jax_path, port_path = _paths(name)
  family = SCRIPTS[name][1]
  overrides = _overrides(name) if with_overrides else []
  ref, ref_name = jax_resolve(jax_path, overrides, hid, family)
  got, got_name = port_resolve(port_path, overrides, hid, family)
  assert ref.pop("config_filename") == jax_path and got.pop("config_filename") == port_path
  assert got == ref
  assert got_name == ref_name
  if with_overrides and hid is not None and name != "itinf":
    # The sweep is applied after the dot overrides: on its key it wins.
    key = next(iter(config_lib.load_config_module(port_path).get_hyper()[hid]))
    if key == "model_config.rd_lambda":
      assert got["model_config"]["rd_lambda"] != 0.5


@pytest.mark.parametrize("name", sorted(SCRIPTS))
def test_sweep_length_and_unknown_key_and_hid_out_of_range(name):
  jax_path, port_path = _paths(name)
  family = SCRIPTS[name][1]
  n = len(config_lib.load_config_module(port_path).get_hyper())
  assert n == len(jax_cli.load_config_module(jax_path).get_hyper())
  for path, resolve in ((jax_path, jax_resolve), (port_path, port_resolve)):
    with pytest.raises(Exception):
      resolve(path, [("train_eval_config.no_such_key", "1")], None, family)
    with pytest.raises(Exception):
      resolve(path, [("no_such_section.key", "1")], None, family)
    with pytest.raises(IndexError):
      resolve(path, [], n, family)


def test_override_parsing_by_field_type():
  cfg = {"a": {"i": 1, "f": 1.5, "b": False, "s": "x", "t": (1, 2), "n": None, "l": [1],
               "d": {"k": 1}}}
  for key, text, want in [("i", "0x10", 16), ("f", "2", 2.0), ("b", "true", True),
                          ("b", "0", False), ("s", "(1, 2)", "(1, 2)"), ("t", "(3,)", (3,)),
                          ("t", "5", (5,)), ("t", "a/b*", ("a/b*",)), ("n", "64", 64),
                          ("n", "dir/*.png", "dir/*.png"), ("l", "[2, 3]", [2, 3]),
                          ("d", "{'k': 2}", {"k": 2})]:
    c = copy.deepcopy(cfg)
    config_lib.override(c, f"a.{key}", text)
    assert c["a"][key] == want and type(c["a"][key]) is type(want), (key, text)
  for key, text in [("i", "1.5"), ("b", "yes"), ("f", "x")]:
    with pytest.raises(ValueError):
      config_lib.override(copy.deepcopy(cfg), f"a.{key}", text)
  with pytest.raises(KeyError):
    config_lib.override(copy.deepcopy(cfg), "a.zz", "1")
  rest, overrides = config_lib.split_overrides(
      ["--hid", "1", "--config.a.i=3", "--config.a.s", "v w", "--device", "cpu"])
  assert rest == ["--hid", "1", "--device", "cpu"]
  assert overrides == [("a.i", "3"), ("a.s", "v w")]
  c = copy.deepcopy(cfg)
  config_lib.update_from_flattened_dict(c, {"a.f": 3, "a.t": [7, 8], "a.new": 1})
  assert c["a"]["f"] == 3.0 and type(c["a"]["f"]) is float and c["a"]["t"] == (7, 8)
  assert c["a"]["new"] == 1
  with pytest.raises(TypeError):
    config_lib.update_from_flattened_dict(copy.deepcopy(cfg), {"a.i": 2.5})


RUNNAME_DICTS = [
    ({"rd_lambda": 0.01, "num_steps": 30000}, {}),
    ({"rd_lambda": 0.08, "bottleneck_size": 320, "hidden_channels": 12, "k1": 13,
      "act": "igdn", "uq_method": "unoise"}, {}),
    ({"wwid": 0, "uq_method": "sga"}, {"skip_falsy": False}),
    ({"wwid": 0, "uq_method": "sga", "x": None, "y": ""}, {}),
    ({"arch": (2, 4, 8), "tau": 1e-5, "name": "a"}, {"prefix": "mshyper"}),
    ({"arch": [2, 4], "rd_lambda": 2}, {"primary_delimiter": "/", "secondary_delimiter": "x"}),
    ({"rd_lambda": 0.5}, {"args_abbr": {}}),
]

RUNNAMES = [
    "mshyper-lmbda=0.01-num_steps=30000",
    "wid=3-mshyper-lmbda=0.08-csize=320-hc=12-k1=13-k2=5-act=igdn-uq=unoise",
    "dir-lamb=2-arch=2_4_8/tau=1.0-step=0",
    "factorized-lmbda=1e-05-x=-3.5-t=.25-flag=True",
    "mshyper-wwid=0-uq=sga-step=3000-xid=2026,10,17,120000",
]


@pytest.mark.parametrize("i", range(len(RUNNAME_DICTS)))
def test_config_dict_to_str_equals_jax(i):
  d, kwargs = RUNNAME_DICTS[i]
  assert runname.config_dict_to_str(d, **kwargs) == jax_runname.config_dict_to_str(d, **kwargs)


@pytest.mark.parametrize("s", RUNNAMES)
def test_parse_runname_equals_jax(s):
  for parse_numbers in (False, True):
    got = runname.parse_runname(s, parse_numbers=parse_numbers)
    ref = jax_runname.parse_runname(s, parse_numbers=parse_numbers)
    assert list(got.items()) == list(ref.items())


def test_sweep_izip_product_equal_jax():
  a = ([0.1, 0.2, 0.3], [1, 2, 3], [(12, 3), (24, 3)])
  for mod in (hyper, jax_hyper):
    assert mod.sweep("x", []) == []
  assert hyper.sweep("m.x", a[0]) == jax_hyper.sweep("m.x", a[0])
  assert (hyper.izip(hyper.sweep("x", a[0]), hyper.sweep("y", a[1]))
          == jax_hyper.izip(jax_hyper.sweep("x", a[0]), jax_hyper.sweep("y", a[1])))
  assert (hyper.product(hyper.sweep("x", a[0]), hyper.sweep("c", a[2]), hyper.sweep("y", a[1]))
          == jax_hyper.product(jax_hyper.sweep("x", a[0]), jax_hyper.sweep("c", a[2]),
                               jax_hyper.sweep("y", a[1])))
  assert hyper.product() == jax_hyper.product() == [{}]
  with pytest.raises(ValueError):
    hyper.izip(hyper.sweep("x", a[0]), hyper.sweep("c", a[2]))


def test_project_configs_and_eval_configs_from_the_scripts():
  """The port's project names and abbreviations are JAX's; configs.py's
  model configs and run names are the scripts' at their defaults."""
  assert project_configs.args_abbr == jax_project_configs.args_abbr
  assert project_configs.dataset_to_globs == jax_project_configs.dataset_to_globs
  for name in configs.EVAL_CONFIG_NAMES:
    model_config, name_of_run, family = configs.eval_config(name)
    ref, ref_name = jax_resolve(_paths(name)[0], [], None, family)
    ref["model_config"].pop("optimizer_config")
    assert model_config == ref["model_config"] and name_of_run == ref_name
