"""Config scripts and their command-line overrides: the port's replacement
for ml_collections.config_flags (shallow_ntc_tpu/utils/cli.py:17-76).

A config script defines get_config(), which returns nested plain dicts, and
usually get_cfg_str(config) and get_hyper(). An override
`--config.a.b=value` (or `--config.a.b value`) parses `value` by the type of
the value already at a.b, as config_flags does: bool (true/t/1,
false/f/0), int, float, str, tuple (a Python literal such as "(8, 16)"); a
None, list or dict field takes a Python literal, and a None field a plain
string where the text is no literal (config_flags cannot override a None
field at all). A key that is not in the config is an error, as under
lock_config=True. `--hid N` then applies get_hyper()[N] on top, so on the
same key the sweep wins, with ConfigDict's casts: an int into a float field
becomes a float, a list into a tuple field a tuple.
"""

import ast
import copy
import importlib.util
from typing import Any, Dict, List, Mapping, Optional, Sequence, Tuple

_PREFIX = "--config."


def load_config_module(config_filename: str):
  """Import the config script as a module (to reach get_config, get_cfg_str
  and get_hyper)."""
  spec = importlib.util.spec_from_file_location("_user_config", config_filename)
  if spec is None:
    raise FileNotFoundError(f"not a Python config script: {config_filename!r}")
  mod = importlib.util.module_from_spec(spec)
  spec.loader.exec_module(mod)
  return mod


def split_overrides(argv: Sequence[str]) -> Tuple[List[str], List[Tuple[str, str]]]:
  """(the other arguments, [(dotted key, text)]) of a command line, for
  `--config.a.b=text` and `--config.a.b text`."""
  rest, overrides = [], []
  argv = list(argv)
  i = 0
  while i < len(argv):
    arg = argv[i]
    if arg.startswith(_PREFIX):
      key, eq, text = arg[len(_PREFIX):].partition("=")
      if not eq:
        if i + 1 >= len(argv):
          raise ValueError(f"{arg} needs a value")
        i += 1
        text = argv[i]
      overrides.append((key, text))
    else:
      rest.append(arg)
    i += 1
  return rest, overrides


def _literal(text: str) -> Any:
  if text in ("true", "false"):
    text = text.capitalize()
  return ast.literal_eval(text)


def _to_tuple(text: str) -> tuple:
  """config_flags' TupleParser: a literal made a tuple; an unquoted single
  string stays one element."""
  try:
    value = ast.literal_eval(text)
  except ValueError:
    value = text
  except SyntaxError:
    if "," in text or " " in text:
      raise ValueError(f"cannot parse {text!r} as a tuple; quote its elements") from None
    value = text
  if isinstance(value, tuple):
    return value
  if isinstance(value, (list, set)):
    return tuple(value)
  return (value,)


def parse_override(key: str, text: str, current: Any) -> Any:
  """The value of `--config.<key>=<text>` for a field whose value is `current`."""
  if isinstance(current, bool):
    if text.lower() in ("true", "t", "1"):
      return True
    if text.lower() in ("false", "f", "0"):
      return False
    raise ValueError(f"--config.{key}: non-boolean argument {text!r}")
  if isinstance(current, int):
    base = 10
    if len(text) > 2 and text[0] == "0" and text[1] in "ox":
      base = 8 if text[1] == "o" else 16
    return int(text, base)
  if isinstance(current, float):
    return float(text)
  if isinstance(current, str):
    return text
  if isinstance(current, tuple):
    return _to_tuple(text)
  try:
    value = _literal(text)
  except (SyntaxError, ValueError):
    if current is None:
      return text
    raise ValueError(f"--config.{key}: cannot parse {text!r} for a "
                     f"{type(current).__name__} field") from None
  return value


def _cast(key: str, current: Any, value: Any) -> Any:
  """ConfigDict's type-safe assignment of `value` over `current`."""
  if current is None or value is None:
    return value
  if isinstance(current, bool) and not isinstance(value, bool):
    raise TypeError(f"{key}: cannot set {value!r} in a bool field")
  if isinstance(current, float) and isinstance(value, int) and not isinstance(value, bool):
    return float(value)
  if isinstance(current, tuple) and isinstance(value, list):
    return tuple(value)
  if isinstance(current, list) and isinstance(value, tuple):
    return list(value)
  if isinstance(value, type(current)) or (isinstance(current, Mapping)
                                          and isinstance(value, Mapping)):
    return value
  raise TypeError(f"{key}: cannot set {value!r} ({type(value).__name__}) in a "
                  f"{type(current).__name__} field")


def _parent(cfg: Dict, key: str, new_leaf: bool) -> Tuple[Dict, str]:
  """(the dict that holds `key`'s last part, that part); KeyError for a
  missing parent, or for a missing leaf unless `new_leaf`."""
  parts = key.split(".")
  node = cfg
  for i, part in enumerate(parts[:-1]):
    if not isinstance(node, dict) or part not in node:
      raise KeyError(f"config has no key {'.'.join(parts[:i + 1])!r}")
    node = node[part]
  if not isinstance(node, dict) or (parts[-1] not in node and not new_leaf):
    raise KeyError(f"config has no key {key!r}")
  return node, parts[-1]


def override(cfg: Dict, key: str, text: str) -> None:
  """Apply `--config.<key>=<text>` to `cfg` in place."""
  node, leaf = _parent(cfg, key, new_leaf=False)
  node[leaf] = _cast(key, node[leaf], parse_override(key, text, node[leaf]))


def update_from_flattened_dict(cfg: Dict, flat: Mapping[str, Any]) -> None:
  """Set each {"a.b": value} of a sweep entry in `cfg`, in place."""
  for key, value in flat.items():
    node, leaf = _parent(cfg, key, new_leaf=True)
    node[leaf] = _cast(key, node.get(leaf), copy.deepcopy(value))


def resolve_config(config_filename: str, overrides: Sequence[Tuple[str, str]] = (),
                   hid: Optional[int] = None) -> Dict:
  """The config of `config_filename`: get_config(), then the dot overrides,
  then get_hyper()[hid] (IndexError when out of range), and
  config_filename stored in it."""
  mod = load_config_module(config_filename)
  cfg = copy.deepcopy(mod.get_config())
  for key, text in overrides:
    override(cfg, key, text)
  cfg["config_filename"] = config_filename
  if hid is not None:
    update_from_flattened_dict(cfg, mod.get_hyper()[hid])
  return cfg
