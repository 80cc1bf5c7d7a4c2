"""LPIPS (Zhang 2018) perceptual metric: a VGG16 feature distance (mirrors
shallow_ntc_tpu/models/lpips.py).

Weights are not bundled: one .npz serves both packages, found at
$SHALLOW_NTC_LPIPS_WEIGHTS or where the JAX package looks, and written by
scripts/convert_lpips_weights.py from the public torchvision VGG16 and the
PerceptualSimilarity 'vgg' linear heads. Without it make_lpips_fn() raises
FileNotFoundError and the eval omits the metric. random_weights() draws the
JAX package's random weights (the same numpy draws) for tests.

Expected npz keys:
  conv{i}_w [kh, kw, cin, cout], conv{i}_b [cout]  for i in 0..12 (VGG16 convs)
  lin{l}_w  [c_l]                                   for l in 0..4 (LPIPS heads)
"""

import os
from typing import Callable, Dict, List, Optional

import numpy as np
import torch
import torch.nn.functional as F

# VGG16 conv plan: (out_channels, pool_before) per conv layer.
_VGG_PLAN = [
    (64, False), (64, False),
    (128, True), (128, False),
    (256, True), (256, False), (256, False),
    (512, True), (512, False), (512, False),
    (512, True), (512, False), (512, False),
]
# Feature taps after these conv indexes (relu1_2, 2_2, 3_3, 4_3, 5_3).
_TAPS = [1, 3, 6, 9, 12]

# Input normalization from the LPIPS reference implementation.
_SHIFT = np.asarray([-0.030, -0.088, -0.188], np.float32)
_SCALE = np.asarray([0.458, 0.448, 0.450], np.float32)


def _vgg_features(weights: Dict[str, torch.Tensor], x: torch.Tensor) -> List[torch.Tensor]:
  """x: [B, H, W, 3] in [-1, 1] -> the 5 tapped feature maps, NCHW."""
  shift = torch.as_tensor(_SHIFT, device=x.device)
  scale = torch.as_tensor(_SCALE, device=x.device)
  h = ((x - shift) / scale).permute(0, 3, 1, 2)
  feats = []
  for i, (_, pool_before) in enumerate(_VGG_PLAN):
    if pool_before:
      h = F.max_pool2d(h, 2, 2)  # 2x2 VALID, as lax.reduce_window's
    w = weights[f"conv{i}_w"]  # [3, 3, cin, cout]: SAME is 1 on each side
    h = torch.relu(F.conv2d(h, w.permute(3, 2, 0, 1), weights[f"conv{i}_b"], padding=1))
    if i in _TAPS:
      feats.append(h)
  return feats


def _unit_normalize(f: torch.Tensor, eps: float = 1e-10) -> torch.Tensor:
  return f / (torch.sqrt(torch.sum(torch.square(f), dim=1, keepdim=True)) + eps)


def lpips_distance(weights: Dict[str, torch.Tensor], x255: torch.Tensor,
                   y255: torch.Tensor) -> torch.Tensor:
  """Per-image LPIPS [B] between [B, H, W, 3] tensors in [0, 255]."""
  x = x255.float() / 127.5 - 1.0
  y = y255.float() / 127.5 - 1.0
  total = 0.0
  for l, (a, b) in enumerate(zip(_vgg_features(weights, x), _vgg_features(weights, y))):
    d = torch.square(_unit_normalize(a) - _unit_normalize(b))  # [B, C, H, W]
    lin = torch.clamp_min(weights[f"lin{l}_w"], 0.0)  # nonnegative heads
    total = total + torch.mean(torch.einsum("bchw,c->bhw", d, lin), dim=(1, 2))
  return total


def default_weights_path() -> str:
  """$SHALLOW_NTC_LPIPS_WEIGHTS, else the file the JAX package looks for
  (shallow_ntc_tpu/lpips_vgg_weights.npz beside this package): one file
  serves both packages."""
  root = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
  return os.environ.get("SHALLOW_NTC_LPIPS_WEIGHTS",
                        os.path.join(root, "shallow_ntc_tpu", "lpips_vgg_weights.npz"))


def load_weights(path: Optional[str] = None, device="cpu") -> Dict[str, torch.Tensor]:
  """The weights of the .npz at `path` (default_weights_path()) on `device`."""
  path = path or default_weights_path()
  if not os.path.exists(path):
    raise FileNotFoundError(
        f"LPIPS weights not found at {path}; run "
        "scripts/convert_lpips_weights.py or set SHALLOW_NTC_LPIPS_WEIGHTS.")
  with np.load(path) as z:
    weights = {k: torch.as_tensor(np.asarray(z[k], np.float32), device=device) for k in z.files}
  missing = [f"conv{i}_w" for i in range(len(_VGG_PLAN)) if f"conv{i}_w" not in weights]
  if missing:
    raise KeyError(f"missing {missing} in {path}")
  return weights


def make_lpips_fn(path: Optional[str] = None, device="cpu",
                  weights: Optional[Dict[str, torch.Tensor]] = None) -> Callable:
  """A (x255, y255) -> mean LPIPS callable, from `weights` or the .npz at
  `path`; raises FileNotFoundError without a weights file."""
  if weights is None:
    weights = load_weights(path, device)

  @torch.no_grad()
  def fn(x255: torch.Tensor, y255: torch.Tensor) -> torch.Tensor:
    return torch.mean(lpips_distance(weights, x255, y255))

  return fn


def random_weights(rng=None, device="cpu") -> Dict[str, torch.Tensor]:
  """Random weights of the right shapes, the JAX package's draws (for tests)."""
  rng = np.random.default_rng(0 if rng is None else rng)
  weights = {}
  cin = 3
  for i, (cout, _) in enumerate(_VGG_PLAN):
    weights[f"conv{i}_w"] = rng.normal(0, 0.05, (3, 3, cin, cout)).astype(np.float32)
    weights[f"conv{i}_b"] = np.zeros((cout,), np.float32)
    cin = cout
  for l, tap in enumerate(_TAPS):
    weights[f"lin{l}_w"] = np.abs(rng.normal(0, 0.01, (_VGG_PLAN[tap][0],))).astype(np.float32)
  return {k: torch.as_tensor(v, device=device) for k, v in weights.items()}
