"""Data-parallel training and height-split inference (the torch counterpart
of shallow_ntc_tpu/parallel/mesh.py, which has device meshes and lets XLA
insert the collectives and halo exchanges).

Data parallel: the model is replicated, one process per device, and its
training loss goes through DistributedDataParallel (`data_parallel`). DDP
averages the gradients over the group, for a call through its own forward
only, so the loss is wrapped in a module whose forward is the model's
end_to_end_frame_loss. Every parameter of every family gets a gradient in
training, so DDP runs without find_unused_parameters.

Height split (JAX's spatial_sharding): `HeightSplit` runs one pixel-space
transform (an analysis or a synthesis) on N row strips of its input, strip
i on devices[i], each with a halo of rows from its neighbours, crops the
halos away and stitches the strips on devices[0]. The halo is computed
from the transform's layers (`row_halo`), the strip edges fall on its
stride, and the zero padding at the image's own edges stays where it was,
so the split computes the unsplit function, up to float reassociation, as
XLA's halo exchange does. `ModelHeightSplit(model, devices)` runs a
model's analysis and synthesis so inside a `with` block; the
latent-space part (the hyper-analysis, the prior, the hyper-synthesis, the
rates) runs whole on the first device.
"""

import copy
import math
from typing import List, Optional, Sequence, Tuple

import torch
from torch import nn

from shallow_ntc_tpu_torch.models.elic import SimpleAttention
from shallow_ntc_tpu_torch.models.transforms import (GDN, Conv, FastConvTranspose, Pointwise, PReLU,
                                                     TwoLayerResSynthesis)
from shallow_ntc_tpu_torch.ops import int8ops


# ---------------------------------------------------------------------------
# Data parallel
# ---------------------------------------------------------------------------
class FrameLoss(nn.Module):
  """The model's training-mode end_to_end_frame_loss as a forward, which
  DDP needs to sync the gradients."""

  def __init__(self, model: nn.Module):
    super().__init__()
    self.model = model

  def forward(self, batch: torch.Tensor, step: int, noise: Tuple[torch.Tensor, ...]):
    return self.model.end_to_end_frame_loss(batch, training=True, step=step, noise=noise)


def data_parallel(model: nn.Module) -> nn.parallel.DistributedDataParallel:
  """DDP over the default group of the model's training loss. Rank 0's
  parameters are broadcast to the others here (every rank builds the same
  init anyway)."""
  device = next(model.parameters()).device
  return nn.parallel.DistributedDataParallel(
      FrameLoss(model), device_ids=[device] if device.type == "cuda" else None)


# ---------------------------------------------------------------------------
# Height split
# ---------------------------------------------------------------------------
def _indexed(device) -> torch.device:
  device = torch.device(device)
  if device.type == "cuda" and device.index is None:
    return torch.device("cuda", torch.cuda.current_device())
  return device


def spatial_device_list(spatial_devices: int) -> Optional[List[torch.device]]:
  """The strips' devices of the CLIs' --spatial_devices N: cuda:0 ...
  cuda:N-1, or None (unsplit) for 1; raises when fewer CUDA devices are
  present, as JAX's make_mesh does."""
  if spatial_devices <= 1:
    return None
  available = torch.cuda.device_count() if torch.cuda.is_available() else 0
  if spatial_devices > available:
    raise ValueError(f"spatial_devices={spatial_devices} but {available} CUDA devices are "
                     "present")
  return [torch.device("cuda", i) for i in range(spatial_devices)]


# Leaf modules that reach no other row: the activations (GDN acts across
# channels only).
POINTWISE_LEAVES = (GDN, PReLU, Pointwise)


def row_layers(module: nn.Module) -> List[Tuple[str, int, int]]:
  """(kind, kernel, stride) of the convolutions along the longest path of
  rows through `module`, in order; kind "conv" (SAME) or "deconv" (SAME
  transposed). Pointwise leaves (POINTWISE_LEAVES) add nothing, and any
  other leaf module raises, so that a transform with a spatial layer of
  another kind is not split on a halo too short. Of two parallel branches
  only the one that reaches farther counts."""
  if isinstance(module, Conv):
    return [("conv", module.kernel.shape[0], module.stride)]
  if isinstance(module, FastConvTranspose):
    return [("deconv", module.kernel.shape[0], module.stride)]
  if isinstance(module, POINTWISE_LEAVES):
    return []
  if isinstance(module, SimpleAttention):
    # trunk (blocks 0-2) beside branch (blocks 3-5 then Conv_0): equal chains
    children = [module.ResidualBlock_0, module.ResidualBlock_1, module.ResidualBlock_2,
                module.Conv_0]
  elif isinstance(module, TwoLayerResSynthesis):
    # res_conv has base_conv's geometry; the d2s branch is pointwise
    children = [module.base_conv, module.out_conv]
  else:
    children = list(module.children())
    if not children:
      raise TypeError(f"{type(module).__name__}: no row halo is known for this layer")
  return [layer for child in children for layer in row_layers(child)]


def _bad_rows(kind: str, k: int, s: int, bad_in: int, edge: str) -> int:
  """Rows at the `edge` ("top" or "bottom") of a layer's output that read
  any of the `bad_in` rows at that edge of its input or the zero padding
  beyond it: the rows a strip computes differently from the whole image.

  conv: output j reads input rows [j*s - lo, j*s - lo + k - 1], with lax
  SAME padding lo = max(k - s, 0) // 2 at the top and k - s - lo at the
  bottom (input rows a multiple of s). deconv: output o reads input row i
  where i*s lies in [o - p, o - p + k - 1], p = k - 1 - q at the top and
  s - 1 + q at the bottom, q = max(k - s, 0) // 2
  (ops/fast_deconv.fast_conv_transpose)."""
  if kind == "conv":
    lo = max(k - s, 0) // 2
    pad = lo if edge == "top" else k - s - lo
    return max(0, -(-(bad_in + pad) // s))
  q = max(k - s, 0) // 2
  pad = k - 1 - q if edge == "top" else s - 1 + q
  bad = 0  # count the outputs whose window holds a multiple of s below bad_in * s
  while True:
    first = -(-(bad - pad) // s)  # the first input row in output `bad`'s window
    if first * s > bad - pad + k - 1 or first >= bad_in:
      return bad
    bad += 1


def row_halo(transform: nn.Module) -> Tuple[int, int, int, int]:
  """(top, bottom, rows_in, rows_out) of a transform: a strip needs `top`
  and `bottom` halo rows of the transform's coarse grid above and below it
  for its rows to equal the whole image's; one coarse row is rows_in input
  rows and rows_out output rows (an analysis: its stride and 1; a
  synthesis: 1 and its stride)."""
  layers = row_layers(transform)
  down = math.prod(s for kind, _, s in layers if kind == "conv")
  up = math.prod(s for kind, _, s in layers if kind == "deconv")
  if down > 1 and up > 1:
    raise ValueError("a transform that both downsamples and upsamples is not split")
  halo = []
  for edge in ("top", "bottom"):
    bad = 0
    for kind, k, s in layers:
      bad = _bad_rows(kind, k, s, bad, edge)
    halo.append(-(-bad // up))  # output rows -> coarse rows
  return halo[0], halo[1], down, up


def strip_bounds(rows: int, n: int) -> List[Tuple[int, int]]:
  """[start, stop) of min(n, rows) strips of near-equal height covering rows."""
  n = min(n, rows)
  edges = [rows * i // n for i in range(n + 1)]
  return list(zip(edges[:-1], edges[1:]))


class HeightSplit(nn.Module):
  """`transform` run on len(devices) row strips, strip i on devices[i]
  (see the module docstring; a list may name one device several times).
  The result lies on devices[0]."""

  def __init__(self, transform: nn.Module, devices: Sequence):
    super().__init__()
    self.devices = [_indexed(d) for d in devices]
    top, bottom, self.rows_in, self.rows_out = row_halo(transform)
    self.halo = (top, bottom)
    self.transform = transform
    own = next(transform.parameters()).device
    # The copies on other devices are a cache, not parameters of the module.
    self._replicas = {own: transform}
    for d in self.devices:
      if d not in self._replicas:
        self._replicas[d] = copy.deepcopy(transform).to(d)

  def forward(self, x: torch.Tensor) -> torch.Tensor:
    if int8ops.enabled() or int8ops.encode_enabled():
      raise NotImplementedError(
          "the int8 paths quantize with scales over the whole tensor; a strip's would differ")
    rows = x.shape[1]
    if rows % self.rows_in:
      raise ValueError(f"{rows} input rows are not a multiple of the stride {self.rows_in}")
    coarse = rows // self.rows_in
    top, bottom = self.halo
    outs = []
    for (a, b), device in zip(strip_bounds(coarse, len(self.devices)), self.devices):
      lo, hi = max(a - top, 0), min(b + bottom, coarse)
      strip = x[:, lo * self.rows_in:hi * self.rows_in].to(device)
      out = self._replicas[device](strip)
      outs.append(out[:, (a - lo) * self.rows_out:(b - lo) * self.rows_out].to(self.devices[0]))
    return torch.cat(outs, dim=1)


class ModelHeightSplit:
  """A model whose analysis and synthesis (its `_analysis` and `_synthesis`)
  run as HeightSplits over `devices` inside `with split:`; everything else
  of the model runs as before, on its own device. The replicas are made
  once, so one object serves many calls."""

  def __init__(self, model: nn.Module, devices: Sequence):
    self.model = model
    self._split = (HeightSplit(model._analysis, devices), HeightSplit(model._synthesis, devices))
    self._whole = None

  def __enter__(self) -> nn.Module:
    self._whole = (self.model._analysis, self.model._synthesis)
    self.model._analysis, self.model._synthesis = self._split
    return self.model

  def __exit__(self, *exc) -> None:
    self.model._analysis, self.model._synthesis = self._whole
