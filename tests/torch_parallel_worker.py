"""Rank body of tests/test_torch_parallel.py's data-parallel step (not a test
module): it imports torch and the port only, so a spawned rank starts fast.

One rank of a gloo group on the CPU builds the port's model with the given
flax-path params, takes one train step through train_lib.make_train_step in
the group on its rows of the global batch and the given global noise, and
rank 0 saves the params and the step's global-mean metrics to `out_path`.
With sync=False the loss is called past DDP (FrameLoss alone), so each rank
steps on its own gradients: the control that shows the comparison sees it.
"""

import torch

from shallow_ntc_tpu_torch import params as params_lib
from shallow_ntc_tpu_torch import train_lib
from shallow_ntc_tpu_torch.models import families
from shallow_ntc_tpu_torch.parallel import distributed, mesh


def dp_step(rank, world, coordinator, model_config, optimizer_config, flat, batch, noise,
            out_path, sync=True):
  if not sync:
    mesh.data_parallel = mesh.FrameLoss
  distributed.initialize(coordinator, world, rank, device="cpu")
  try:
    model, _ = families.build_model(model_config, "mshyper")
    params_lib.load_params(model, flat)
    state, lr_fn = train_lib.create_train_state(model.train(), optimizer_config)
    step = train_lib.make_train_step(model, state.optimizer, lr_fn)
    start, stop = distributed.local_batch_slice(batch.shape[0])
    metrics = step(state, torch.from_numpy(batch[start:stop]),
                   noise=tuple(torch.from_numpy(n) for n in noise))
    metrics = distributed.mean_over_processes(metrics)
    if distributed.is_primary():
      torch.save({"model": model.state_dict(), "metrics": metrics, "step": state.step}, out_path)
  finally:
    distributed.shutdown()
