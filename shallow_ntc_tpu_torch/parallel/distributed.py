"""Multi-process data plumbing over torch.distributed (mirrors
shallow_ntc_tpu/parallel/distributed.py).

One process per device. `initialize()` joins a process group over TCP;
then every process runs the same training program: the same config, the
same data seed (so the global batch order is a pure function of the seed)
and the same model init. Each process decodes the whole global batch and
keeps its rows (`shard_batches`); DistributedDataParallel averages the
gradients over the group (parallel/mesh.py). `is_primary()` gates workdir
bookkeeping to rank 0.

The helpers act on torch's default group when one is initialized, as
JAX's read jax.process_count() and jax.process_index(); without one they
describe a single process.
"""

from typing import Dict, Iterator, Mapping, Optional

import numpy as np
import torch
import torch.distributed as dist


def initialize(coordinator_address: str, num_processes: int, process_id: int,
               backend: Optional[str] = None, device: Optional[str] = "cuda") -> None:
  """Join (or start) a group of `num_processes` ranks, this one rank
  `process_id`, with rank 0 listening on coordinator_address "host:port".

  The backend is nccl for a CUDA device and gloo for the CPU unless
  `backend` names one: gloo lets two ranks share one card, which nccl
  refuses.
  """
  if backend is None:
    backend = "nccl" if torch.device(device or "cuda").type == "cuda" else "gloo"
  dist.init_process_group(backend, init_method=f"tcp://{coordinator_address}",
                          world_size=num_processes, rank=process_id)


def shutdown() -> None:
  """Leave the default group (the end of a process's training)."""
  if dist.is_initialized():
    dist.destroy_process_group()


def in_group() -> bool:
  """True when the default group exists: the data-parallel path."""
  return dist.is_available() and dist.is_initialized()


def process_count() -> int:
  return dist.get_world_size() if in_group() else 1


def process_index() -> int:
  return dist.get_rank() if in_group() else 0


def is_multiprocess() -> bool:
  return process_count() > 1


def is_primary() -> bool:
  """True on the process that owns bookkeeping (workdir files, writers)."""
  return process_index() == 0


def barrier() -> None:
  if in_group():
    dist.barrier()


def broadcast_from_primary(value):
  """Rank 0's `value` on every rank (a picklable object; the others pass
  anything, None say)."""
  if not in_group():
    return value
  box = [value]
  dist.broadcast_object_list(box, src=0)
  return box[0]


def local_batch_slice(global_batchsize: int):
  """This process's [start, stop) rows of a globally-seeded batch."""
  count = process_count()
  if global_batchsize % count:
    raise ValueError(
        f"global batchsize {global_batchsize} not divisible by process count {count}")
  per = global_batchsize // count
  start = process_index() * per
  return start, start + per


def shard_batches(batches) -> Iterator:
  """Slice each globally-identical host batch to this process's rows.

  The data stream must be seeded identically on every process (the default:
  seeds are pure functions of the config), so every process sees the same
  global batch and keeps a disjoint slice of it.
  """
  if not is_multiprocess():
    yield from batches
    return
  for batch in batches:
    start, stop = local_batch_slice(batch.shape[0])
    yield batch[start:stop]


def mean_over_processes(scalars: Mapping[str, float]) -> Dict[str, float]:
  """Each scalar's mean over the group's processes (float64 all-reduce; a
  CUDA tensor under nccl, a CPU one under gloo); every rank passes the
  same keys. With equal shards the mean of per-process means is the mean
  over the global batch."""
  if not is_multiprocess():
    return {k: float(v) for k, v in scalars.items()}
  keys = list(scalars)  # every rank builds its dict in the same order
  device = (torch.device("cuda", torch.cuda.current_device())
            if dist.get_backend() == "nccl" else torch.device("cpu"))
  values = torch.tensor([float(scalars[k]) for k in keys], dtype=torch.float64, device=device)
  dist.all_reduce(values)
  values = (values / process_count()).cpu().numpy()
  return {k: float(v) for k, v in zip(keys, np.asarray(values))}
