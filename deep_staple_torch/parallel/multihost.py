"""Processes of one data- or tensor-parallel job: the launch, each rank's
rows, and rank 0's state on every rank.

The counterpart of `deep_staple_tpu/parallel/multihost.py`. JAX joins a
multi-host job through its coordination service and assembles global arrays
from each host's rows; here every rank is one process with one device, in a
`torch.distributed` process group, and feeds its own rows of each global
batch to the same step (`parallel/mesh.py::DataGroup`).

The launch takes the JAX CLI's flags (`--dist-num-processes`,
`--dist-process-id`, `--dist-coordinator` as `host:port`,
`tcp://host:port` or `file:///path`); where a flag is unset it reads
torchrun's environment (`WORLD_SIZE`, `RANK`, `MASTER_ADDR` and
`MASTER_PORT`, `LOCAL_RANK`, `LOCAL_WORLD_SIZE`), where JAX reads the TPU
metadata. Rank r runs on `cuda:(local rank mod visible cards)`, or on the
CPU when asked. The backend is NCCL when each local rank has a card of its
own and gloo when ranks share one (NCCL refuses two ranks on one device)
or run on the CPU; tensors stay on their device either way. With a model
axis of M (`parallel/tensor.py`) the job is D x M processes, a grid of
ranks (`parallel/mesh.py::make_grid`).
"""

from __future__ import annotations

import datetime
import os
from pathlib import Path
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from .mesh import DataGroup


def host_shard_indices(global_indices, num_hosts: int, host_id: int) -> np.ndarray:
    """The contiguous slice of a global batch-index array this host feeds
    (`multihost.py:23-37`): row blocks in rank order, as `DataGroup.rows`
    cuts the global batch. The global length must divide by num_hosts."""
    global_indices = np.asarray(global_indices)
    n = len(global_indices)
    if n % num_hosts:
        raise ValueError(f"global batch of {n} does not divide over {num_hosts} hosts")
    per = n // num_hosts
    return global_indices[host_id * per : (host_id + 1) * per]


def _env_int(name: str) -> Optional[int]:
    v = os.environ.get(name)
    return int(v) if v not in (None, "") else None


def launch_settings(num_processes=None, process_id=None, coordinator=None):
    """-> (world size, rank, init method), each from its flag or else from
    torchrun's environment. Raises ValueError naming what is missing."""
    n = num_processes if num_processes is not None else _env_int("WORLD_SIZE")
    rank = process_id if process_id is not None else _env_int("RANK")
    if coordinator is None and os.environ.get("MASTER_ADDR"):
        coordinator = f"{os.environ['MASTER_ADDR']}:{os.environ.get('MASTER_PORT', '29500')}"
    missing = [name for name, v in (("--dist-num-processes (or WORLD_SIZE)", n),
                                    ("--dist-process-id (or RANK)", rank),
                                    ("--dist-coordinator (or MASTER_ADDR)", coordinator))
               if v is None]
    if missing:
        raise ValueError(f"a {n or 'multi'}-process run needs {', '.join(missing)}")
    if not 0 <= rank < n:
        raise ValueError(f"process id {rank} outside 0..{n - 1}")
    if "://" not in coordinator:
        coordinator = f"tcp://{coordinator}"
    if coordinator.startswith("file://") and not Path(coordinator[7:]).parent.is_dir():
        # The store's directory must exist, or the rendezvous waits forever.
        raise ValueError(f"{coordinator}: no directory {Path(coordinator[7:]).parent}")
    return n, rank, coordinator


def init_distributed(num_processes=None, process_id=None, coordinator=None, device=None,
                     timeout_s: float = 1800.0) -> DataGroup:
    """Join the job's default process group; -> this rank's DataGroup.

    `device` "cpu" runs the rank on the CPU (gloo); otherwise on
    `cuda:(local rank mod visible cards)`, made the current device, and
    without CUDA it raises; there local rank 0 builds the kernels
    (`ops/cuda_build.build_libraries`, a no-op where they are built) while
    the other ranks wait. Prints the rank, the device and the backend. A
    rendezvous that does not complete in `timeout_s` raises."""
    from ..core.device import resolve_device

    n, rank, init_method = launch_settings(num_processes, process_id, coordinator)
    local_rank = _env_int("LOCAL_RANK")
    local_rank = rank if local_rank is None else local_rank
    local_size = _env_int("LOCAL_WORLD_SIZE") or n
    if device is not None and torch.device(device).type == "cpu":
        dev, backend, cards = torch.device("cpu"), "gloo", 0
    else:
        resolve_device("cuda")  # raises without CUDA
        cards = torch.cuda.device_count()
        dev = resolve_device(f"cuda:{local_rank % cards}")
        torch.cuda.set_device(dev)
        backend = "nccl" if local_size <= cards else "gloo"
    dist.init_process_group(backend, init_method=init_method, world_size=n, rank=rank,
                            timeout=datetime.timedelta(seconds=timeout_s))
    data = DataGroup(rank=rank, size=n, device=dev, backend=backend)
    if dev.type == "cuda":
        # One nvcc run a host: local rank 0 builds the kernels (a no-op where
        # the launcher built them) while the others wait, then load them.
        if local_rank == 0:
            from ..ops.cuda_build import build_libraries

            build_libraries()
        data.barrier()
    why = ("CPU" if dev.type == "cpu" else
           f"{local_size} local ranks on {cards} visible card(s)"
           + (", shared" if backend == "gloo" else ", one each"))
    print(f"distributed: rank {rank} of {n} on {dev}, backend {backend} ({why})", flush=True)
    return data


def coordination_barrier(data: Optional[DataGroup]) -> None:
    """Block until every rank gets here (`multihost.py:55-75`): the driver
    calls it before the first step of each step variant, so that a rank
    still loading data or building its step does not leave the others
    waiting inside a collective."""
    if data is not None:
        data.barrier()


def replicate_to_mesh(state, data: Optional[DataGroup]):
    """Rank 0's train state on every rank, in place (`multihost.py:40-52`):
    the model's parameters and buffers, the optimizer's state, the DP vector
    and its SparseAdam state. Every rank built the same state from the same
    seed; this makes it so bit for bit, whatever each rank restored. `data`
    is the whole world's group; with a model axis the state is the full,
    unsharded one, of which each rank then takes its shard
    (`parallel/tensor.py::shard_train_state`)."""
    if data is None:
        return state
    tensors = list(state.model.state_dict().values())
    for p in state.model.parameters():
        tensors += [v for v in state.optimizer.state.get(p, {}).values()
                    if isinstance(v, torch.Tensor)]
    if state.dp_params is not None:
        tensors += [state.dp_params, *state.dp_opt_state]
    with torch.no_grad():
        for t in tensors:
            data.broadcast_(t)
    return state


def gather_host(values, data: DataGroup) -> np.ndarray:
    """Every rank's `values` (a small array, the same shape on each) ->
    (ranks, ...) numpy array on every rank."""
    t = torch.as_tensor(np.asarray(values))[None].to(data.device)
    return data.gather_rows(t).cpu().numpy()


def check_resume_agrees(epx_start: int, ckpt_found: bool, mdl_save_prefix,
                        data: Optional[DataGroup]) -> None:
    """Raise unless every rank resumes at the same epoch from the same kind
    of start (`deep_staple_tpu/train/driver.py:322-337`): only rank 0 writes
    checkpoints, so every rank must see them on shared storage."""
    if data is None:
        return
    seen = gather_host(np.array([epx_start, int(ckpt_found)], np.int64), data)
    if not (seen == seen[0]).all():
        raise RuntimeError(
            f"multi-process resume state differs across ranks (per rank [epx_start, "
            f"ckpt_found] = {seen.tolist()}): mdl_save_prefix={str(mdl_save_prefix)!r} must "
            "be shared storage visible to every rank")
