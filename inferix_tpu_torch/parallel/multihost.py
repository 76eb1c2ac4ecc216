"""Multi-host start-up: `torch.distributed` from the environment and the
global mesh (port of `inferix_tpu/parallel/multihost.py`).

The JAX package calls `jax.distributed.initialize` once (coordinator and
process id from explicit arguments, its env names, or the TPU pod's
metadata) and lays one global mesh over `jax.devices()`. The port runs one
process a rank: `initialize_multihost` joins the default process group, and
`make_global_mesh` checks the layout against the world and returns this
rank's `Mesh`. Where JAX auto-detects a pod, the port reads torch's own
launcher env (`torchrun`: RANK, WORLD_SIZE, MASTER_ADDR / MASTER_PORT,
LOCAL_RANK) through `env://`.
"""
from __future__ import annotations

import os
from typing import Optional

import torch
import torch.distributed as dist

from ..core.config import ParallelConfig
from .mesh import Mesh, make_mesh


def local_device() -> torch.device:
    """This process's device: cuda:LOCAL_RANK on a machine with cards (the
    process id modulo the cards when LOCAL_RANK is not set), else the CPU."""
    if not torch.cuda.is_available():
        return torch.device("cpu")
    local = os.environ.get("LOCAL_RANK")
    if local is None:
        local = dist.get_rank() % torch.cuda.device_count() if dist.is_initialized() else 0
    return torch.device("cuda", int(local))


def initialize_multihost(coordinator_address: Optional[str] = None,
                         num_processes: Optional[int] = None,
                         process_id: Optional[int] = None,
                         backend: Optional[str] = None) -> bool:
    """Join the default process group for a multi-process run.

    Resolution order: explicit arguments, then the JAX package's env names
    COORDINATOR_ADDRESS ("host:port") / NUM_PROCESSES / PROCESS_ID, then
    torch's launcher env (RANK / WORLD_SIZE / MASTER_ADDR, `env://`).
    Returns False for a single-process run, True once initialised (also
    when it already was). backend: "nccl" on a machine with cards, "gloo"
    otherwise, unless named (gloo lets several processes share a card)."""
    if dist.is_initialized():
        return True
    coordinator_address = coordinator_address or os.environ.get("COORDINATOR_ADDRESS")
    if num_processes is None and "NUM_PROCESSES" in os.environ:
        num_processes = int(os.environ["NUM_PROCESSES"])
    if process_id is None and "PROCESS_ID" in os.environ:
        process_id = int(os.environ["PROCESS_ID"])
    if coordinator_address is not None:
        init_method = f"tcp://{coordinator_address}"
    elif "MASTER_ADDR" in os.environ:
        init_method = "env://"
        if num_processes is None and "WORLD_SIZE" in os.environ:
            num_processes = int(os.environ["WORLD_SIZE"])
        if process_id is None and "RANK" in os.environ:
            process_id = int(os.environ["RANK"])
    else:
        init_method = None
    if num_processes is None or num_processes <= 1:
        return False
    if init_method is None or process_id is None:
        raise ValueError(f"{num_processes} processes need a coordinator address and a "
                         f"process id (COORDINATOR_ADDRESS / PROCESS_ID, or RANK / "
                         f"MASTER_ADDR)")
    backend = backend or ("nccl" if torch.cuda.is_available() else "gloo")
    if backend == "nccl":
        torch.cuda.set_device(local_device())
    dist.init_process_group(backend, init_method=init_method, rank=process_id,
                            world_size=num_processes)
    return True


def make_global_mesh(cfg: ParallelConfig, device=None) -> Optional[Mesh]:
    """This rank's mesh over every process of the job (one rank a process),
    after the world-size check of the reference's dist_init. device: the
    rank's device (default `local_device()`)."""
    world = dist.get_world_size() if dist.is_initialized() else 1
    if cfg.world_size != world:
        raise ValueError(
            f"parallel config (dp={cfg.dp}, sp={cfg.sp}, tp={cfg.tp}, pp={cfg.pp}) needs "
            f"{cfg.world_size} devices but the job has {world} (processes={world})")
    device = device if device is not None else local_device()
    backend = dist.get_backend() if dist.is_initialized() else (
        "nccl" if torch.device(device).type == "cuda" else "gloo")
    return make_mesh(cfg, process_index(), backend, device)


def process_index() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def is_coordinator() -> bool:
    return process_index() == 0
