"""Rank-aware printing (port of `inferix_tpu/core/monitoring.py`'s
printing helpers, after `inferix/distributed/dist_utils.py:26-47`). The
process's rank is its `torch.distributed` rank, or 0 when no process group
is initialised. The JAX module's `EventPathTimer` has no counterpart here:
the port's timings are the spans of `profiling/profiler.py`.
"""
from __future__ import annotations

import torch


def _rank() -> int:
    dist = torch.distributed
    return dist.get_rank() if dist.is_available() and dist.is_initialized() else 0


def _world_size() -> int:
    dist = torch.distributed
    return dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1


def print_rank_0(*args, **kwargs) -> None:
    if _rank() == 0:
        print(*args, **kwargs)


def print_per_rank(*args, **kwargs) -> None:
    print(f"[rank {_rank()}/{_world_size()}]", *args, **kwargs)
