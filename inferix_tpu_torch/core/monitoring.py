"""Lightweight monitoring utilities (port of `inferix_tpu/core/monitoring.py`).

Parity with `inferix/core/monitoring/timer.py:6-61` (EventPathTimer: named
timestamps for ordering events across processes) and the rank-0 printing
helpers of `inferix/distributed/dist_utils.py:26-47`. The process's rank is
its `torch.distributed` rank, or 0 when no process group is initialised.
"""
from __future__ import annotations

import time
from typing import Dict, List, Optional, Tuple

import torch


def _rank() -> int:
    dist = torch.distributed
    return dist.get_rank() if dist.is_available() and dist.is_initialized() else 0


def _world_size() -> int:
    dist = torch.distributed
    return dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1


class EventPathTimer:
    """Records named wall-clock timestamps. `record` does not wait for the
    device; `synced_record` first waits for the card's queued work (when a
    card is in use) and also stamps the process's rank, so that the traces
    of several processes can be aligned."""

    def __init__(self):
        self.events: List[Tuple[str, float, int]] = []
        self._t0 = time.monotonic()

    def record(self, name: str) -> None:
        self.events.append((name, time.monotonic() - self._t0, -1))

    def synced_record(self, name: str) -> None:
        if torch.cuda.is_available() and torch.cuda.is_initialized():
            torch.cuda.synchronize()
        self.events.append((name, time.monotonic() - self._t0, _rank()))

    def spans(self) -> Dict[str, float]:
        """Durations between consecutive events."""
        out = {}
        for (a, ta, _), (b, tb, _) in zip(self.events, self.events[1:]):
            out[f"{a}->{b}"] = tb - ta
        return out

    def reset(self) -> None:
        self.events.clear()
        self._t0 = time.monotonic()


_timer: Optional[EventPathTimer] = None


def event_path_timer() -> EventPathTimer:
    """The process's shared timer."""
    global _timer
    if _timer is None:
        _timer = EventPathTimer()
    return _timer


def print_rank_0(*args, **kwargs) -> None:
    if _rank() == 0:
        print(*args, **kwargs)


def print_per_rank(*args, **kwargs) -> None:
    print(f"[rank {_rank()}/{_world_size()}]", *args, **kwargs)
