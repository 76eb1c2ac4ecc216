"""Rank processes for the sequence-parallel path: `RankPool` starts one
process a rank (multiprocessing "spawn"), each joins the process group
from `init_method` with the backend the caller names and holds its mesh;
`run(fn, *args)` calls the module-level function `fn(mesh, *args)` on every
rank and returns the ranks' results in rank order.

The pool is started once and reused: a rank process costs seconds to start
(importing torch, joining the group). A rank that raises, or a call past
its timeout, ends every rank and raises here with the rank's traceback.
"""
from __future__ import annotations

import multiprocessing as mp
import traceback
from typing import Any, Callable, List, Optional

import torch
import torch.distributed as dist

from ..core.config import ParallelConfig
from .mesh import make_mesh


def _rank_main(rank: int, size: int, backend: str, init_method: str, device: str,
               threads: Optional[int], conn) -> None:
    if threads:
        torch.set_num_threads(threads)
    if device.startswith("cuda"):
        torch.cuda.set_device(torch.device(device))
    mesh = make_mesh(ParallelConfig(sp=size), rank, backend, device, init_method)
    try:
        while True:
            msg = conn.recv()
            if msg is None:
                break
            fn, args = msg
            try:
                conn.send(("ok", fn(mesh, *args)))
            except BaseException:  # noqa: BLE001 - sent to the caller, which raises
                conn.send(("error", traceback.format_exc()))
                break
    finally:
        dist.destroy_process_group()


class RankPool:
    """`size` rank processes over `backend` ("gloo" or "nccl"), on `device`
    ("cpu", or "cuda:i"; under nccl rank r takes "cuda:r")."""

    def __init__(self, size: int, backend: str, init_method: str, device: str = "cuda",
                 threads: Optional[int] = None, timeout: float = 600.0):
        ctx = mp.get_context("spawn")
        self.size, self.timeout = size, timeout
        self._conns, self._procs = [], []
        for rank in range(size):
            dev = f"cuda:{rank}" if backend == "nccl" else device
            here, there = ctx.Pipe()
            p = ctx.Process(target=_rank_main, daemon=True,
                            args=(rank, size, backend, init_method, dev, threads, there))
            p.start()
            self._conns.append(here)
            self._procs.append(p)

    def run(self, fn: Callable, *args: Any) -> List[Any]:
        """fn(mesh, *args) on every rank; the results in rank order."""
        if not self._procs:
            raise RuntimeError("the rank pool is closed")
        for c in self._conns:
            c.send((fn, args))
        results, failure = [], None
        for rank, c in enumerate(self._conns):
            if not c.poll(self.timeout):
                failure = failure or f"rank {rank}: no result within {self.timeout} s"
                continue
            status, value = c.recv()
            if status != "ok":
                failure = failure or f"rank {rank}:\n{value}"
            results.append(value)
        if failure:
            self.close(kill=True)
            raise RuntimeError(f"{getattr(fn, '__name__', fn)} failed on the ranks: {failure}")
        return results

    def close(self, kill: bool = False) -> None:
        """End every rank (at once with kill) and wait for it."""
        for c, p in zip(self._conns, self._procs):
            if not kill and p.is_alive():
                try:
                    c.send(None)
                except (BrokenPipeError, OSError):
                    pass
        for p in self._procs:
            p.join(None if not kill else 1.0)
            if p.is_alive():
                p.terminate()
                p.join()
        self._conns, self._procs = [], []

    def __enter__(self) -> "RankPool":
        return self

    def __exit__(self, *exc) -> None:
        self.close(kill=exc[0] is not None)
