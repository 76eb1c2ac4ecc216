"""Rank processes for the parallel paths: `RankPool` starts one process a
rank (multiprocessing "spawn"), each joins the process group from
`init_method` with the backend the caller names and holds its mesh
(`parallel.mesh.Mesh`); `run(fn, *args)` calls the module-level function
`fn(mesh, *args)` on every rank and returns the ranks' results in rank
order. A pool of n ranks hosts every layout of at most n ranks:
`run(fn, *args, layout=ParallelConfig(...))` hands fn that layout's mesh,
whose groups each rank builds at its first use (every rank the same
groups in the same order) and keeps; the ranks past a smaller layout's
world return None without calling fn.

The pool is started once and reused: a rank process costs seconds to start
(importing torch, joining the group). A rank that raises, or a call past
its timeout, ends every rank and raises here with the rank's traceback.
"""
from __future__ import annotations

import multiprocessing as mp
import traceback
from typing import Any, Callable, List, Optional, Tuple, Union

import torch
import torch.distributed as dist

from ..core.config import ParallelConfig
from .mesh import make_mesh


def _key(cfg: ParallelConfig) -> Tuple[int, int, int, int]:
    return cfg.dp, cfg.sp, cfg.tp, cfg.pp


def _rank_main(rank: int, layout: ParallelConfig, backend: str, init_method: str,
               device: str, threads: Optional[int], conn) -> None:
    if threads:
        torch.set_num_threads(threads)
    if device.startswith("cuda"):
        torch.cuda.set_device(torch.device(device))
    meshes = {_key(layout): make_mesh(layout, rank, backend, device, init_method)}
    try:
        while True:
            msg = conn.recv()
            if msg is None:
                break
            fn, args, cfg = msg
            try:
                cfg = cfg or layout
                if _key(cfg) not in meshes:
                    meshes[_key(cfg)] = make_mesh(cfg, rank, backend, device)
                mesh = meshes[_key(cfg)]
                conn.send(("ok", None if mesh is None else fn(mesh, *args)))
            except BaseException:  # noqa: BLE001 - sent to the caller, which raises
                conn.send(("error", traceback.format_exc()))
                break
    finally:
        dist.destroy_process_group()


class RankPool:
    """The ranks of `layout` (a ParallelConfig, or an int: that many sp
    ranks) over `backend` ("gloo" or "nccl"), on `device` ("cpu", or
    "cuda:i"; under nccl rank r takes "cuda:r")."""

    def __init__(self, layout: Union[int, ParallelConfig], backend: str, init_method: str,
                 device: str = "cuda", threads: Optional[int] = None, timeout: float = 600.0):
        if isinstance(layout, int):
            layout = ParallelConfig(sp=layout)
        ctx = mp.get_context("spawn")
        self.layout, self.timeout = layout, timeout
        self.size = layout.world_size
        self._conns, self._procs = [], []
        for rank in range(self.size):
            dev = f"cuda:{rank}" if backend == "nccl" else device
            here, there = ctx.Pipe()
            p = ctx.Process(target=_rank_main, daemon=True,
                            args=(rank, layout, backend, init_method, dev, threads, there))
            p.start()
            self._conns.append(here)
            self._procs.append(p)

    def run(self, fn: Callable, *args: Any,
            layout: Optional[ParallelConfig] = None) -> List[Any]:
        """fn(mesh, *args) on every rank of `layout` (default: the pool's;
        at most the pool's world), mesh the rank's; the results in rank
        order, None from a rank past the layout."""
        if not self._procs:
            raise RuntimeError("the rank pool is closed")
        if layout is not None and layout.world_size > self.size:
            raise ValueError(f"a layout of {layout.world_size} ranks on a pool of {self.size}")
        for c in self._conns:
            c.send((fn, args, layout))
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
