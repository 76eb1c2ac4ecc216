"""The cost of an exchange between ranks that share one card over gloo.

    python3 exp/gloo_staging.py [--ranks 2 4] [--iters 10]

gloo exchanges host tensors, so `SPMesh` stages every exchange of CUDA
tensors through host copies (`host_staging`). For one all-reduce of a
[4680, 1536] bf16 tensor (a Wan o / fc2 partial at tp 2) and one
all-to-all of the same bytes (a ulysses exchange), on 2 and 4 ranks of
cuda:0: milliseconds a call (median of --iters, host clock, after a
synchronize) of gloo's own all-reduce on host tensors; of the mesh's
all-reduce (gloo's, staged), of an all-gather followed by a sum on the card
(the alternative the mesh does not take), and of the mesh's all-to-all,
each with the staging through page-locked buffers (the mesh's) or, for
the comparison, pageable host memory. Prints the card's name and power limit last.
"""
from __future__ import annotations

import argparse
import os
import statistics
import sys
import tempfile
import time

import torch
import torch.distributed as dist

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import chip_smoke as c  # noqa: E402
from inferix_tpu_torch.core.config import ParallelConfig  # noqa: E402
from inferix_tpu_torch.parallel.launch import RankPool  # noqa: E402
from inferix_tpu_torch.parallel.mesh import SPMesh  # noqa: E402

SHAPE = (4680, 1536)


class PageableMesh(SPMesh):
    """The mesh's group with the staging through pageable host memory (the
    staging before page-locked buffers), for the comparison."""

    def _out(self, t):
        if self.host_staging:
            self.staged_bytes += t.numel() * t.element_size()
            return t.cpu()
        return t

    def _empty_like(self, shape, dtype):
        if self.host_staging:
            return torch.empty(shape, dtype=dtype)
        return super()._empty_like(shape, dtype)


def rank_times(mesh, iters: int) -> dict:
    """ms a call of each exchange and staging, this rank's clock."""
    pinned = mesh.sp
    pageable = PageableMesh(pinned.rank, pinned.size, pinned.backend, pinned.device,
                            group=pinned.group)
    host = torch.randn(*SHAPE).to(torch.bfloat16)
    card = host.to(mesh.device)
    cases = {("host tensors", "gloo all_reduce"):
             lambda: dist.all_reduce(host.clone(), group=pinned.group)}
    for staging, g in (("pageable", pageable), ("pinned", pinned)):
        cases[staging, "mesh all_reduce"] = lambda g=g: g.all_reduce(card, "sum")
        cases[staging, "all-gather + sum on the card"] = (
            lambda g=g: torch.stack(g.all_gather(card)).sum(0, dtype=torch.float32))
        cases[staging, "all_to_all"] = lambda g=g: g.all_to_all(list(card.chunk(g.size)))
    out = {}
    for key, fn in cases.items():
        times = []
        for i in range(iters + 2):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            if i >= 2:
                times.append((time.perf_counter() - t0) * 1e3)
        out[key] = statistics.median(times)
    return out


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--ranks", type=int, nargs="+", default=[2, 4])
    ap.add_argument("--iters", type=int, default=10)
    args = ap.parse_args()
    smi = c.device_phase(torch.device("cuda:0"))
    mb = SHAPE[0] * SHAPE[1] * 2 / 1e6
    with tempfile.TemporaryDirectory() as tmp:
        for n in args.ranks:
            with RankPool(n, "gloo", f"file://{os.path.join(tmp, f's{n}')}", device="cuda:0",
                          threads=2, timeout=600) as pool:
                res = pool.run(rank_times, args.iters, layout=ParallelConfig(sp=n))
            for (staging, name), ms in sorted(res[0].items()):
                worst = max(r[staging, name] for r in res)
                print(f"{n} ranks, {name} of {mb:.1f} MB, {staging}: {ms:.3f} ms on rank 0, "
                      f"{worst:.3f} ms the slowest rank ({mb / worst:.3f} GB/s of the tensor)",
                      flush=True)
    print(smi, flush=True)


if __name__ == "__main__":
    main()
