"""Wan2.1-T2V-1.3B sequence parallel over NCCL, one rank a card.

    python3 exp/sp_nccl.py [--sizes 2 4] [--blocks 2]

The seed-0 blocks of `chip_smoke.py` phase 36 (full width and depth, bf16
weights) on `sp` ranks, one process a card (`RankPool`, backend "nccl": no
host staging), in ulysses, ring_pass_q and ring_pass_kv over the bf16
cache and ring_pass_q over the head-major padded int8 cache. For each run
and rank: seconds a block (host clock after a synchronize), the B1 / B2 /
B4 launches a block, the bytes the rank sent, and its latents against the
single-card run on cuda:0 (relative error in norm). Needs as many cards as
the largest size.
"""
from __future__ import annotations

import argparse
import os
import sys
import tempfile

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import chip_smoke as c  # noqa: E402
from inferix_tpu_torch.core.config import ParallelConfig  # noqa: E402
from inferix_tpu_torch.parallel.launch import RankPool  # noqa: E402

RUNS = (("ulysses", "bf16"), ("ring_pass_q", "bf16"), ("ring_pass_kv", "bf16"),
        ("ring_pass_q", "int8"))


def config(mode: str, kv: str, size: int, blocks: int):
    cfg = c.main_path_config(blocks)
    if kv == "int8":
        cfg.quant.enabled = cfg.quant.quantize_kv_cache = True
        cfg.runtime.kv_head_major = cfg.runtime.kv_alloc_pad = True
    if size > 1:
        cfg.parallel = ParallelConfig(sp=size, sp_mode=mode)
    return cfg


def rank_run(mesh, mode: str, kv: str, blocks: int) -> dict:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    mesh.sent_bytes = mesh.staged_bytes = 0
    out, cache, gen = c.run_blocks(mesh.device, config(mode, kv, mesh.size, blocks), mesh)
    del cache, gen
    torch.cuda.empty_cache()
    return out


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--sizes", type=int, nargs="+", default=[2, 4])
    ap.add_argument("--blocks", type=int, default=2)
    ap.add_argument("--backend", default="nccl", choices=("nccl", "gloo"))
    args = ap.parse_args()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda:0")
    smi = c.device_phase(dev)
    torch.cuda.set_device(dev)
    print(f"cards: {torch.cuda.device_count()}", flush=True)
    c._build.build(c.LIBRARIES)
    for name in c.LIBRARIES:
        c._build.load_library(name)
    refs = {}
    for kv in ("bf16", "int8"):
        out, cache, gen = c.run_blocks(dev, config("none", kv, 1, args.blocks))
        refs[kv] = torch.from_numpy(out["latents"])
        print(f"single card {kv}: s a block {[round(s, 3) for s in out['secs']]}", flush=True)
        del cache, gen
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as tmp:
        for size in args.sizes:
            store = f"file://{os.path.join(tmp, f'store{size}')}"
            with RankPool(size, args.backend, store, device="cuda:0", threads=2,
                          timeout=900) as pool:
                for mode, kv in RUNS:
                    res = pool.run(rank_run, mode, kv, args.blocks)
                    for rank, r in enumerate(res):
                        err = c.rel_err(torch.from_numpy(r["latents"]), refs[kv])
                        print(f"sp {size} {args.backend} {mode} {kv} rank {rank}: s a block "
                              f"{[round(s, 3) for s in r['secs']]}; launches a block "
                              f"{r['launches']}; bytes sent by the end of each block "
                              f"{r['sent']}, host-staged {r['staged']}; rel err to the "
                              f"single card {err:.3e}", flush=True)
    print(smi, flush=True)


if __name__ == "__main__":
    main()
