"""Wan2.1-T2V-1.3B over NCCL, one rank a card: sequence, tensor and data
parallel layouts against one card, and MAGI-4.5B's cso island.

    python3 exp/sp_nccl.py [--sp 1 2 4] [--tp 1 2 4] [--dp 1 2] [--blocks 2] [--magi]

Every layout dp x sp x tp of the given sizes with more than one rank and no
more ranks than cards runs the seed-0 blocks of `chip_smoke.py` phase 36
(full width and depth, bf16 weights): at sp > 1 in ulysses, ring_pass_q and
ring_pass_kv over the bf16 cache and ring_pass_q over the head-major padded
int8 cache; at sp 1 in the ulysses island (tp-only) or none; at dp > 1 over
B = dp rows. All the layouts share one `RankPool` of the largest world
(backend "nccl": no host staging; a smaller layout leaves ranks idle). For
each run and rank: seconds a block (host clock after a synchronize), the B1
/ B2 / B4 launches a block, the bytes each group sent, and its latents
against the single-card run on cuda:0 (relative error in norm). --magi adds
phase 37's MAGI-4.5B 2-chunk window forward at cso tp 2 x sp 2 against one
card. Needs as many cards as the largest layout.
"""
from __future__ import annotations

import argparse
import itertools
import os
import sys
import tempfile

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import chip_smoke as c  # noqa: E402
from inferix_tpu_torch.core.config import ParallelConfig  # noqa: E402
from inferix_tpu_torch.parallel.launch import RankPool  # noqa: E402

SP_RUNS = (("ulysses", "bf16"), ("ring_pass_q", "bf16"), ("ring_pass_kv", "bf16"),
           ("ring_pass_q", "int8"))


def config(layout: ParallelConfig, mode: str, kv: str, blocks: int):
    cfg = c.main_path_config(blocks)
    if kv == "int8":
        cfg.quant.enabled = cfg.quant.quantize_kv_cache = True
        cfg.runtime.kv_head_major = cfg.runtime.kv_alloc_pad = True
    cfg.runtime.batch_size = layout.dp
    cfg.parallel = ParallelConfig(dp=layout.dp, sp=layout.sp, tp=layout.tp, sp_mode=mode)
    return cfg


def rank_run(mesh, layout: ParallelConfig, mode: str, kv: str, blocks: int) -> dict:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    mesh.reset_bytes()
    out, cache, gen = c.run_blocks(mesh.device, config(layout, mode, kv, blocks), mesh)
    out["bytes"] = mesh.bytes_by_group()
    del cache, gen
    torch.cuda.empty_cache()
    return out


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--sp", "--sizes", type=int, nargs="+", default=[1, 2, 4])
    ap.add_argument("--tp", type=int, nargs="+", default=[1])
    ap.add_argument("--dp", type=int, nargs="+", default=[1])
    ap.add_argument("--blocks", type=int, default=2)
    ap.add_argument("--magi", action="store_true")
    ap.add_argument("--backend", default="nccl", choices=("nccl", "gloo"))
    args = ap.parse_args()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda:0")
    smi = c.device_phase(dev)
    torch.cuda.set_device(dev)
    cards = torch.cuda.device_count()
    print(f"cards: {cards}", flush=True)
    c._build.build(c.LIBRARIES)
    for name in c.LIBRARIES:
        c._build.load_library(name)
    layouts = [ParallelConfig(dp=d, sp=s, tp=t)
               for d, s, t in itertools.product(args.dp, args.sp, args.tp)
               if 1 < d * s * t <= (cards if args.backend == "nccl" else 64)]
    refs = {}
    for kv, batch in {("bf16", lay.dp) for lay in layouts} | {("int8", 1)}:
        out, cache, gen = c.run_blocks(dev, config(ParallelConfig(dp=batch), "auto", kv,
                                                   args.blocks))
        refs[kv, batch] = torch.from_numpy(out["latents"])
        print(f"single card {kv} B={batch}: s a block {[round(s, 3) for s in out['secs']]}",
              flush=True)
        del cache, gen
    magi_ref = c.magi_tp_forward(dev, "4.5B cso tp2 x sp2") if args.magi else None
    c._MAGI_TREES.clear()
    torch.cuda.empty_cache()
    world = max([lay.dp * lay.sp * lay.tp for lay in layouts] + [4 if args.magi else 1])
    with tempfile.TemporaryDirectory() as tmp:
        store = f"file://{os.path.join(tmp, 'store')}"
        with RankPool(world, args.backend, store, device="cuda:0", threads=2,
                      timeout=900) as pool:
            for lay in layouts:
                runs = SP_RUNS if lay.sp > 1 else (("ulysses", "bf16"),)
                for mode, kv in runs:
                    res = [r for r in pool.run(rank_run, lay, mode, kv, args.blocks, layout=lay)
                           if r is not None]
                    ref = refs[kv, lay.dp if kv == "bf16" else 1]
                    for rank, r in enumerate(res):
                        err = c.rel_err(torch.from_numpy(r["latents"]), ref)
                        print(f"dp {lay.dp} sp {lay.sp} tp {lay.tp} {args.backend} {mode} {kv} "
                              f"rank {rank}: s a block {[round(s, 3) for s in r['secs']]}; "
                              f"launches a block {r['launches']}; bytes (sent, staged) by "
                              f"group {r['bytes']}; rel err to the single card {err:.3e}",
                              flush=True)
            if args.magi:
                res = [r for r in pool.run(c.magi_tp_rank_run, "4.5B cso tp2 x sp2",
                                           layout=ParallelConfig(sp=2, tp=2)) if r is not None]
                for rank, r in enumerate(res):
                    print(f"magi-4.5B cso tp 2 x sp 2 {args.backend} rank {rank}: "
                          f"{r['secs']:.3f} s (one card {magi_ref['secs']:.3f}); rel err "
                          f"{c.rel_err(r['vel'], magi_ref['vel']):.3e}; launches "
                          f"{r['launches']}; bytes {r['bytes']}", flush=True)
    print(smi, flush=True)


if __name__ == "__main__":
    main()
