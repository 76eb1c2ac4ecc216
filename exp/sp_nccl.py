"""Wan2.1-T2V-1.3B over NCCL, one rank a card: sequence, tensor, data and
pipeline parallel layouts against one card, MAGI-4.5B's cso island, and
the disaggregated stream decode.

    python3 exp/sp_nccl.py [--sp 1 2 4] [--tp 1 2 4] [--dp 1 2] [--pp 1 2] [--blocks 2]
                           [--magi] [--decode]

Every layout dp x sp x tp x pp of the given sizes with more than one rank,
no more ranks than cards and not both sp and pp above 1 runs the seed-0
blocks of `chip_smoke.py` phase 36
(full width and depth, bf16 weights): at sp > 1 in ulysses, ring_pass_q and
ring_pass_kv over the bf16 cache and ring_pass_q over the head-major padded
int8 cache; at sp 1 in the ulysses island (tp-only) or none; at dp > 1 over
B = dp rows; at pp > 1 as a pipeline of B = 2 dp rows (2 microbatches, no
island: tp runs inside each stage). All the layouts share one `RankPool` of the largest world
(backend "nccl": no host staging; a smaller layout leaves ranks idle). For
each run and rank: seconds a block (host clock after a synchronize), the B1
/ B2 / B4 launches a block, the bytes each group sent, and its latents
against the single-card run on cuda:0 (relative error in norm). --magi adds
phase 37's MAGI-4.5B 2-chunk window forward at cso tp 2 x sp 2 against one
card. --decode runs `chip_smoke.py` phase 38's 2-segment TRUE_STREAMING
pipeline (W8A8, 9-frame segments) on cuda:0 with the block decode local and
then on cuda:1 (`set_disaggregated_decode`), in turns, twice: the seconds
between the stream's blocks on the host clock, the wall after both cards
synchronize, and the pixels against the local run's. Needs as many cards as
the largest layout (--decode: 2).
"""
from __future__ import annotations

import argparse
import itertools
import os
import sys
import tempfile
import time

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import chip_smoke as c  # noqa: E402
from inferix_tpu_torch.core.config import ParallelConfig  # noqa: E402
from inferix_tpu_torch.parallel.launch import RankPool  # noqa: E402

SP_RUNS = (("ulysses", "bf16"), ("ring_pass_q", "bf16"), ("ring_pass_kv", "bf16"),
           ("ring_pass_q", "int8"))


def rows(layout: ParallelConfig) -> int:
    """The batch of a layout: a row a dp rank, two a dp rank under pp."""
    return layout.dp * (2 if layout.pp > 1 else 1)


def config(layout: ParallelConfig, mode: str, kv: str, blocks: int):
    cfg = c.main_path_config(blocks)
    if kv == "int8":
        cfg.quant.enabled = cfg.quant.quantize_kv_cache = True
        cfg.runtime.kv_head_major = cfg.runtime.kv_alloc_pad = True
    cfg.runtime.batch_size = rows(layout)
    cfg.parallel = ParallelConfig(dp=layout.dp, sp=layout.sp, tp=layout.tp, pp=layout.pp,
                                  sp_mode=mode)
    return cfg


def stream(dev: torch.device, decode_dev) -> tuple:
    """The 2-segment TRUE_STREAMING run, its block decode local
    (decode_dev None) or on decode_dev: (host seconds between the blocks'
    pixels, wall, the pixels on the host)."""
    cfg = c.pipeline_config()
    cfg.runtime.streaming_mode = c.StreamingMode.TRUE_STREAMING
    pipe = c.SelfForcingPipeline(cfg, text_encoder=c.StandInTextEncoder(dev), device=dev)
    pipe.setup()
    if decode_dev is not None:
        pipe.set_disaggregated_decode([decode_dev], tiles=1)
    got, marks = [], []

    def on_px(px):
        got.append(px)
        marks.append(time.perf_counter())

    torch.cuda.synchronize(dev)
    t1 = time.perf_counter()
    pipe.run_streaming_generation(["a red fox"], num_segments=2, stream_callback=on_px)
    for i in range(torch.cuda.device_count()):
        torch.cuda.synchronize(i)
    wall = time.perf_counter() - t1
    pixels = [px.assemble() if decode_dev is not None else px.float().cpu().numpy()
              for px in got]
    gaps = [b - a for a, b in zip([t1] + marks[:-1], marks)]
    del pipe
    torch.cuda.empty_cache()
    return gaps, wall, pixels


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
    ap.add_argument("--pp", type=int, nargs="+", default=[1])
    ap.add_argument("--blocks", type=int, default=2)
    ap.add_argument("--magi", action="store_true")
    ap.add_argument("--decode", action="store_true")
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
    layouts = [ParallelConfig(dp=d, sp=s, tp=t, pp=p)
               for d, s, t, p in itertools.product(args.dp, args.sp, args.tp, args.pp)
               if 1 < d * s * t * p <= (cards if args.backend == "nccl" else 64)
               and (s == 1 or p == 1)]
    refs = {}
    for kv, batch in {("bf16", rows(lay)) for lay in layouts} | {("int8", 1)}:
        out, cache, gen = c.run_blocks(dev, config(ParallelConfig(dp=batch), "auto", kv,
                                                   args.blocks))
        refs[kv, batch] = torch.from_numpy(out["latents"])
        print(f"single card {kv} B={batch}: s a block {[round(s, 3) for s in out['secs']]}",
              flush=True)
        del cache, gen
    magi_ref = c.magi_tp_forward(dev, "4.5B cso tp2 x sp2") if args.magi else None
    c._MAGI_TREES.clear()
    torch.cuda.empty_cache()
    if args.decode:
        runs = {}
        for turn, where in enumerate((None, "cuda:1", None, "cuda:1")):
            runs.setdefault(where, []).append(stream(dev, where))
            gaps, wall, _ = runs[where][-1]
            print(f"stream turn {turn}, decode on {where or 'cuda:0 (local)'}: s between blocks "
                  f"{[round(x, 3) for x in gaps]}; wall {wall:.3f} s", flush=True)
        local, remote = runs[None][0][2], runs["cuda:1"][0][2]
        diff = max(float(abs(a - b).max()) for a, b in zip(local, remote))
        print(f"stream: {len(remote)} blocks both ways, max |disaggregated - local| {diff:.3e}",
              flush=True)
    world = max([lay.world_size for lay in layouts] + [4 if args.magi else 1])
    with tempfile.TemporaryDirectory() as tmp:
        store = f"file://{os.path.join(tmp, 'store')}"
        with RankPool(world, args.backend, store, device="cuda:0", threads=2,
                      timeout=900) as pool:
            for lay in layouts:
                runs = (SP_RUNS if lay.sp > 1 else (("auto", "bf16"),) if lay.pp > 1
                        else (("ulysses", "bf16"),))
                for mode, kv in runs:
                    res = [r for r in pool.run(rank_run, lay, mode, kv, args.blocks, layout=lay)
                           if r is not None]
                    ref = refs[kv, rows(lay) if kv == "bf16" else 1]
                    for rank, r in enumerate(res):
                        err = c.rel_err(torch.from_numpy(r["latents"]), ref)
                        print(f"dp {lay.dp} sp {lay.sp} tp {lay.tp} pp {lay.pp} {args.backend} "
                              f"{mode} {kv} "
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
