"""Work that `tests/test_torch_tp.py` runs on each rank of a gloo `RankPool`:
module-level functions `fn(mesh, *args)` over numpy inputs, returning
numpy. A rank derives its own shard of each whole input (its tp heads and
columns, its sp tokens, its dp rows) from its place on the mesh. This
module imports no JAX (the rank processes do not load it)."""
import dataclasses

import numpy as np
import torch

from inferix_tpu_torch.core.config import EngineConfig
from inferix_tpu_torch.models.magi.dit import MagiModelConfig
from inferix_tpu_torch.models.wan.causal_dit import (dit_forward_inference, linear,
                                                     make_statics, precompute_crossattn_cache)
from inferix_tpu_torch.ops.rope import build_rope_tables
from inferix_tpu_torch.parallel import distributed_attention as tda
from inferix_tpu_torch.parallel import tensor_parallel as ttp
from inferix_tpu_torch.parallel.mesh import (column_shard, frame_shard, init_kv_cache_shard,
                                             row_shard, wan_param_shards)
from inferix_tpu_torch.pipeline.continuous import ContinuousBatcher
from inferix_tpu_torch.pipeline.magi import MagiPipeline, MagiRuntimeConfig
from inferix_tpu_torch.pipeline.semi_ar import SemiARGenerator
from inferix_tpu_torch.quant.api import magi_quantize_params_int8, quantize_params
from inferix_tpu_torch.utils.params import params_from_numpy

FP8 = torch.float8_e4m3fn


def _t(a: np.ndarray) -> torch.Tensor:
    t = torch.from_numpy(np.ascontiguousarray(a))
    return t.view(FP8) if t.dtype == torch.uint8 else t


def _part(x: torch.Tensor, n: int, i: int, dim: int) -> torch.Tensor:
    return x.tensor_split(n, dim=dim)[i]


def where(mesh):
    """(d, s, t) of the rank and the head group's index t sp + s."""
    return mesh.dp.rank, mesh.sp.rank, mesh.tp.rank, mesh.heads.rank


def head_order(mesh):
    """The global ranks of the head group in its order (an all-gather over
    it, which follows the tp-major order, not the group's sorted one)."""
    return [int(x) for x in mesh.heads.all_gather(torch.tensor([mesh.rank]))]


# --- the collectives of tensor_parallel.py ---

def collectives(mesh, lin, x, norm_x, norm_w, act_rows):
    """This rank's results of: each linear of `lin` (name -> numpy leaf)
    row-parallel on its input columns of x and column-parallel on its
    output columns (gelu folded into the row linear when the name ends in
    "_gelu"); the full-width RMS norm of its columns of norm_x; the tp
    act-quant of its columns of each act_rows[act] (silu_mul: its
    [gate_t | up_t])."""
    tp = mesh.tp
    out = {"row": {}, "column": {}, "quant": {}}
    xt = _t(x)
    x_loc = _part(xt, tp.size, tp.rank, -1)
    for name, leaf in lin.items():
        p = {k: _t(v) for k, v in leaf.items()}
        act = "gelu" if name.endswith("_gelu") else None
        out["row"][name] = ttp.row_linear(tp, row_shard(p, tp), x_loc, act).numpy()
        out["column"][name] = linear(column_shard(p, tp), xt).numpy()
    nx = _t(norm_x)
    out["norm"] = ttp.rms_norm_tp(tp, _part(nx, tp.size, tp.rank, -1),
                                  _part(_t(norm_w), tp.size, tp.rank, -1), 1e-6,
                                  nx.shape[-1]).numpy()
    for act, rows in act_rows.items():
        r = _t(rows).to(torch.bfloat16)
        if act == "silu_mul":
            f = r.shape[-1] // 2
            loc = torch.cat([_part(r[:, :f], tp.size, tp.rank, -1),
                             _part(r[:, f:], tp.size, tp.rank, -1)], dim=-1)
        else:
            loc = _part(r, tp.size, tp.rank, -1)
        q, s = ttp.quantize_rows_tp(tp, loc, None if act == "none" else act)
        out["quant"][act] = (q.numpy(), s.numpy())
    return where(mesh), out, mesh.bytes_by_group()


# --- the islands ---

def cso(mesh, q, fields, ranges, current_end, whole_window, head_major):
    """cso_chunk_attention on the rank's shards of q [B, nc, ct, Hq, D] (its
    tokens of each chunk, its tp heads) and of the token-major cache fields
    (its kv heads over (tp, sp), stored head-major when asked)."""
    sp, tp, heads = mesh.sp, mesh.tp, mesh.heads
    ql = _part(_part(_t(q), sp.size, sp.rank, 2), tp.size, tp.rank, 3)
    local = []
    for f in fields:
        f = _part(_t(f), heads.size, heads.rank, 2)
        if head_major:
            f = f.transpose(1, 2).contiguous().transpose(1, 2)
        local.append(f)
    out = tda.cso_chunk_attention(sp, ql, local, [tuple(r) for r in ranges], current_end,
                                  whole_window=whole_window)
    return where(mesh), out.numpy()


def head_island(mesh, q, k, v, kv_len, kv_tokens_sharded):
    """gqa_head_island on the rank's token shard of q [B, S, Hq, D] (its tp
    heads) and of k / v (token shards, or every token of its tp kv heads)."""
    sp, tp = mesh.sp, mesh.tp
    ql = frame_shard(sp, _part(_t(q), tp.size, tp.rank, 2), 1)
    kl, vl = (_part(_t(a), tp.size, tp.rank, 2) for a in (k, v))
    if kv_tokens_sharded:
        kl, vl = frame_shard(sp, kl, 1), frame_shard(sp, vl, 1)
    out = tda.gqa_head_island(sp, ql, kl, vl, kv_len=_t(kv_len),
                              kv_tokens_sharded=kv_tokens_sharded)
    return where(mesh), out.numpy()


def ulysses(mesh, q, k, v, live):
    """The Wan ulysses island over a written cache: q [B, S, H, D] (the
    rank's tokens, its tp heads), k / v [B, Smax, H, D] (its heads t sp + s)."""
    sp, tp, heads = mesh.sp, mesh.tp, mesh.heads
    ql = frame_shard(sp, _part(_t(q), tp.size, tp.rank, 2), 1)
    kl, vl = (_part(_t(a), heads.size, heads.rank, 2) for a in (k, v))
    mask = torch.arange(kl.shape[1]) < live
    out = tda.ulysses_cache_attention(sp, ql, kl, vl, mask, 1)
    return where(mesh), out.numpy()


# --- whole paths ---

def wan_generate(mesh, cfg_dict, params_np, ctx, noise, renoise, w8a8=False):
    """SemiARGenerator.generate on this rank, float32 (W8A8: the tree
    quantized first), fed the given renoise; returns the latents, the
    island, the bytes by group and the JAX formula's count."""
    cfg = EngineConfig.from_dict(cfg_dict)
    params = params_from_numpy(params_np, "cpu", torch.float32)
    if w8a8:
        params = quantize_params(params, cfg.quant)
    gen = SemiARGenerator(cfg, params, dtype=torch.float32, device="cpu", mesh=mesh)
    xattn = gen.encode_text_context(torch.from_numpy(ctx))
    lat, _ = gen.generate(torch.from_numpy(noise), xattn,
                          renoise=[[torch.from_numpy(r) for r in blk] for blk in renoise])
    return lat.numpy(), gen.sp_mode, mesh.bytes_by_group() if mesh else {}, gen.sp_comm_bytes


def wan_i2v_forwards(mesh, cfg_dict, params_np, ctx, clip, xs):
    """Two i2v forwards (t 999 then 0, the second over the first's cache)
    on this rank: its tp shard of the tree, its heads of the text and image
    K/V; returns the flows."""
    cfg = EngineConfig.from_dict(cfg_dict)
    m = cfg.model
    params = params_from_numpy(params_np, "cpu", torch.float32)
    if mesh is not None:
        params = wan_param_shards(params, mesh)
    st = make_statics(m, 1, 1, 8, 8, torch.float32, mesh=mesh,
                      sp_mode="ulysses" if mesh is not None else "none")
    xattn = precompute_crossattn_cache(params, m, torch.from_numpy(ctx),
                                       clip_features=torch.from_numpy(clip),
                                       tp=None if mesh is None else mesh.tp)
    cache = init_kv_cache_shard(st.spec, st.shard, "cpu")
    tables = build_rope_tables(m.head_dim, m.rope_max_seq_len, device="cpu")
    flows = []
    for i, (x, tval) in enumerate(zip(xs, (999.0, 0.0))):
        t = torch.full((1, 1), tval)
        flow, cache = dit_forward_inference(params, st, tables, torch.from_numpy(x), t,
                                            xattn, cache, i * st.geo.frame_seq)
        flows.append(flow.numpy())
    return flows


def wan_continuous(mesh, cfg_dict, params_np):
    """Two streams at unequal offsets (the JAX dryrun's phase 5 schedule):
    a admitted, a step; b admitted, two steps; returns each stream's blocks."""
    cfg = EngineConfig.from_dict(cfg_dict)
    gen = SemiARGenerator(cfg, params_from_numpy(params_np, "cpu", torch.float32),
                          dtype=torch.float32, device="cpu", mesh=mesh)
    bat = ContinuousBatcher(gen)
    m = cfg.model
    ctx = torch.linspace(-1, 1, cfg.runtime.batch_size * m.text_len * m.text_dim)
    bat.set_conditioning(gen.encode_text_context(
        ctx.reshape(cfg.runtime.batch_size, m.text_len, m.text_dim)))
    outs = {}
    bat.admit("a", num_frames=3, seed=1)
    for step in range(3):
        if step == 1:
            bat.admit("b", num_frames=2, seed=2)
        for rid, blk in bat.step():
            outs.setdefault(rid, []).append(blk.numpy())
    return outs


def magi_walk(mesh, cfg_kw, rt_kw, params_np, cap, mask, noise, chunk_num, w8a8=False):
    """MagiPipeline.generate_chunks on this rank (float32; W8A8: the tree
    through `magi_quantize_params_int8`), its noise draw replaced by
    `noise`; returns the chunks, the island and the bytes by group."""
    tcfg = MagiModelConfig(**cfg_kw)
    params = params_from_numpy(params_np, "cpu", torch.float32)
    if w8a8:
        params = magi_quantize_params_int8(params)
    pipe = MagiPipeline(tcfg, MagiRuntimeConfig(**rt_kw), params=params,
                        latent_h=noise.shape[2], latent_w=noise.shape[3], max_chunks=6,
                        dtype=torch.float32, device="cpu", mesh=mesh)
    pipe._draw_noise = lambda g, shape: torch.from_numpy(noise)
    chunks = [np.array(c) for _, c in pipe.generate_chunks(torch.from_numpy(cap),
                                                           torch.from_numpy(mask), chunk_num)]
    return (chunks, pipe.statics.sp_mode if mesh else "none",
            mesh.bytes_by_group() if mesh else {}, dataclasses.astuple(pipe.statics.shard))
