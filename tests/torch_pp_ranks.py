"""Work that `tests/test_torch_pp.py` runs on each rank of a gloo `RankPool`:
module-level functions `fn(mesh, *args)` over numpy inputs, returning
numpy. A rank takes its stage's layers of each whole input itself. This
module imports no JAX (the rank processes do not load it)."""
import torch

from inferix_tpu_torch.models.magi.dit import MagiModelConfig, magi_forward, make_magi_statics
from inferix_tpu_torch.kvcache.cache import init_kv_cache
from inferix_tpu_torch.parallel.mesh import grid_place
from inferix_tpu_torch.parallel.pipeline_parallel import pp_pipeline, stage_layers
from inferix_tpu_torch.utils.params import params_from_numpy

import torch_tp_ranks


def where(mesh):
    """(d, s, t, p) of the rank, its stage and each group's (rank, size)."""
    return (grid_place(mesh.cfg, mesh.rank), mesh.stage,
            {n: (g.rank, g.size) for n, g in mesh.groups().items()})


def toy_layer(p, s, h):
    """The JAX tests' layer: tanh(h w + b); its state (when given)
    accumulates the sum over rows of the activation the layer sees."""
    out = torch.tanh(h @ p["w"] + p["b"])
    return out, None if s is None else s + h.sum(dim=0)


def toy_pipeline(mesh, w, b, mb, state=None):
    """pp_pipeline of the toy layer over the rank's stage of (w, b) and of
    the state: (the outputs, the stage's state, the layer applications)."""
    params = stage_layers({"w": torch.from_numpy(w), "b": torch.from_numpy(b)}, mesh)
    st = None if state is None else stage_layers(torch.from_numpy(state), mesh)
    pp_pipeline.layer_applications = 0
    out, st = pp_pipeline(mesh, toy_layer, params, torch.from_numpy(mb), layer_state=st)
    return out.numpy(), None if st is None else st.numpy(), pp_pipeline.layer_applications


def wan_generate(mesh, cfg_dict, params_np, ctx, noise, renoise, w8a8=False):
    """`torch_tp_ranks.wan_generate` (the latents, the island, the bytes by
    group, counted from 0) with the rank's layer applications."""
    if mesh is not None:
        mesh.reset_bytes()
    pp_pipeline.layer_applications = 0
    lat, mode, sent, _ = torch_tp_ranks.wan_generate(mesh, cfg_dict, params_np, ctx, noise,
                                                     renoise, w8a8)
    return lat, mode, sent, pp_pipeline.layer_applications


def magi_walk(mesh, cfg_kw, rt_kw, params_np, cap, mask, noise, chunk_num, w8a8=False):
    """`torch_tp_ranks.magi_walk` (the bytes by group counted from 0), with
    the rank's layer applications."""
    if mesh is not None:
        mesh.reset_bytes()
    pp_pipeline.layer_applications = 0
    chunks, mode, sent, shard = torch_tp_ranks.magi_walk(mesh, cfg_kw, rt_kw, params_np, cap,
                                                         mask, noise, chunk_num, w8a8)
    return chunks, mode, sent, pp_pipeline.layer_applications


def magi_window(mesh, cfg_kw, params_np, x, t, caps, masks, kv_ranges, head_major):
    """One 3-CFG batched window forward with the row sync on this rank (its
    dp rows, its stage's layers): its rows of the velocity and of the cache
    (token-major), every layer of its stage."""
    cfg = MagiModelConfig(**cfg_kw)
    params = params_from_numpy(params_np, "cpu", torch.float32)
    dp = mesh.dp if mesh is not None else None
    rows = slice(None) if dp is None or dp.size == 1 else slice(dp.rank, dp.rank + 1)
    b = x.shape[0] // (1 if dp is None else dp.size)
    if mesh is not None and mesh.pp.size > 1:
        params = {**params, "blocks": stage_layers(params["blocks"], mesh)}
    st = make_magi_statics(cfg, b, x.shape[2], x.shape[3], 4, torch.float32, mesh=mesh,
                           kv_head_major=head_major)
    cache = init_kv_cache(st.spec, "cpu")
    drop = torch.tensor([False, True])[rows]
    v, cache = magi_forward(params, st, None, torch.from_numpy(x)[rows],
                            torch.from_numpy(t)[rows], torch.from_numpy(caps)[rows],
                            torch.from_numpy(masks)[rows], cache, 0, kv_ranges,
                            caption_dropout=drop, sync_kv_rows=True)
    fields = [f.transpose(2, 3) if head_major else f for f in cache[:2]]
    return v.numpy(), [f.numpy() for f in fields]
