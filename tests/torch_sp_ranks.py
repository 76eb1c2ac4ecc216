"""Work that `tests/test_torch_sp.py` runs on each rank of a gloo
`RankPool`: module-level functions `fn(mesh, *args)` over numpy inputs,
returning numpy. This module imports no JAX (the rank processes do not
load it)."""
import numpy as np
import torch

from inferix_tpu_torch.core.config import EngineConfig
from inferix_tpu_torch.kvcache.cache import KVCacheSpec, init_kv_cache
from inferix_tpu_torch.parallel import sp_attention
from inferix_tpu_torch.parallel.distributed_attention import sp_cache_attention, sp_write_block
from inferix_tpu_torch.parallel.mesh import (frame_shard, init_kv_cache_shard,
                                             wan_kv_cache_shard)
from inferix_tpu_torch.pipeline.semi_ar import SemiARGenerator
from inferix_tpu_torch.utils.params import params_from_numpy


def _np(t: torch.Tensor) -> np.ndarray:
    """e4m3 as its bytes, bf16 widened to float32 (exact)."""
    if t.dtype == torch.float8_e4m3fn:
        return t.view(torch.uint8).numpy()
    return (t.float() if t.dtype == torch.bfloat16 else t).numpy()


def island(mesh, mode, spec_kw, cache_np, q, k, v, start, frames):
    """Write the block's K/V (this rank's frame shard of k/v [B, n, H, D])
    into this rank's shard of a cache holding `cache_np` (token-major
    fields), attend q's frame shard; returns (output shard, cache shard
    fields)."""
    spec = KVCacheSpec(**spec_kw)
    shard = wan_kv_cache_shard(mode, spec, mesh)
    layer = tuple(f[0] for f in init_kv_cache_shard(spec, shard, "cpu") if f is not None)
    full = [torch.from_numpy(a) for a in cache_np]
    full = [f.view(spec.dtype) if f.dtype == torch.uint8 else f for f in full]
    for dst, src in zip(layer, full):
        view = dst.transpose(1, 2) if spec.head_major else dst
        if shard.axis == "heads":
            src = src[:, :, shard.lo:shard.hi]
        elif shard.axis == "slots":
            src = src[:, shard.lo:shard.hi]
        view.copy_(src)
    sp = mesh.sp
    ql, kl, vl = (frame_shard(sp, torch.from_numpy(x), frames) for x in (q, k, v))
    layer = sp_write_block(sp, mode, spec, shard, layer, kl, vl, start, frames)
    out = sp_cache_attention(sp, mode, spec, shard, ql, layer, start + q.shape[1], frames)
    return out.numpy(), [_np(f) for f in layer], mesh.sent_bytes


def attention(mesh, name, q, k, v):
    """One `parallel.sp_attention` function over this rank's contiguous
    1/sp of the tokens; returns its output shard."""
    q, k, v = (frame_shard(mesh.sp, torch.from_numpy(x), 1) for x in (q, k, v))
    return getattr(sp_attention, name)(mesh.sp, q, k, v).numpy()


def generate(mesh, cfg_dict, params_np, ctx, noise, renoise):
    """SemiARGenerator.generate on this rank of the mesh, float32, fed the
    given renoise; returns the latents."""
    cfg = EngineConfig.from_dict(cfg_dict)
    gen = SemiARGenerator(cfg, params_from_numpy(params_np, "cpu", torch.float32),
                          dtype=torch.float32, device="cpu", mesh=mesh)
    assert gen.sp_mode == cfg.parallel.sp_mode
    xattn = gen.encode_text_context(torch.from_numpy(ctx))
    lat, _ = gen.generate(torch.from_numpy(noise), xattn,
                          renoise=[[torch.from_numpy(r) for r in blk] for blk in renoise])
    return lat.numpy()
