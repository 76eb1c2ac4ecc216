"""Tensor and data parallelism of the port (`inferix_tpu_torch/parallel/`:
`mesh.py`'s grid and shards, `tensor_parallel.py`, the MAGI islands of
`distributed_attention.py`) on the CPU: one module-scoped `RankPool` of 4
gloo ranks hosts every layout (a layout of fewer ranks leaves the others
idle), the rank-side work in `tests/torch_tp_ranks.py`.

- the islands, assembled from the ranks' shards: `cso_chunk_attention`
  (per chunk and whole window, a float32 cache standing for bf16 and an
  int8 cache with its scales, token- and head-major) and `gqa_head_island`
  (fresh token-sharded K/V and caption K/V of every token) at tp 2 x sp 2
  and tp 2 x sp 1, each against the port's single-device attention
  (1e-5) and one of each (tp 2 x sp 2) against the JAX function on its 8
  virtual CPU devices (1e-5); the Wan ulysses island at tp 2 x sp 2
  against JAX, whose head slices t sp + s only the JAX (tp, sp) order puts
  together;
- the collectives against the port's single-device functions: row and
  column linears (float, int8, e4m3 weights; 1e-5), the full-width RMS
  norm (1e-5) and the tp act-quant (codes and scales equal to
  `quantize_rows_int8_reference` of the whole row, gelu_tanh / gelu_exact
  / silu_mul / none) at tp 2 and tp 4;
- two slices against the JAX package at its rtol / atol 2e-4: a tiny Wan
  `generate` at tp 2 (ulysses island) against
  `tests/test_distributed_attention.py:_generate` on a JAX mesh, and a
  tiny MAGI walk at cso tp 2 x sp 2 (4 q heads over 4 kv groups) against
  the JAX walk of `test_magi_cso_composes_with_tp`;
- every other layout against the port's single device (itself held to
  JAX), float32 at 1e-5, over 2 blocks (Wan) or 2 chunks (MAGI): Wan tp 2
  without an island, tp 2 x sp 2 in each island, tp 4, dp 2 at B = 2, i2v
  at tp 2 and tp 2 x sp 2, dp 2 x tp 2 continuous batching at unequal
  offsets; MAGI ulysses sp 2, cso at tp 2 only, 3-CFG at tp 2 (cso forced
  by the mesh), the split gated fc1 at tp 2. The int8 KV cache and W8A8 (the int8 codes can
  flip at a rounding tie under the float32 reduction order) are bounded
  as the JAX dryrun bounds its int8 runs: the drift to one device, max
  |got - want| / max |want|, under the quantization's own noise floor (the
  single-device quantized run against the float one); the MAGI int8
  window cache head-major against token-major bit for bit;
- `sp_comm_bytes_per_layer` at tp 2 equal to the JAX integer, MAGI at
  dp > 1 taken (since A13c), the layout groups and their byte counts.
"""
import copy
import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from inferix_tpu.core.config import ParallelConfig as JaxParallelConfig
from inferix_tpu.core.config import tiny_test_config as jax_tiny_config
from inferix_tpu.models.magi import dit as jdit
from inferix_tpu.models.wan.causal_dit import init_params as jax_init_params
from inferix_tpu.parallel import distributed_attention as jda
from inferix_tpu.parallel.mesh import make_mesh as jax_make_mesh
from inferix_tpu.pipeline import magi as jpipe
from inferix_tpu_torch.core.config import ParallelConfig, QuantConfig, tiny_test_config
from inferix_tpu_torch.kvcache.cache import quantize_kv_block
from inferix_tpu_torch.models.magi import dit as tdit
from inferix_tpu_torch.models.wan.causal_dit import linear
from inferix_tpu_torch.ops.act_quant import quantize_rows_int8_reference
from inferix_tpu_torch.ops.flash_attention import flash_attention_gqa, flash_attention_gqa_quant
from inferix_tpu_torch.ops.norms import rms_norm
from inferix_tpu_torch.parallel import distributed_attention as tda
from inferix_tpu_torch.parallel.launch import RankPool
from inferix_tpu_torch.parallel.mesh import Mesh, SPMesh, grid_coords
from inferix_tpu_torch.pipeline.magi import MagiPipeline, MagiRuntimeConfig
from inferix_tpu_torch.quant.api import _fp8_linear, _quantized_rows_linear
from inferix_tpu_torch.quant.kernels import quantize_weight_fp8, quantize_weight_int8

import torch_tp_ranks as ranks
from test_distributed_attention import _generate as jax_generate
from test_torch_magi_pipeline import jax_noise
from test_torch_semi_ar import _jax_renoise

TOL = dict(rtol=1e-5, atol=1e-5)
JAX_TOL = dict(rtol=2e-4, atol=2e-4)
TP2_SP2 = ParallelConfig(sp=2, tp=2)
TP2 = ParallelConfig(tp=2)
LAYOUTS = {"tp2_sp2": TP2_SP2, "tp2_sp1": TP2}


@pytest.fixture(scope="module")
def pool(tmp_path_factory):
    """4 gloo ranks, one process each on the CPU."""
    d = tmp_path_factory.mktemp("tp_store")
    p = RankPool(4, "gloo", f"file://{d / 'store'}", device="cpu", threads=1, timeout=300)
    yield p
    p.close()


def _run(pool, layout, fn, *args):
    """fn on the layout's ranks: their results in rank order (idle ranks'
    dropped)."""
    return [r for r in pool.run(fn, *args, layout=layout) if r is not None]


def _jax_mesh(layout):
    return jax_make_mesh(JaxParallelConfig(dp=layout.dp, sp=layout.sp, tp=layout.tp, pp=1))


def _drift(got, want):
    return float(np.abs(got - want).max() / (np.abs(want).max() + 1e-9))


# --- the grid ---

def test_grid_coords_and_head_order(pool):
    """Global rank (d sp + s) tp + t, as the JAX grid reshape(dp, sp, tp);
    the head group's rank is t sp + s; every group counts its bytes."""
    res = _run(pool, TP2_SP2, ranks.where)
    for rank, (d, s, t, h) in enumerate(res):
        assert (d, s, t) == grid_coords(TP2_SP2, rank) == (0, rank // 2, rank % 2)
        assert h == t * 2 + s
    # an exchange over the head group follows (t, s) tp-major: global ranks
    # (s tp + t) 0, 2, 1, 3
    assert _run(pool, TP2_SP2, ranks.head_order) == [[0, 2, 1, 3]] * 4
    res = _run(pool, ParallelConfig(dp=2, tp=2), ranks.where)
    assert [r[:3] for r in res] == [(0, 0, 0), (0, 0, 1), (1, 0, 0), (1, 0, 1)]


# --- the islands against the JAX functions ---

def _cso_inputs(kind):
    rng = np.random.default_rng(50)
    b, nc, ct, hq, hkv, d = 1, 3, 8, 8, 4, 16
    smax = nc * ct
    q = rng.standard_normal((b, nc, ct, hq, d)).astype(np.float32)
    k, v = (rng.standard_normal((b, smax, hkv, d)).astype(np.float32) for _ in range(2))
    if kind == "int8":
        kq, ks = quantize_kv_block(torch.from_numpy(k))
        vq, vs = quantize_kv_block(torch.from_numpy(v))
        fields = [kq.numpy(), vq.numpy(), ks.numpy(), vs.numpy()]
    else:
        fields = [k, v]
    return q, fields, np.array([[0, 8], [0, 16], [8, 24]], np.int32), 20


# the case also held to the JAX island (a JAX call ~15 s alone, ~30 s under
# the tier-1 load): the four-rank layout, the head-major cache, per chunk.
# The rest are held to the port's one device, itself held to JAX
# (tests/test_torch_magi.py), and the MAGI walk below to the JAX mesh walk
CSO_JAX = {("tp2_sp2", "float", True, False)}


def _cso_single(q, fields, ranges, cur):
    """The port's single-device MAGI attention: the GQA fold a chunk over
    the whole cache (`models/magi/dit.py`)."""
    fs = [torch.from_numpy(f) for f in fields]
    outs = []
    for ci, (start, end) in enumerate(ranges.tolist()):
        qi = torch.from_numpy(q[:, ci])
        if len(fs) == 4:
            outs.append(flash_attention_gqa_quant(qi, *fs, kv_len=min(end, cur), kv_start=start))
        else:
            outs.append(flash_attention_gqa(qi, *fs, kv_len=min(end, cur), kv_start=start))
    return torch.stack(outs, dim=1).numpy()


@pytest.mark.parametrize("whole_window", [False, True], ids=["cso", "ulysses"])
@pytest.mark.parametrize("head_major", [False, True], ids=["token_major", "head_major"])
@pytest.mark.parametrize("kind", ["float", "int8"])
@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_cso_matches_jax(pool, layout, kind, head_major, whole_window):
    """The rank's shards through the island, assembled, against the port's
    single-device attention (1e-5) and, for the CSO_JAX case (a float32
    cache), the JAX island (1e-5); chunk 2's span is clamped by current_end
    20."""
    q, fields, ranges, cur = _cso_inputs(kind)
    lay = LAYOUTS[layout]
    got = None
    for (_, s, t, _), out in _run(pool, lay, ranks.cso, q, fields, ranges, cur, whole_window,
                                  head_major):
        got = np.zeros(q.shape, np.float32) if got is None else got
        cs, hs = out.shape[2], out.shape[3]
        got[:, :, s * cs:(s + 1) * cs, t * hs:(t + 1) * hs] = out
    np.testing.assert_allclose(got, _cso_single(q, fields, ranges, cur), **TOL)
    if (layout, kind, head_major, whole_window) not in CSO_JAX:
        return
    jf = [jnp.asarray(f) for f in fields]
    if head_major:
        jf = [jnp.swapaxes(f, 1, 2) for f in jf]
    want = jda.cso_chunk_attention(
        _jax_mesh(lay), jnp.asarray(q), jf[0], jf[1], jnp.asarray(ranges), jnp.int32(cur),
        whole_window=whole_window, kv_layout="bhsd" if head_major else "bshd")
    np.testing.assert_allclose(got, np.asarray(want), **TOL)


@pytest.mark.parametrize("kv_tokens_sharded", [True, False], ids=["fresh_kv", "caption_kv"])
@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_gqa_head_island_matches_jax(pool, layout, kv_tokens_sharded):
    """Prefix-free K/V (token shards, every token live) and caption K/V (every
    token of the rank's kv heads, each row's prefix span), assembled, against
    the port's single-device GQA fold (1e-5) and, at tp 2 x sp 2 with fresh
    K/V, the JAX island."""
    rng = np.random.default_rng(51)
    b, s, hq, hkv, d = 2, 8, 8, 4, 16
    skv = s if kv_tokens_sharded else 6
    q = rng.standard_normal((b, s, hq, d)).astype(np.float32)
    k, v = (rng.standard_normal((b, skv, hkv, d)).astype(np.float32) for _ in range(2))
    lens = np.array([skv, skv if kv_tokens_sharded else 3], np.int32)
    lay = LAYOUTS[layout]
    got = np.zeros(q.shape, np.float32)
    for (_, sr, t, _), out in _run(pool, lay, ranks.head_island, q, k, v, lens,
                                   kv_tokens_sharded):
        n, h = out.shape[1], out.shape[2]
        got[:, sr * n:(sr + 1) * n, t * h:(t + 1) * h] = out
    single = flash_attention_gqa(*map(torch.from_numpy, (q, k, v)), kv_len=torch.from_numpy(lens))
    np.testing.assert_allclose(got, single.numpy(), **TOL)
    if layout == "tp2_sp2" and kv_tokens_sharded:   # one of the four against JAX too
        mask = np.arange(skv)[None] < lens[:, None]
        want = jda.gqa_head_island(_jax_mesh(lay), *map(jnp.asarray, (q, k, v)),
                                   kv_mask=jnp.asarray(mask))
        np.testing.assert_allclose(got, np.asarray(want), **TOL)


def test_ulysses_tp2_sp2_matches_jax(pool):
    """The rank (t, s) attends cache heads t sp + s: assembled by the JAX
    (tp, sp) order the output is the JAX island's; the s tp + t order
    would pair each rank's queries with another rank's cache heads."""
    rng = np.random.default_rng(52)
    q = rng.standard_normal((1, 8, 8, 16)).astype(np.float32)
    k, v = (rng.standard_normal((1, 24, 8, 16)).astype(np.float32) for _ in range(2))
    live = 20
    want = np.asarray(jda.ulysses_cache_attention(
        _jax_mesh(TP2_SP2), *map(jnp.asarray, (q, k, v)), jnp.arange(24) < live))
    got = np.zeros_like(want)
    for (_, s, t, _), out in _run(pool, TP2_SP2, ranks.ulysses, q, k, v, live):
        got[:, s * 4:(s + 1) * 4, t * 4:(t + 1) * 4] = out
    np.testing.assert_allclose(got, want, **TOL)


# --- the collectives against the single-device functions ---

@pytest.fixture(scope="module")
def collective_inputs():
    rng = np.random.default_rng(53)
    k_in, n = 64, 48
    x = rng.standard_normal((6, k_in)).astype(np.float32)
    w = (rng.standard_normal((k_in, n)) / 8).astype(np.float32)
    b = rng.standard_normal(n).astype(np.float32)
    w_i8, s_i8 = quantize_weight_int8(torch.from_numpy(w))
    w_f8, s_f8 = quantize_weight_fp8(torch.from_numpy(w))
    lin = {"float": {"w": w, "b": b},
           "int8": {"w_q": w_i8.numpy(), "scale": s_i8.numpy(), "b": b},
           "fp8": {"w_q": w_f8.view(torch.uint8).numpy(), "scale": s_f8.numpy(), "b": b}}
    lin.update({f"{k}_gelu": v for k, v in list(lin.items())})
    norm_x = rng.standard_normal((6, 64)).astype(np.float32) * 3
    norm_w = rng.uniform(0.5, 1.5, 64).astype(np.float32)
    rows = {a: (rng.standard_normal((5, 2 * 64 if a == "silu_mul" else 64)) * 2
                ).astype(np.float32) for a in ("none", "gelu", "gelu_exact", "silu_mul")}
    rows["gelu"][0, :] = 0  # an all-zero row: the scale's 1e-8 floor
    return lin, x, norm_x, norm_w, rows


def _leaf(v):
    return {k: (torch.from_numpy(a).view(torch.float8_e4m3fn) if a.dtype == np.uint8
                else torch.from_numpy(a)) for k, a in v.items()}


@pytest.mark.parametrize("part", ["linears", "norm", "act_quant"])
@pytest.mark.parametrize("layout", ["tp2_sp2", "tp4"])
def test_collectives_match_single_device(pool, collective_inputs, layout, part):
    lin, x, norm_x, norm_w, rows = collective_inputs
    lay = TP2_SP2 if layout == "tp2_sp2" else ParallelConfig(tp=4)
    res = _run(pool, lay, ranks.collectives, lin, x, norm_x, norm_w, rows)
    xt = torch.from_numpy(x)
    for (_, _, t, _), out, sent in res:
        tp = lay.tp
        assert sent["tp"][0] > 0 and ("sp" in sent) == (lay.sp > 1)
        if part == "linears":
            for name, leaf in lin.items():
                p = _leaf(leaf)
                if name.endswith("_gelu"):
                    h = F.gelu(xt, approximate="tanh")
                    want = (_quantized_rows_linear(p, xt, act="gelu") if "int8" in name
                            else _fp8_linear(p, h) if "fp8" in name else linear(p, h))
                else:
                    want = (_quantized_rows_linear(p, xt) if "int8" in name
                            else linear(p, xt))
                np.testing.assert_allclose(out["row"][name], want.numpy(), **TOL)
                col = linear(p, xt).numpy()
                n = col.shape[-1] // tp
                np.testing.assert_allclose(out["column"][name], col[:, t * n:(t + 1) * n],
                                           **TOL)
        elif part == "norm":
            want = rms_norm(torch.from_numpy(norm_x), torch.from_numpy(norm_w), 1e-6).numpy()
            n = want.shape[-1] // tp
            np.testing.assert_allclose(out["norm"], want[:, t * n:(t + 1) * n], **TOL)
        else:
            for act, r in rows.items():
                wq, ws = quantize_rows_int8_reference(torch.from_numpy(r).to(torch.bfloat16),
                                                      None if act == "none" else act)
                q, s = out["quant"][act]
                n = wq.shape[-1] // tp
                assert np.array_equal(q, wq.numpy()[:, t * n:(t + 1) * n]), act
                assert np.array_equal(s, ws.numpy()), act


# --- Wan ---

@pytest.fixture(scope="module")
def wan():
    """The JAX tiny tree and the JAX inputs of `_generate` (text, 3 frames of
    noise, the renoise its key schedule draws); B = 2 inputs for dp."""
    jcfg = jax_tiny_config()
    jp = jax_init_params(jax.random.key(0), jcfg.model, dtype=jnp.float32)
    m, r = jcfg.model, jcfg.runtime
    ctx = np.array(jax.random.normal(jax.random.key(7), (1, m.text_len, m.text_dim)))
    noise = np.array(jax.random.normal(
        jax.random.key(1), (1, 3, r.latent_height, r.latent_width, r.latent_channels)))
    key, renoise = jax.random.key(2), []
    for _ in range(3):
        key, step = jax.random.split(key)
        renoise.append([x.numpy() for x in _jax_renoise(step, len(r.denoising_step_list),
                                                        (1, 1) + noise.shape[2:])])
    rng = np.random.default_rng(54)
    two = (np.concatenate([ctx, rng.standard_normal(ctx.shape).astype(np.float32)]),
           np.concatenate([noise, rng.standard_normal(noise.shape).astype(np.float32)]),
           [[np.concatenate([a, rng.standard_normal(a.shape).astype(np.float32)])
             for a in blk] for blk in renoise])
    return jp, jax.tree.map(np.asarray, jp), (ctx, noise, renoise), two


def _wan_cfg(layout=None, mode="ulysses", kv="float32", batch=1, w8a8=False):
    cfg = tiny_test_config()
    cfg.runtime.batch_size = batch
    if layout is not None:
        cfg.parallel = dataclasses.replace(layout, sp_mode=mode)
    if kv == "int8":
        cfg.quant.enabled = cfg.quant.quantize_kv_cache = True
        cfg.runtime.kv_head_major = cfg.runtime.kv_alloc_pad = True
    if w8a8:
        cfg.quant = QuantConfig(enabled=True, dtype="int8")
    return cfg


_SINGLE = {}


def _single(case_cfg, params_np, inputs, w8a8=False):
    """The port's one-device latents of a case's config (kept for the
    cases that share it)."""
    cfg = copy.deepcopy(case_cfg)
    cfg.parallel = ParallelConfig()
    key = (json.dumps(cfg.to_dict(), sort_keys=True), w8a8, len(inputs[2]))
    if key not in _SINGLE:
        _SINGLE[key], *_ = ranks.wan_generate(None, cfg.to_dict(), params_np, *inputs,
                                              w8a8=w8a8)
    return _SINGLE[key]


def _two_blocks(inputs):
    """The first 2 of the 3 blocks' inputs (the noise, the renoise)."""
    ctx, noise, renoise = inputs
    return ctx, noise[:, :2], renoise[:2]


def test_wan_tp2_generate_matches_jax_mesh(pool, wan):
    """tp 2, sp 1, "ulysses": the JAX generator takes its island on the
    tp-only mesh, and so does the port (its sp all-to-alls identities)."""
    jp, params_np, inputs, _ = wan
    jcfg = jax_tiny_config()
    jcfg.parallel = JaxParallelConfig(dp=1, sp=1, tp=2, pp=1, sp_mode="ulysses")
    want = jax_generate(jcfg, jp, mesh=jax_make_mesh(jcfg.parallel))
    res = _run(pool, TP2, ranks.wan_generate, _wan_cfg(TP2).to_dict(), params_np, *inputs)
    for lat, mode, sent, comm in res:
        assert mode == "ulysses" and "sp" not in sent and sent["tp"][0] > 0
        np.testing.assert_allclose(lat, want, **JAX_TOL)
    assert np.array_equal(res[0][0], res[1][0])


WAN_CASES = {
    "tp2_no_island": (TP2, "auto", "float32", 1, False),
    "tp2_sp2_ulysses": (TP2_SP2, "ulysses", "float32", 1, False),
    "tp2_sp2_ring_pass_q": (TP2_SP2, "ring_pass_q", "float32", 1, False),
    "tp2_sp2_ring_pass_kv": (TP2_SP2, "ring_pass_kv", "float32", 1, False),
    "tp4_ulysses": (ParallelConfig(tp=4), "ulysses", "float32", 1, False),
    "dp2": (ParallelConfig(dp=2), "ulysses", "float32", 2, False),
    "dp2_tp2": (ParallelConfig(dp=2, tp=2), "ulysses", "float32", 2, False),
    "tp2_sp2_ring_pass_q_int8_head_major": (TP2_SP2, "ring_pass_q", "int8", 1, False),
    "tp2_w8a8": (TP2, "ulysses", "float32", 1, True),
}


@pytest.mark.parametrize("case", list(WAN_CASES))
def test_wan_layout_matches_single_device(pool, wan, case):
    lay, mode, kv, batch, w8a8 = WAN_CASES[case]
    _, params_np, one, two = wan
    inputs = _two_blocks(two if batch == 2 else one)
    cfg = _wan_cfg(lay, mode, kv, batch, w8a8)
    res = _run(pool, lay, ranks.wan_generate, cfg.to_dict(), params_np, *inputs, w8a8)
    want = _single(cfg, params_np, inputs, w8a8)
    for lat, *_ in res:
        assert lat.shape == want.shape and np.isfinite(lat).all()
        if kv == "int8" or w8a8:
            # the JAX dryrun's bound: within the quantization's noise floor
            plain = copy.deepcopy(cfg)
            plain.quant = QuantConfig()
            plain.runtime.kv_head_major = plain.runtime.kv_alloc_pad = False
            floor = _drift(want, _single(plain, params_np, inputs))
            assert _drift(lat, want) < floor, (_drift(lat, want), floor)
        else:
            np.testing.assert_allclose(lat, want, **TOL)
    assert all(np.array_equal(res[0][0], r[0]) for r in res)
    if lay.sp > 1:
        jcomm = jda.sp_comm_bytes_per_layer(mode, lay.sp, lay.tp, batch, 16, 96, 4, 32, 4)
        assert all(r[3] == jcomm > 0 for r in res)


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_wan_i2v_heads_over_tp(pool, layout):
    """An i2v model (the CLIP image K/V from replicated k_img / v_img, each
    rank taking its heads after the full-width norm) at tp 2 and tp 2 x sp
    2 against one device: two forwards, the second over the first's cache."""
    cfg = tiny_test_config()
    cfg.model.model_type, cfg.model.in_dim = "i2v", 36
    params_np = jax.tree.map(np.asarray, jax_init_params(
        jax.random.key(0), dataclasses.replace(jax_tiny_config().model, model_type="i2v",
                                               in_dim=36), dtype=jnp.float32))
    rng = np.random.default_rng(55)
    ctx = rng.standard_normal((1, 16, 64)).astype(np.float32)
    clip = rng.standard_normal((1, 17, 1280)).astype(np.float32)
    xs = [rng.standard_normal((1, 1, 8, 8, 36)).astype(np.float32) for _ in range(2)]
    want = ranks.wan_i2v_forwards(None, cfg.to_dict(), params_np, ctx, clip, xs)
    res = _run(pool, LAYOUTS[layout], ranks.wan_i2v_forwards, cfg.to_dict(), params_np, ctx,
               clip, xs)
    for flows in res:
        for g, w in zip(flows, want):
            np.testing.assert_allclose(g, w, **TOL)


def test_wan_dp2_tp2_continuous_batching(pool, wan):
    """Streams at unequal offsets over dp 2 x tp 2 (each dp rank its slot)
    against the same schedule on one device (the JAX dryrun's phase 5)."""
    _, params_np, _, _ = wan
    lay = ParallelConfig(dp=2, tp=2)
    cfg = _wan_cfg(lay, batch=2)
    res = _run(pool, lay, ranks.wan_continuous, cfg.to_dict(), params_np)
    single = copy.deepcopy(cfg)
    single.parallel = ParallelConfig()
    want = ranks.wan_continuous(None, single.to_dict(), params_np)
    assert [len(want[r]) for r in ("a", "b")] == [3, 2]
    for outs in res:
        assert set(outs) == {"a", "b"}
        for rid in ("a", "b"):
            for g, w in zip(outs[rid], want[rid]):
                np.testing.assert_allclose(g, w, **TOL)


# --- MAGI ---

MAGI_RT = dict(num_steps=4, window_size=2, chunk_width=2)


def _magi_inputs(jcfg, seed=1234):
    cap = np.ones((1, jcfg.caption_max_length, jcfg.caption_channels), np.float32) * 0.1
    mask = np.ones((1, jcfg.caption_max_length), np.int32)
    noise = jax_noise(seed, (1, 3 * 2, 8, 8, jcfg.latent_channels))
    return cap, mask, noise


def test_magi_cso_tp2_sp2_matches_jax_mesh(pool):
    """The JAX walk of test_magi_cso_composes_with_tp (4 q heads over 4 kv
    groups: one kv head a rank) against the port's ranks."""
    jcfg = dataclasses.replace(jdit.tiny_magi_config(), num_attention_heads=4,
                               num_query_groups=4)
    jp = jdit.init_magi_params(jax.random.key(3), jcfg, jnp.float32)
    cap, mask, noise = _magi_inputs(jcfg)
    pipe = jpipe.MagiPipeline(jcfg, jpipe.MagiRuntimeConfig(cp_strategy="cso", **MAGI_RT),
                              params=jp, latent_h=8, latent_w=8, max_chunks=6,
                              dtype=jnp.float32, mesh=_jax_mesh(TP2_SP2))
    want = [np.asarray(c) for _, c in pipe.generate_chunks(jnp.asarray(cap),
                                                           jnp.asarray(mask), chunk_num=3)]
    res = _run(pool, TP2_SP2, ranks.magi_walk, dataclasses.asdict(jcfg),
               dict(cp_strategy="cso", **MAGI_RT), jax.tree.map(np.asarray, jp), cap, mask,
               noise, 3)
    for chunks, mode, sent, shard in res:
        assert mode == "cso" and shard[0] == "heads" and shard[2] - shard[1] == 1
        assert sent["tp"][0] > 0 and sent["sp"][0] > 0
        assert len(chunks) == len(want)
        for g, w in zip(chunks, want):
            np.testing.assert_allclose(g, w, **JAX_TOL)


@pytest.fixture(scope="module")
def magi_trees():
    """The tiny config (4 q heads over 2 kv groups) and a gated one, their
    JAX trees as numpy."""
    base = jdit.tiny_magi_config()
    gated = dataclasses.replace(base, gated_linear_unit=True)
    return {name: (cfg, jax.tree.map(np.asarray, jdit.init_magi_params(
        jax.random.key(3), cfg, jnp.float32))) for name, cfg in (("base", base),
                                                                 ("gated", gated))}


MAGI_CASES = {
    "ulysses_sp2": ("base", ParallelConfig(sp=2), dict(cp_strategy="ulysses"), False),
    "cso_tp2_only": ("base", TP2, dict(cp_strategy="cso"), False),
    "cfg3_forced_cso_tp2": ("base", TP2, dict(cfg_number=3), False),
    "gated_split_fc1_tp2": ("gated", TP2, dict(cp_strategy="cso"), False),
    "gated_split_fc1_w8a8_tp2": ("gated", TP2, dict(cp_strategy="cso"), True),
    "int8_cache_cso_sp2": ("base", ParallelConfig(sp=2),
                           dict(cp_strategy="cso", quantize_kv=True), False),
}
MAGI_CHUNKS = 2   # the walk's chunks in the cases against one device (JAX's: 3)


@pytest.mark.parametrize("case", list(MAGI_CASES))
def test_magi_layout_matches_single_device(pool, magi_trees, case):
    name, lay, rt_kw, w8a8 = MAGI_CASES[case]
    jcfg, params_np = magi_trees[name]
    cap, mask, noise = _magi_inputs(jcfg)
    rt = dict(MAGI_RT, **rt_kw)
    noise = noise[:, :MAGI_CHUNKS * MAGI_RT["chunk_width"]]
    res = _run(pool, lay, ranks.magi_walk, dataclasses.asdict(jcfg), rt, params_np, cap,
               mask, noise, MAGI_CHUNKS, w8a8)
    single_rt = {k: v for k, v in rt.items() if k != "cp_strategy"}
    want, *_ = ranks.magi_walk(None, dataclasses.asdict(jcfg), single_rt, params_np, cap,
                               mask, noise, MAGI_CHUNKS, w8a8)
    quantized = w8a8 or rt.get("quantize_kv")
    if quantized:
        plain = {k: v for k, v in single_rt.items() if k != "quantize_kv"}
        base, *_ = ranks.magi_walk(None, dataclasses.asdict(jcfg), plain, params_np, cap,
                                   mask, noise, MAGI_CHUNKS)
    for chunks, mode, _, _ in res:
        assert mode == rt_kw.get("cp_strategy", "cso")
        for g, w, *b in zip(chunks, want, *([base] if quantized else [])):
            if quantized:  # the JAX dryrun's bound: within the noise floor
                assert _drift(g, w) < _drift(w, b[0]), (_drift(g, w), _drift(w, b[0]))
            else:
                np.testing.assert_allclose(g, w, **TOL)


def test_magi_int8_cache_head_major_bit_equal(pool, magi_trees):
    """The int8 window cache head-major against token-major under cso at
    tp 2 x sp 1 and sp 2: bit for bit (JAX `test_magi_cso_composes_with_head_major`)."""
    jcfg, params_np = magi_trees["base"]
    cap, mask, noise = _magi_inputs(jcfg)
    for lay in (TP2, ParallelConfig(sp=2)):
        runs = [_run(pool, lay, ranks.magi_walk, dataclasses.asdict(jcfg),
                     dict(MAGI_RT, cp_strategy="cso", quantize_kv=True, kv_head_major=hm),
                     params_np, cap, mask, noise[:, :MAGI_CHUNKS * MAGI_RT["chunk_width"]],
                     MAGI_CHUNKS) for hm in (False, True)]
        for a, b in zip(*runs):
            assert all(np.array_equal(x, y) for x, y in zip(a[0], b[0]))


def test_magi_dp_refused_and_sp_comm_bytes():
    """MAGI at dp > 1 is taken since A13c (its rows over the dp ranks: the
    3-CFG batch of 2 is one row a rank; the walk itself is held to one
    device in tests/test_torch_pp.py) and a batch that does not split
    over dp is refused; the Wan and MAGI counts of the JAX formula at tp 2."""
    one = SPMesh(0, 1, "gloo", "cpu", name="sp")
    mesh = Mesh(cfg=ParallelConfig(dp=2), rank=0, backend="gloo", device=torch.device("cpu"),
                sp=one, tp=SPMesh(0, 1, "gloo", "cpu", name="tp"),
                dp=SPMesh(0, 2, "gloo", "cpu", name="dp"), heads=one)
    cfg = tdit.tiny_magi_config()
    pipe = MagiPipeline(cfg, MagiRuntimeConfig(cfg_number=3, **MAGI_RT), latent_h=8,
                        latent_w=8, max_chunks=6, dtype=torch.float32, device="cpu", mesh=mesh)
    assert pipe.batch == 2 and pipe.statics.spec.batch == 1 and pipe.rows == slice(0, 1)
    with pytest.raises(ValueError, match="does not split over dp 2"):
        MagiPipeline(cfg, MagiRuntimeConfig(cfg_number=1, **MAGI_RT), latent_h=8, latent_w=8,
                     max_chunks=6, dtype=torch.float32, device="cpu", mesh=mesh)
    st = tdit.make_magi_statics(cfg, 1, 8, 8, 6, torch.float32, mesh=mesh)
    assert st.dp is mesh.dp and st.spec.batch == 1
    for mode in ("ulysses", "cso", "ring_pass_q", "ring_pass_kv"):
        args = (mode, 2, 2, 1, 4680, 32760, 12, 128)
        assert tda.sp_comm_bytes_per_layer(*args) == jda.sp_comm_bytes_per_layer(*args) > 0
