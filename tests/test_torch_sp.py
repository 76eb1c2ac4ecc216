"""Sequence parallelism of the port (`inferix_tpu_torch/parallel/`) on the
CPU: gloo ranks, one process each, started once per module from a file
store under the test's temporary directory (`RankPool`), the rank-side work
in `tests/torch_sp_ranks.py`.

- the three cache islands (ulysses, ring pass-q, ring pass-kv) x the cache
  storage (bf16, e4m3, int8 + scales) x the layout (token-major,
  head-major) at sp = 2, with a live span that ends in rank 0's slots and
  one that crosses into rank 1's, and each island at sp = 4 over a padded
  head-major int8 cache, and a rolling window whose block wraps across the
  ranks' slots: the write and the attention held to the port's
  single-device `write_block` + `cache_attention` on the same inputs (each
  rank's cache shard bit-equal to its slice; the output 1e-5, the bf16
  cache 1e-2: its p is rounded to bf16 against each slice's running max);
- `merge_attention_partials` and the three `sp_attention.py` functions held
  to the JAX package's on its 8 virtual CPU devices (1e-5);
- a tiny Wan `generate` at sp = 2 in every mode held to the JAX generator
  on a mesh (`tests/test_distributed_attention.py`'s `_generate`, its rtol /
  atol 2e-4), the port fed the JAX renoise; and every mode x storage x
  layout held to the port's single-device generate (1e-5);
- `sp_comm_bytes_per_layer` equal to the JAX integer; tp and dp > 1
  accepted, pp > 1 too (since A13c); the refusals of shapes that do not split over
  sp.
"""
import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from inferix_tpu.core.config import ParallelConfig as JaxParallelConfig
from inferix_tpu.core.config import tiny_test_config as jax_tiny_config
from inferix_tpu.models.wan.causal_dit import init_params as jax_init_params
from inferix_tpu.ops.attention import merge_attention_partials as jax_merge
from inferix_tpu.parallel import distributed_attention as jda
from inferix_tpu.parallel import sp_attention as jsp
from inferix_tpu.parallel.mesh import make_mesh as jax_make_mesh
from inferix_tpu_torch.core.config import EngineConfig, ParallelConfig, tiny_test_config
from inferix_tpu_torch.kvcache.cache import (KVCacheSpec, init_kv_cache, token_major,
                                             valid_mask, write_block)
from inferix_tpu_torch.models.wan.causal_dit import make_statics
from inferix_tpu_torch.ops.attention import cache_attention, merge_attention_partials
from inferix_tpu_torch.parallel import distributed_attention as tda
from inferix_tpu_torch.parallel.launch import RankPool
from inferix_tpu_torch.parallel.mesh import SPMesh, unshard_frames
from inferix_tpu_torch.pipeline.semi_ar import SemiARGenerator
from inferix_tpu_torch.utils.params import init_params, params_from_numpy

import torch_sp_ranks as ranks
from test_distributed_attention import _generate as jax_generate
from test_torch_semi_ar import _jax_renoise

FP8 = torch.float8_e4m3fn
H, D, FRAMES, FRAME_TOKENS = 4, 16, 2, 8


@pytest.fixture(scope="module")
def pools(tmp_path_factory):
    """gloo rank pools of 2 and 4, one process a rank on the CPU."""
    d = tmp_path_factory.mktemp("sp_store")
    made = {n: RankPool(n, "gloo", f"file://{d / f'store{n}'}", device="cpu", threads=1,
                        timeout=300) for n in (2, 4)}
    yield made
    for p in made.values():
        p.close()


# --- the cache islands against the single-device dispatcher ---

def _cache_inputs(rng, spec, start):
    """Token-major field arrays of a cache layer whose first `start`
    positions hold earlier tokens, in storage form."""
    shape = (1, spec.slots, H, D)
    if spec.quantized:
        codes = [rng.integers(-127, 128, shape).astype(np.int8) for _ in range(2)]
        scales = [rng.uniform(0.005, 0.02, shape[:-1]).astype(np.float32) for _ in range(2)]
        fields = codes + scales
    else:
        vals = [(rng.standard_normal(shape) * 2).astype(np.float32) for _ in range(2)]
        fields = [torch.from_numpy(v).to(spec.dtype) for v in vals]
        fields = [(f.view(torch.uint8) if f.dtype == FP8 else f.float() if f.dtype ==
                   torch.bfloat16 else f).numpy() for f in fields]
    for f in fields:
        f[:, start:] = 0
    return fields


def _tensors(spec, fields):
    out = []
    for a in fields:
        t = torch.from_numpy(a.copy())
        if t.dtype == torch.uint8:
            t = t.view(FP8)
        elif spec.dtype == torch.bfloat16 and t.dtype == torch.float32 and t.dim() == 4:
            t = t.to(torch.bfloat16)
        out.append(t)
    return out


def _spec_kw(kind, head_major, **extra):
    kw = dict(num_layers=1, batch=1, max_tokens=64, num_kv_heads=H, head_dim=D,
              head_major=head_major)
    if kind == "int8":
        kw.update(quantized=True, dtype=torch.float32)
    else:
        kw.update(dtype={"bf16": torch.bfloat16, "e4m3": FP8}[kind])
    kw.update(extra)
    return kw


def _run_island(pool, mode, kind, head_major, start, **extra):
    spec_kw = _spec_kw(kind, head_major, **extra)
    spec = KVCacheSpec(**spec_kw)
    rng = np.random.default_rng(30 + start)
    n = FRAMES * FRAME_TOKENS
    cache_np = _cache_inputs(rng, spec, min(start, spec.max_tokens))
    q, k, v = ((rng.standard_normal((1, n, H, D)) * 2).astype(np.float32) for _ in range(3))
    # the single-device reference on the same spec
    layer = [f[0] for f in init_kv_cache(spec, device="cpu") if f is not None]
    for dst, src in zip(layer, _tensors(spec, cache_np)):
        token_major(dst, head_major).copy_(src)
    layer = write_block(spec, layer[0], layer[1], torch.from_numpy(k), torch.from_numpy(v),
                        start, *layer[2:])
    scales = dict(k_scale=layer[2], v_scale=layer[3]) if spec.quantized else {}
    want = cache_attention(torch.from_numpy(q), layer[0], layer[1],
                           kv_mask=valid_mask(spec, start + n, device="cpu"),
                           logical_kv=spec.max_tokens,
                           kv_layout="bhsd" if head_major else "bshd", **scales)
    res = pool.run(ranks.island, mode, spec_kw, cache_np, q, k, v, start, FRAMES)
    got = unshard_frames([torch.from_numpy(o) for o, _, _ in res], FRAMES)
    tol = 1e-2 if kind == "bf16" else 1e-5
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=tol, atol=tol)
    # each rank's shard of the written cache is its slice of the reference
    size = len(res)
    for rank, (_, fields, sent) in enumerate(res):
        assert sent > 0
        for got_f, ref in zip(fields, layer):
            ref = token_major(ref, head_major)
            if mode == "ulysses":
                per = H // size
                ref = ref[:, :, rank * per:(rank + 1) * per]
            else:
                per = spec.slots // size
                ref = ref[:, rank * per:(rank + 1) * per]
            ref = ref.view(torch.uint8) if ref.dtype == FP8 else ref
            ref = ref.float() if ref.dtype == torch.bfloat16 else ref
            got_t = torch.from_numpy(got_f)
            assert torch.equal(token_major(got_t, head_major), ref)


@pytest.mark.parametrize("start", [8, 24])
@pytest.mark.parametrize("head_major", [False, True], ids=["token_major", "head_major"])
@pytest.mark.parametrize("kind", ["bf16", "e4m3", "int8"])
@pytest.mark.parametrize("mode", ["ulysses", "ring_pass_q", "ring_pass_kv"])
def test_island_sp2(pools, mode, kind, head_major, start):
    """sp = 2 over a 64-slot cache: the block [8, 24) leaves rank 1's slots
    [32, 64) empty (its local span skips the kernel, lse -inf); [24, 40)
    crosses into them."""
    _run_island(pools[2], mode, kind, head_major, start)


@pytest.mark.parametrize("mode", ["ulysses", "ring", "ring_pass_kv"])
def test_island_sp4_padded(pools, mode):
    """sp = 4 over a head-major int8 cache whose 60 live slots are padded
    to 64: rank 3 holds the 4 padded slots and the ring modes' live spans
    end inside rank 2's."""
    _run_island(pools[4], mode, "int8", True, 40, max_tokens=60, alloc_tokens=64)


@pytest.mark.parametrize("mode", ["ring_pass_q", "ring_pass_kv"])
def test_island_rolling_window_wraps(pools, mode):
    """A rolling window of 64 slots with 16 sink slots: the block at
    positions [120, 136) wraps at slot 64 back to slot 16, so its rows land
    in both ranks' slots."""
    _run_island(pools[2], mode, "int8", True, 120, ring=True, sink_tokens=16)


# --- merge and the non-cache primitives against JAX ---

def test_merge_attention_partials_matches_jax():
    rng = np.random.default_rng(40)
    outs = rng.standard_normal((3, 2, 5, 4, 8)).astype(np.float32)
    lses = (rng.standard_normal((3, 2, 4, 5)) * 4).astype(np.float32)
    lses[1, 0, 2] = -np.inf  # an empty partial
    got = merge_attention_partials(torch.from_numpy(outs), torch.from_numpy(lses))
    want = jax_merge(jnp.asarray(outs), jnp.asarray(lses))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("sp,name", [(2, "ulysses_attention"), (2, "ring_attention"),
                                     (2, "ring_attention_pass_q"), (4, "ring_attention"),
                                     (4, "ring_attention_pass_q")])
def test_sp_attention_matches_jax(pools, sp, name):
    rng = np.random.default_rng(41)
    q, k, v = (rng.standard_normal((1, 32, H, D)).astype(np.float32) for _ in range(3))
    mesh = jax_make_mesh(JaxParallelConfig(dp=1, sp=sp, tp=1, pp=1))
    want = getattr(jsp, name)(mesh, *map(jnp.asarray, (q, k, v)))
    got = np.concatenate(pools[sp].run(ranks.attention, name, q, k, v), axis=1)
    np.testing.assert_allclose(got, np.asarray(want), rtol=1e-5, atol=1e-5)


# --- whole generation ---

@pytest.fixture(scope="module")
def wan():
    """The JAX tiny tree, and the JAX inputs of `_generate`: text features,
    3 frames of noise, the renoise its key schedule draws."""
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
    return jp, jax.tree.map(np.asarray, jp), ctx, noise, renoise


def _cfg(mode, kind="float32", head_major=False, alloc_pad=False):
    cfg = tiny_test_config()
    cfg.parallel = ParallelConfig(sp=2, sp_mode=mode)
    cfg.runtime.kv_head_major, cfg.runtime.kv_alloc_pad = head_major, alloc_pad
    if kind != "float32":
        cfg.quant.enabled = cfg.quant.quantize_kv_cache = True
        cfg.quant.kv_cache_dtype = "fp8" if kind == "e4m3" else "int8"
    return cfg


JAX_CASES = {"ulysses": ("ulysses", "float32", False, False),
             "ring": ("ring", "float32", False, False),
             "ring_pass_q": ("ring_pass_q", "float32", False, False),
             "ring_pass_kv": ("ring_pass_kv", "float32", False, False),
             "ring_pass_q_int8_head_major": ("ring_pass_q", "int8", True, False),
             "ulysses_int8_head_major_padded": ("ulysses", "int8", True, True)}


@pytest.mark.parametrize("case", list(JAX_CASES))
def test_generate_matches_jax_mesh(pools, wan, case):
    mode, kind, hm, pad = JAX_CASES[case]
    jp, params_np, ctx, noise, renoise = wan
    jcfg = jax_tiny_config()
    jcfg.parallel = JaxParallelConfig(dp=1, sp=2, tp=1, pp=1, sp_mode=mode)
    jcfg.runtime.kv_head_major, jcfg.runtime.kv_alloc_pad = hm, pad
    if kind == "int8":
        jcfg.quant.enabled = jcfg.quant.quantize_kv_cache = True
    want = jax_generate(jcfg, jp, mesh=jax_make_mesh(jcfg.parallel))
    res = pools[2].run(ranks.generate, _cfg(mode, kind, hm, pad).to_dict(), params_np, ctx,
                       noise, renoise)
    assert np.array_equal(res[0], res[1])  # every rank returns the whole latents
    np.testing.assert_allclose(res[0], want, rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("head_major", [False, True], ids=["token_major", "head_major"])
@pytest.mark.parametrize("kind", ["float32", "e4m3", "int8"])
@pytest.mark.parametrize("mode", ["ulysses", "ring_pass_q", "ring_pass_kv"])
def test_generate_matches_single_device(pools, wan, mode, kind, head_major):
    """The float32 model's own cache dtype stands for bf16 here (the card's
    run, chip_smoke.py phase 36, has the bf16 one)."""
    _, params_np, ctx, noise, renoise = wan
    cfg = _cfg(mode, kind, head_major)
    res = pools[2].run(ranks.generate, cfg.to_dict(), params_np, ctx, noise, renoise)
    single = copy.deepcopy(cfg)
    single.parallel = ParallelConfig()
    gen = SemiARGenerator(single, params_from_numpy(params_np, "cpu", torch.float32),
                          dtype=torch.float32, device="cpu")
    want, _ = gen.generate(torch.from_numpy(noise),
                           gen.encode_text_context(torch.from_numpy(ctx)),
                           renoise=[[torch.from_numpy(r) for r in blk] for blk in renoise])
    assert np.array_equal(res[0], res[1])
    np.testing.assert_allclose(res[0], want.numpy(), rtol=1e-5, atol=1e-5)


# --- accounting and refusals ---

def test_sp_comm_bytes_per_layer_matches_jax():
    for mode in ("none", "ulysses", "cso", "ring", "ring_pass_q", "ring_pass_kv"):
        for sp, tp, b in ((1, 1, 1), (2, 1, 1), (4, 1, 2), (2, 2, 1), (6, 1, 1)):
            args = (mode, sp, tp, b, 4680, 32760, 12, 128)
            for itemsize in (1, 2, 4):
                assert tda.sp_comm_bytes_per_layer(*args, itemsize=itemsize) == \
                    jda.sp_comm_bytes_per_layer(*args, itemsize=itemsize), (args, itemsize)


@pytest.mark.parametrize("axis,item", [("tp", "A13b"), ("dp", "A13b"), ("pp", "A13c")])
def test_tp_dp_pp_refused(axis, item):
    """Since A13b (tensor and data parallelism) tp and dp build, and since
    A13c (pipeline parallelism) pp too, through the config's dict as well;
    an axis of 0 is refused."""
    d = EngineConfig().to_dict()
    d["parallel"][axis] = 2
    assert getattr(ParallelConfig(**{axis: 2}), axis) == 2
    cfg = EngineConfig.from_dict(d)
    assert getattr(cfg.parallel, axis) == 2 and cfg.parallel.world_size == 2
    assert EngineConfig.from_dict(cfg.to_dict()).parallel == cfg.parallel
    with pytest.raises(ValueError, match=f"parallel.{axis}"):
        ParallelConfig(**{axis: 0})


def test_shapes_that_do_not_split_and_modes():
    cfg = tiny_test_config()   # 4 heads, 16 tokens a frame, 96 cache slots
    m, r = cfg.model, cfg.runtime
    geo = (m, 1, 1, r.latent_height, r.latent_width, torch.float32)
    with pytest.raises(ValueError, match="tokens a frame"):
        make_statics(*geo, mesh=SPMesh(0, 3, "gloo", "cpu"), sp_mode="ring_pass_q")
    with pytest.raises(ValueError, match="heads"):
        make_statics(*geo, mesh=SPMesh(0, 8, "gloo", "cpu"), sp_mode="ulysses")
    with pytest.raises(ValueError, match="sp_mode"):
        ParallelConfig(sp=2, sp_mode="cso")
    with pytest.raises(ValueError, match="backend"):
        SPMesh(0, 2, "mpi", "cpu")
    # "auto" and a mesh of one run no island, as in the JAX generator
    params = init_params(m, torch.Generator().manual_seed(0), "cpu", torch.float32)
    for mode, size in (("auto", 2), ("ulysses", 1)):
        cfg.parallel = ParallelConfig(sp=size, sp_mode=mode)
        gen = SemiARGenerator(cfg, params, dtype=torch.float32, device="cpu",
                              mesh=SPMesh(0, size, "gloo", "cpu"))
        assert gen.sp_mode == "none" and gen.statics.shard.axis == "none"
        assert gen.sp_comm_bytes == 0
