"""Pipeline parallelism, MAGI at dp > 1, the tiled and disaggregated decodes
and multi-host start-up of the port (`inferix_tpu_torch/parallel/`:
`pipeline_parallel.py`, the pp axis of `mesh.py`, `tile_parallel.py`,
`disaggregated.py`, `multihost.py`) on the CPU. One module-scoped
`RankPool` of 4 gloo ranks hosts every layout (a layout of fewer ranks
leaves the others idle), the rank-side work in `tests/torch_pp_ranks.py`.

- `pp_pipeline` on the JAX tests' toy layer at (pp, m) in (2, 4), (4, 4),
  (2, 1), (4, 2), (1, 3) against a sequential loop (1e-5), (2, 4) also
  against the JAX `pp_pipeline` on its 8 virtual CPU devices; the state
  threaded through the stages; each rank's layer applications m L / pp;
  L % pp != 0 refused;
- the grid: pp the fastest axis, the groups built once a stage, at pp 1
  the groups of the (dp, sp, tp) grid;
- Wan `generate` at pp 2 and B = 2 (the rows the microbatches) against the
  JAX generator's run of the same inputs at its 5e-4
  (`tests/test_pipeline_parallel.py`, whose pp 2 run equals its one-device
  run within that); W8A8 and the int8 cache at pp 2 within the
  quantization's noise floor of the port's one-device run (the JAX dryrun's
  bound, as in `tests/test_torch_tp.py`); tp 2 x pp 2 equal to tp 2 (1e-5);
  30 % 4 refused;
- MAGI: the walk at pp 2 against the JAX walk (5e-4), the head-major cache
  bit-equal to the token-major one at pp 2; cso tp 2 x pp 2, 3-CFG, per
  chunk, with the 24B switches against the port's one device (1e-5 in
  norm) and the JAX one-device walk (rtol 3e-4, atol 1e-3, the JAX test's
  bound for its composed walk), and cso sp 2 x pp 2 likewise; the 3-CFG
  walk at dp 2 against one device (1e-5 in norm); a 3-CFG window forward at dp 2 x pp 2 with its row sync, velocity and
  cache, against one device; the fully manual int8 cache refused with the
  JAX text. tp 2 x sp 2 x pp 2 needs 8 ranks: no pool here or on the
  card has them;
- the tile and disaggregated decodes against the JAX functions and
  classes on the same numpy inputs (1e-5), the streaming pipeline with the
  disaggregated decode against the local one, and the two fixes: params
  changed after construction reach the decode, and a carried cache of
  another width raises;
- multi-host: two processes joining through COORDINATOR_ADDRESS /
  NUM_PROCESSES / PROCESS_ID, an all-reduce across them and process 0's
  interactive decision on both, its oversized prompt halved.
"""
import copy
import dataclasses
import os
import socket
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from inferix_tpu.core.config import ParallelConfig as JaxParallelConfig
from inferix_tpu.core.config import tiny_test_config as jax_tiny_config
from inferix_tpu.models.magi import dit as jdit
from inferix_tpu.models.magi import vae as jvae
from inferix_tpu.models.wan.causal_dit import init_params as jax_init_params
from inferix_tpu.models.wan.vae import CausalVAE as JaxCausalVAE
from inferix_tpu.models.wan.vae import VAEConfig as JaxVAEConfig
from inferix_tpu.parallel import disaggregated as jdis
from inferix_tpu.parallel import tile_parallel as jtile
from inferix_tpu.parallel.mesh import make_mesh as jax_make_mesh
from inferix_tpu.parallel.pipeline_parallel import pp_pipeline as jax_pp_pipeline
from inferix_tpu.pipeline import magi as jpipe
from inferix_tpu_torch.core.config import ParallelConfig, QuantConfig, tiny_test_config
from inferix_tpu_torch.core.types import StreamingMode
from inferix_tpu_torch.models.magi import dit as tdit
from inferix_tpu_torch.models.magi.vae import ViTVAE, ViTVAEConfig, init_vitvae_params
from inferix_tpu_torch.models.wan.vae import CausalVAE, VAEConfig
from inferix_tpu_torch.parallel import disaggregated as tdis
from inferix_tpu_torch.parallel import tile_parallel as ttile
from inferix_tpu_torch.parallel.launch import RankPool
from inferix_tpu_torch.parallel.mesh import Mesh, SPMesh, _layout_groups, grid_place
from inferix_tpu_torch.parallel.pipeline_parallel import stage_layers
from inferix_tpu_torch.pipeline import magi as tpipe
from inferix_tpu_torch.pipeline.self_forcing import SelfForcingPipeline
from inferix_tpu_torch.pipeline.semi_ar import SemiARGenerator
from inferix_tpu_torch.utils.params import init_params, init_vae_params, params_from_numpy

import torch_pp_ranks as ranks
from test_distributed_attention import _generate as jax_generate
from test_torch_magi_pipeline import jax_noise
from test_torch_semi_ar import _jax_renoise

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = dict(rtol=1e-5, atol=1e-5)
PP_JAX_TOL = dict(rtol=5e-4, atol=5e-4)       # tests/test_pipeline_parallel.py's pp 2 bound
COMPOSED_JAX_TOL = dict(rtol=3e-4, atol=1e-3)  # its composed tp x pp bound
# the composed walk against the port's one device, in norm: the rows run as
# microbatches of one (other float32 GEMM blockings) and the tp sums take
# another order; x_rescale 0.1 multiplies the velocity by 10 and the 3-CFG
# combination the cond / uncond gap by up to 8.5, so single elements move
# by up to ~5e-4 (measured 6.9e-6 in norm)
COMPOSED_RTOL = 1e-5   # also the dp 2 walk's
PP2 = ParallelConfig(pp=2, sp_mode="auto")


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One torch thread in this process (the ranks take one each too): the
    tier-1 run puts several test processes on the machine's cores at once,
    and the VAE convs' thread pools would contend."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def pool(tmp_path_factory):
    """4 gloo ranks, one process each on the CPU."""
    d = tmp_path_factory.mktemp("pp_store")
    p = RankPool(4, "gloo", f"file://{d / 'store'}", device="cpu", threads=1, timeout=300)
    yield p
    p.close()


def _run(pool, layout, fn, *args):
    """fn on the layout's ranks: their results in rank order (idle ranks'
    dropped)."""
    return [r for r in pool.run(fn, *args, layout=layout) if r is not None]


def _drift(got, want):
    return float(np.abs(got - want).max() / (np.abs(want).max() + 1e-9))


def _fake_mesh(**sizes):
    """A rank-0 Mesh whose groups have the given sizes (no process group:
    for the checks made before any exchange)."""
    g = {n: SPMesh(0, sizes.get(n, 1), "gloo", "cpu", name=n) for n in ("sp", "tp", "dp", "pp")}
    return Mesh(cfg=ParallelConfig(**sizes), rank=0, backend="gloo", device=torch.device("cpu"),
                sp=g["sp"], tp=g["tp"], dp=g["dp"], heads=g["sp"], pp=g["pp"])


# --- pp_pipeline ---

def _toy(L=8, d=16, m=4, seed=0):
    """The JAX tests' `_make`: float32 weights and m microbatches of 2 rows."""
    rng = np.random.default_rng(seed)
    w = (rng.standard_normal((L, d, d)) * 0.3).astype(np.float32)
    b = (rng.standard_normal((L, d)) * 0.1).astype(np.float32)
    return w, b, rng.standard_normal((m, 2, d)).astype(np.float32)


def _sequential(w, b, mb, state=None):
    outs = []
    for x in mb:
        h = torch.from_numpy(x)
        for layer in range(w.shape[0]):
            if state is not None:
                state[layer] += h.sum(dim=0).numpy()
            h = torch.tanh(h @ torch.from_numpy(w[layer]) + torch.from_numpy(b[layer]))
        outs.append(h.numpy())
    return np.stack(outs)


@pytest.mark.parametrize("pp,m", [(2, 4), (4, 4), (2, 1), (4, 2), (1, 3)])
def test_pp_pipeline_matches_sequential(pool, pp, m):
    """Every rank ends with the outputs of the sequential loop, after m L/pp
    layer applications of its own; (2, 4) is also the JAX pp_pipeline's."""
    w, b, mb = _toy(m=m)
    want = _sequential(w, b, mb)
    res = _run(pool, ParallelConfig(pp=pp), ranks.toy_pipeline, w, b, mb)
    assert len(res) == pp
    for out, _, applied in res:
        np.testing.assert_allclose(out, want, **TOL)
        assert applied == m * w.shape[0] // pp
    assert all(np.array_equal(res[0][0], r[0]) for r in res)
    if (pp, m) == (2, 4):
        mesh = jax_make_mesh(JaxParallelConfig(dp=1, sp=1, tp=1, pp=pp))
        got, _ = jax_pp_pipeline(mesh, lambda p, s, h: (jnp.tanh(h @ p["w"] + p["b"]), s),
                                 {"w": jnp.asarray(w), "b": jnp.asarray(b)}, jnp.asarray(mb))
        np.testing.assert_allclose(res[0][0], np.asarray(got), **TOL)


def test_pp_pipeline_threads_layer_state(pool):
    """The JAX test's per-layer accumulator: each stage's layers see each
    microbatch once; the stages' states together are the sequential one."""
    L, d, m = 4, 8, 3
    rng = np.random.default_rng(1)
    w = (rng.standard_normal((L, d, d)) * 0.2).astype(np.float32)
    b = np.zeros((L, d), np.float32)
    mb = rng.standard_normal((m, 2, d)).astype(np.float32)
    want_state = np.zeros((L, d), np.float32)
    want = _sequential(w, b, mb, want_state)
    res = _run(pool, ParallelConfig(pp=2), ranks.toy_pipeline, w, b, mb,
               np.zeros((L, d), np.float32))
    for out, _, _ in res:
        np.testing.assert_allclose(out, want, **TOL)
    np.testing.assert_allclose(np.concatenate([r[1] for r in res]), want_state, **TOL)


def test_stage_layers_refuses_a_split():
    """L % pp != 0 raises ValueError (the JAX pipeline asserts it); pp 1
    keeps the tree."""
    tree = {"w": torch.zeros(6, 2)}
    with pytest.raises(ValueError, match="6 layers do not split over pp 4"):
        stage_layers(tree, _fake_mesh(pp=4))
    assert stage_layers(tree, _fake_mesh()) is tree
    got = stage_layers({"w": torch.arange(6.0)[:, None]}, SPMesh(1, 3, "gloo", "cpu"))
    assert got["w"].flatten().tolist() == [2.0, 3.0]


def test_tree_copies_keep_named_tuples():
    """A tree with named tuples (the halo convs' `PackedWeight` in a VAE's
    params, a `KVCache` as a pipeline's state) keeps them: a VAE copy on a
    decode card, a stage's layers of a cache."""
    from inferix_tpu_torch.kvcache.cache import KVCache
    from inferix_tpu_torch.ops.halo_conv import PackedWeight

    pw = PackedWeight(torch.ones(1, 9, 2, 2), None)
    got = ttile._tree_to({"conv": {"packed": pw, "b": [torch.zeros(2)]}}, torch.device("cpu"))
    assert isinstance(got["conv"]["packed"], PackedWeight) and got["conv"]["packed"].s_w is None
    assert torch.equal(got["conv"]["packed"].wk, pw.wk) and isinstance(got["conv"]["b"], list)
    cache = KVCache(torch.arange(4.0), torch.arange(4.0) + 4)
    half = stage_layers(cache, SPMesh(1, 2, "gloo", "cpu"))
    assert isinstance(half, KVCache) and half.k.tolist() == [2.0, 3.0] and half.k_scale is None


# --- the grid ---

def test_grid_pp_fastest_and_groups_a_stage(pool):
    """Global rank ((d sp + s) tp + t) pp + p: tp 2 x pp 2 puts the stages of
    a tp rank next to each other; the tp groups are built once a stage; at
    pp 1 the groups are the (dp, sp, tp) grid's."""
    lay = ParallelConfig(tp=2, pp=2)
    res = _run(pool, lay, ranks.where)
    for rank, (place, stage, groups) in enumerate(res):
        assert place == grid_place(lay, rank) == (0, 0, rank // 2, rank % 2)
        assert stage == rank % 2
        assert groups["tp"] == (rank // 2, 2) and groups["pp"] == (rank % 2, 2)
    groups = dict((n, g) for n, g in _layout_groups(lay) if n == "pp")
    assert groups["pp"] == [[0, 1], [2, 3]]
    assert [g for n, g in _layout_groups(lay) if n == "tp"] == [[[0, 2]], [[1, 3]]]
    flat = ParallelConfig(dp=2, sp=2, tp=2)
    r = lambda d, s, t: (d * 2 + s) * 2 + t  # noqa: E731 - the (dp, sp, tp) grid
    want = {
        "sp": [[r(d, s, t) for s in range(2)] for d in range(2) for t in range(2)],
        "tp": [[r(d, s, t) for t in range(2)] for d in range(2) for s in range(2)],
        "dp": [[r(d, s, t) for d in range(2)] for s in range(2) for t in range(2)],
        "heads": [[r(d, s, t) for t in range(2) for s in range(2)] for d in range(2)],
        "pp": [[i] for i in range(8)]}
    assert _layout_groups(flat) == list(want.items())


def test_pp_config_builds():
    cfg = ParallelConfig(tp=2, pp=2)
    assert cfg.world_size == 4 and cfg.axis_sizes()["pp"] == 2
    with pytest.raises(ValueError, match="parallel.pp"):
        ParallelConfig(pp=0)


# --- Wan ---

@pytest.fixture(scope="module")
def wan():
    """The JAX tiny tree (numpy) and the B = 2 inputs of `_generate` (text,
    3 frames of noise, the renoise its key schedule draws), with the JAX
    generator's latents of them."""
    jcfg = jax_tiny_config()
    jcfg.runtime.batch_size = 2
    jp = jax_init_params(jax.random.key(0), jcfg.model, dtype=jnp.float32)
    m, r = jcfg.model, jcfg.runtime
    ctx = np.array(jax.random.normal(jax.random.key(7), (2, m.text_len, m.text_dim)))
    noise = np.array(jax.random.normal(
        jax.random.key(1), (2, 3, r.latent_height, r.latent_width, r.latent_channels)))
    key, renoise = jax.random.key(2), []
    for _ in range(3):
        key, step = jax.random.split(key)
        renoise.append([x.numpy() for x in _jax_renoise(step, len(r.denoising_step_list),
                                                        (2, 1) + noise.shape[2:])])
    return jax.tree.map(np.asarray, jp), (ctx, noise, renoise), jax_generate(jcfg, jp)


def _wan_cfg(layout=None, kv="float32", w8a8=False, mode="auto"):
    cfg = tiny_test_config()
    cfg.runtime.batch_size = 2
    if layout is not None:
        cfg.parallel = dataclasses.replace(layout, sp_mode=mode)
    if kv == "int8":
        cfg.quant.enabled = cfg.quant.quantize_kv_cache = True
        cfg.runtime.kv_head_major = cfg.runtime.kv_alloc_pad = True
    if w8a8:
        cfg.quant = QuantConfig(enabled=True, dtype="int8")
    return cfg


def test_wan_pp2_generate_matches_jax(pool, wan):
    """3 blocks at pp 2 over the two rows: each rank's latents the JAX
    generator's, bit-equal on both ranks, 2 rows x 1 layer x 3 forwards a
    block on each rank."""
    params_np, inputs, want = wan
    res = _run(pool, PP2, ranks.wan_generate, _wan_cfg(PP2).to_dict(), params_np, *inputs)
    for lat, mode, sent, applied in res:
        assert mode == "none" and sent["pp"][0] > 0
        np.testing.assert_allclose(lat, want, **PP_JAX_TOL)
        assert applied == 2 * 1 * 3 * 3
    assert np.array_equal(res[0][0], res[1][0])


def _wan_single(cfg, params_np, inputs, w8a8=False):
    single = copy.deepcopy(cfg)
    single.parallel = ParallelConfig()
    return ranks.wan_generate(None, single.to_dict(), params_np, *inputs, w8a8)[0]


@pytest.mark.parametrize("case", ["w8a8", "int8_cache"])
def test_wan_pp2_quantized_within_noise_floor(pool, wan, case):
    """W8A8 or the int8 cache (head-major, padded) at pp 2 against the
    port's one device, within the quantization's own drift from the float
    run."""
    params_np, inputs, _ = wan
    inputs = (inputs[0], inputs[1][:, :2], inputs[2][:2])
    w8a8 = case == "w8a8"
    cfg = _wan_cfg(PP2, kv="int8" if case == "int8_cache" else "float32", w8a8=w8a8)
    res = _run(pool, PP2, ranks.wan_generate, cfg.to_dict(), params_np, *inputs, w8a8)
    want = _wan_single(cfg, params_np, inputs, w8a8)
    floor = _drift(want, _wan_single(_wan_cfg(), params_np, inputs))
    for lat, *_ in res:
        assert _drift(lat, want) < floor, (_drift(lat, want), floor)
    assert np.array_equal(res[0][0], res[1][0])


def test_wan_tp2_pp2_equals_tp2(pool, wan):
    """tp 2 inside each of 2 stages against tp 2 alone (no island: "auto"),
    2 blocks; and with the ulysses island the pp ranks hold the whole stack
    and run the island, as the JAX package does, equal to tp 2 with it."""
    params_np, inputs, _ = wan
    inputs = (inputs[0], inputs[1][:, :2], inputs[2][:2])
    for mode in ("auto", "ulysses"):
        tp2 = _run(pool, ParallelConfig(tp=2), ranks.wan_generate,
                   _wan_cfg(ParallelConfig(tp=2), mode=mode).to_dict(), params_np, *inputs)
        lay = ParallelConfig(tp=2, pp=2)
        res = _run(pool, lay, ranks.wan_generate, _wan_cfg(lay, mode=mode).to_dict(),
                   params_np, *inputs)
        for lat, got_mode, sent, applied in res:
            assert got_mode == ("none" if mode == "auto" else "ulysses")
            assert (sent["pp"][0] > 0) == (mode == "auto")
            assert applied == (2 * 1 * 3 * 2 if mode == "auto" else 0)
            np.testing.assert_allclose(lat, tp2[0][0], **TOL)


def test_wan_pp4_refused():
    """30 layers (here 2) do not split over pp 4: the generator refuses."""
    cfg = _wan_cfg(ParallelConfig(pp=4))
    params = init_params(cfg.model, torch.Generator().manual_seed(0), "cpu", torch.float32)
    with pytest.raises(ValueError, match="do not split over pp 4"):
        SemiARGenerator(cfg, params, dtype=torch.float32, device="cpu", mesh=_fake_mesh(pp=4))


# --- MAGI ---

MAGI_RT = dict(num_steps=2, window_size=2, chunk_width=2)


def _magi_inputs(jcfg, chunks=3, seed=1234, zeros=False):
    cap = (np.zeros if zeros else np.ones)(
        (1, jcfg.caption_max_length, jcfg.caption_channels), np.float32) * 0.1
    mask = np.ones((1, jcfg.caption_max_length), np.int32)
    return cap, mask, jax_noise(seed, (1, chunks * 2, 8, 8, jcfg.latent_channels))


def _jax_walk(jcfg, jp, rt_kw, cap, mask, chunks):
    pipe = jpipe.MagiPipeline(jcfg, jpipe.MagiRuntimeConfig(**rt_kw), params=jp, latent_h=8,
                              latent_w=8, max_chunks=6, dtype=jnp.float32)
    return [np.asarray(c) for _, c in pipe.generate_chunks(jnp.asarray(cap), jnp.asarray(mask),
                                                           chunk_num=chunks)]


def test_magi_pp2_walk_matches_jax(pool):
    """The JAX test's walk (cfg_number 1: under pp the batch is the two
    halves anyway) at pp 2 against the JAX one-device walk, and the
    head-major cache at pp 2 bit-equal to the token-major one."""
    jcfg = jdit.tiny_magi_config()
    jp = jdit.init_magi_params(jax.random.key(0), jcfg, jnp.float32)
    cap, mask, noise = _magi_inputs(jcfg)
    want = _jax_walk(jcfg, jp, dict(cfg_number=1, **MAGI_RT), cap, mask, 3)
    params_np = jax.tree.map(np.asarray, jp)
    runs = [_run(pool, PP2, ranks.magi_walk, dataclasses.asdict(jcfg),
                 dict(cfg_number=1, kv_head_major=hm, **MAGI_RT), params_np, cap, mask,
                 noise, 3) for hm in (False, True)]
    for chunks, mode, sent, applied in runs[0]:
        assert mode == "none" and sent["pp"][0] > 0 and applied > 0
        assert len(chunks) == len(want) == 3
        for g, w in zip(chunks, want):
            np.testing.assert_allclose(g, w, **PP_JAX_TOL)
    for a, b in zip(*runs):
        assert all(np.array_equal(x, y) for x, y in zip(a[0], b[0]))


@pytest.fixture(scope="module")
def composed():
    """The JAX composed test's model (the 24B switches: the gated fc1,
    x_rescale 0.1, GQA of 4 over 4), its inputs, and the port's one-device
    and the JAX one-device 3-CFG per-chunk walks of them."""
    jcfg = dataclasses.replace(jdit.tiny_magi_config(), num_attention_heads=4,
                               num_query_groups=4, gated_linear_unit=True,
                               x_rescale_factor=0.1)
    jp = jdit.init_magi_params(jax.random.key(5), jcfg, jnp.float32)
    cap, mask, noise = _magi_inputs(jcfg, chunks=2, zeros=True)
    rt = dict(cfg_number=3, window_dispatch="per_chunk", **MAGI_RT)
    params_np = jax.tree.map(np.asarray, jp)
    single, *_ = ranks.magi_walk(None, dataclasses.asdict(jcfg), rt, params_np, cap, mask,
                                 noise, 2)
    return (jcfg, rt, params_np, (cap, mask, noise), single,
            _jax_walk(jcfg, jp, rt, cap, mask, 2))


@pytest.mark.parametrize("layout", ["tp2_pp2", "sp2_pp2"])
def test_magi_composed_cso_pp2_cfg3(pool, composed, layout):
    """cso tp 2 or sp 2 inside each of 2 stages (the composed layouts of
    four ranks; the JAX test's tp 2 x sp 2 x pp 2 needs eight), 3-CFG, per
    chunk, with the 24B switches: against the port's one device and the JAX
    one-device walk."""
    jcfg, rt, params_np, (cap, mask, noise), single, want = composed
    lay = ParallelConfig(tp=2, pp=2) if layout == "tp2_pp2" else ParallelConfig(sp=2, pp=2)
    res = _run(pool, lay, ranks.magi_walk, dataclasses.asdict(jcfg), dict(rt, cp_strategy="cso"),
               params_np, cap, mask, noise, 2)
    island = "tp" if layout == "tp2_pp2" else "sp"
    for chunks, mode, sent, applied in res:
        assert mode == "cso" and sent[island][0] > 0 and sent["pp"][0] > 0
        for g, s, w in zip(chunks, single, want):
            assert np.linalg.norm(g - s) / np.linalg.norm(s) <= COMPOSED_RTOL
            np.testing.assert_allclose(g, w, **COMPOSED_JAX_TOL)


def test_magi_dp2_cfg3_walk_matches_single_device(pool):
    """The 3-CFG walk with its two rows on two dp ranks (velocity rows
    gathered for the combination, the row sync sent from dp rank 1 to dp
    rank 0) against the port's one device: 1e-5 in norm (each rank's
    GEMMs run one row, the CFG combination magnifies the float32 order
    noise by up to 8.5; measured elements within 1.6e-5)."""
    jcfg = jdit.tiny_magi_config()
    params_np = jax.tree.map(np.asarray, jdit.init_magi_params(jax.random.key(3), jcfg,
                                                               jnp.float32))
    cap, mask, noise = _magi_inputs(jcfg, chunks=2)
    rt = dict(cfg_number=3, **MAGI_RT)
    res = _run(pool, ParallelConfig(dp=2), ranks.magi_walk, dataclasses.asdict(jcfg), rt,
               params_np, cap, mask, noise, 2)
    want, *_ = ranks.magi_walk(None, dataclasses.asdict(jcfg), rt, params_np, cap, mask,
                               noise, 2)
    for chunks, _, sent, _ in res:
        assert sent["dp"][0] > 0
        for g, w in zip(chunks, want):
            assert np.linalg.norm(g - w) / np.linalg.norm(w) <= COMPOSED_RTOL
            np.testing.assert_allclose(g, w, rtol=1e-4, atol=1e-4)


def test_magi_dp2_pp2_window_row_sync(pool):
    """One 3-CFG window forward with the row sync at dp 2 x pp 2 (head-major
    cache): each rank's velocity row and its stage's layers of its cache
    row against one device's."""
    jcfg = jdit.tiny_magi_config()
    params_np = jax.tree.map(np.asarray, jdit.init_magi_params(jax.random.key(4), jcfg,
                                                               jnp.float32))
    rng = np.random.default_rng(5)
    x = np.repeat(rng.standard_normal((1, 4, 8, 8, 16)).astype(np.float32), 2, axis=0)
    t = np.array([[0.3, 0.7]] * 2, np.float32)
    caps = rng.standard_normal((2, 2, 8, 64)).astype(np.float32)
    masks = np.ones((2, 2, 8), np.float32)
    args = (dataclasses.asdict(jcfg), params_np, x, t, caps, masks, [[0, 1], [0, 2]], True)
    v1, fields1 = ranks.magi_window(None, *args)
    lay = ParallelConfig(dp=2, pp=2)
    res = _run(pool, lay, ranks.magi_window, *args)
    for rank, (v, fields) in enumerate(res):
        d, _, _, p = grid_place(lay, rank)
        np.testing.assert_allclose(v, v1[d:d + 1], **TOL)
        for got, want in zip(fields, fields1):
            np.testing.assert_allclose(got, want[p:p + 1, d:d + 1], **TOL)
    # the sync: row 0's window span is row 1's on every layer
    assert all(np.array_equal(f[:, 0], f[:, 1]) for f in fields1)


def test_magi_pp_statics_and_int8_refusal():
    """A pp mesh: batch 2 even at cfg_number 1, the cache a stage's layers;
    the int8 cache without sp or tp > 1 refused with the JAX text; the fp8
    distill layout has no stacked blocks to pipeline."""
    cfg = tdit.tiny_magi_config()
    mesh = _fake_mesh(pp=2)
    pipe = tpipe.MagiPipeline(cfg, tpipe.MagiRuntimeConfig(cfg_number=1, **MAGI_RT),
                              latent_h=8, latent_w=8, max_chunks=4, dtype=torch.float32,
                              device="cpu", mesh=mesh)
    assert pipe.batch == 2 and pipe.statics.spec.num_layers == 1
    assert pipe.params["blocks"]["q"]["w"].shape[0] == 1
    with pytest.raises(NotImplementedError, match="fully-manual pp pipeline is not wired"):
        tdit.make_magi_statics(cfg, 2, 8, 8, 4, torch.float32, mesh=mesh, quantize_kv=True)
    with pytest.raises(ValueError, match="do not split over pp 4"):
        tdit.make_magi_statics(cfg, 2, 8, 8, 4, torch.float32, mesh=_fake_mesh(pp=4))


# --- the tile and disaggregated decodes ---

def test_tile_geometry_and_blends_match_jax():
    """split_tiles, _blend_axis, _split_w and PixelTiles.assemble against
    the JAX functions on the same numpy inputs."""
    for args in ((8, 33, 17, 8, 16, 16, 4, 4), (5, 12, 12, 2, 4, 4, 2, 2, 1),
                 (2, 8, 8, 2, 4, 4, 2, 2)):
        assert ([dataclasses.astuple(t) for t in ttile.split_tiles(*args)]
                == [dataclasses.astuple(t) for t in jtile.split_tiles(*args)])
    rng = np.random.default_rng(6)
    out, new = rng.random((1, 3, 6, 6, 3)), rng.random((1, 3, 6, 6, 3))
    for axis in (1, 2, 3):
        np.testing.assert_array_equal(ttile._blend_axis(out, new.copy(), axis, 2),
                                      jtile._blend_axis(out, new.copy(), axis, 2))
    for w, n, ov in ((16, 4, 2), (16, 1, 2), (13, 3, 1)):
        assert tdis._split_w(w, n, ov) == jdis._split_w(w, n, ov)
    spans = tdis._split_w(16, 3, 2)
    tiles = [rng.random((1, 3, 8, (w1 - w0) * 8, 3)).astype(np.float32)
             for w0, w1, _, _ in spans]
    got = tdis.PixelTiles([torch.from_numpy(t) for t in tiles], spans, 8)
    want = jdis.PixelTiles([jnp.asarray(t) for t in tiles], spans, 8)
    assert got.shape == want.shape == (1, 3, 8, 128, 3)
    np.testing.assert_allclose(got.synchronize().assemble(), want.assemble(), **TOL)


def test_tile_processor_blends():
    """The JAX tests' identity blend (the input back through overlapping
    tiles) and upscale (a 2x nearest upsample of ones stays ones), and the
    big-first strided assignment."""
    x = torch.from_numpy(np.random.default_rng(0).random((1, 4, 24, 24, 3)).astype(np.float32))
    out = ttile.TileProcessor(fn=lambda c: c).process(x, 4, 16, 16, 8, 8)
    np.testing.assert_allclose(out, x.numpy(), atol=1e-6)
    up = ttile.TileProcessor(fn=lambda c: c.repeat_interleave(2, 2).repeat_interleave(2, 3),
                             scale_hw=2).process(torch.ones(1, 2, 8, 8, 3), 2, 4, 4, 2, 2)
    assert up.shape == (1, 2, 16, 16, 3)
    np.testing.assert_allclose(up, 1.0, atol=1e-6)
    tiles = ttile.split_tiles(1, 10, 6, 1, 4, 6, 0, 0)   # heights 4, 4, 2
    where = ttile.TileProcessor(lambda c: c, devices=["cpu", "cpu"]).assignment(
        tiles, torch.device("cpu"))
    assert len(where) == 3 and all(d == torch.device("cpu") for d in where)


@pytest.fixture(scope="module")
def magi_vae():
    """A tiny ViT-VAE (z 16) in both packages, from one tree drawn by the
    port (the JAX initialiser takes ~15 s here)."""
    vcfg = dataclasses.replace(jvae.tiny_vitvae_config(), z_chans=16)
    tcfg = ViTVAEConfig(**dataclasses.asdict(vcfg))
    tparams = init_vitvae_params(tcfg, torch.Generator().manual_seed(3), "cpu")
    return (jvae.ViTVAE(vcfg, params=jax.tree.map(lambda a: jnp.asarray(a.numpy()), tparams)),
            ViTVAE(tcfg, params=tparams, device="cpu"))


def test_magi_tile_decode_matches_jax(magi_vae):
    """`MagiVideoPipeline(tile=True, decode_devices=["cpu"])`'s chunk decode
    (9 tiles of an 8 x 8 chunk, overlap 2) against the JAX pipeline's tiled
    decode of the same latents; one tile covering the chunk is bit-equal to
    `vae.decode`; the walk's chunks decoded by generate_video."""
    jv, tv = magi_vae
    jcfg = jdit.tiny_magi_config()
    tcfg = tdit.MagiModelConfig(**dataclasses.asdict(jcfg))
    z = np.random.default_rng(7).standard_normal((1, 2, 8, 8, 16)).astype(np.float32)
    want = jtile.TileProcessor(fn=jv.decode, scale_t=jv.cfg.patch_length,
                               scale_hw=jv.cfg.patch_size).process(
        jnp.asarray(z), tile_t=2, tile_h=4, tile_w=4, overlap_h=2, overlap_w=2)
    pipe = tpipe.MagiVideoPipeline(tcfg, tpipe.MagiRuntimeConfig(**MAGI_RT), latent_h=8,
                                   latent_w=8, max_chunks=4, dtype=torch.float32, device="cpu",
                                   vae=tv, tile=True, decode_devices=["cpu"])
    got = pipe.decode_chunk(torch.from_numpy(z))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    one = ttile.TileProcessor(fn=tv.decode, scale_t=tv.cfg.patch_length,
                              scale_hw=tv.cfg.patch_size, devices=["cpu"])
    assert np.array_equal(one.process(torch.from_numpy(z), 2, 8, 8, 2, 2),
                          tv.decode(torch.from_numpy(z)).numpy())
    px = pipe.generate_video(torch.zeros(1, 8, 64), torch.ones(1, 8), 2)
    assert px.shape == (1, 8, 32, 32, 3) and torch.isfinite(px).all()


def test_vae_replicas_follow_params(magi_vae):
    """The decode's copy of the VAE a device follows `vae.params` by
    identity: new params after the first decode reach the next one."""
    _, tv = magi_vae
    vae = ViTVAE(tv.cfg, params=tv.params, device="cpu")
    pipe = tpipe.MagiVideoPipeline(tdit.tiny_magi_config(), tpipe.MagiRuntimeConfig(**MAGI_RT),
                                   latent_h=8, latent_w=8, max_chunks=4, dtype=torch.float32,
                                   device="cpu", vae=vae, tile=True)
    z = torch.randn(1, 2, 8, 8, 16, generator=torch.Generator().manual_seed(8))
    before = pipe.decode_chunk(z)
    vae.params = jax.tree.map(lambda a: a * 1.5 if a.dim() else a, tv.params)
    after = pipe.decode_chunk(z)
    vae.params = tv.params
    assert not torch.equal(before, after)
    assert torch.equal(after, torch.from_numpy(
        ttile.TileProcessor(ViTVAE(tv.cfg, params=jax.tree.map(
            lambda a: a * 1.5 if a.dim() else a, tv.params), device="cpu").decode,
            scale_t=tv.cfg.patch_length, scale_hw=tv.cfg.patch_size).process(
            z, 2, 4, 4, 2, 2)).to(z.dtype))


WAN_VAE = dict(dim=16, z_dim=16, dim_mult=(1, 2, 2), num_res_blocks=1,
               temperal_downsample=(True, True))


def _port_vae():
    """The JAX tests' tiny Wan VAE, its weights drawn by the port."""
    cfg = VAEConfig(**WAN_VAE)
    return CausalVAE(cfg, params=init_vae_params(cfg, torch.Generator().manual_seed(9), "cpu"),
                     device="cpu")


def _wan_vaes():
    """The tiny Wan VAE in both packages, from one tree."""
    tv = _port_vae()
    jv = JaxCausalVAE(JaxVAEConfig(**WAN_VAE), params=jax.tree.map(
        lambda a: jnp.asarray(a.numpy()), tv.params))
    return jv, tv


def test_disaggregated_decode_matches_jax():
    """A 2-tile decode (overlap 2) over two blocks, the cache carried, against
    the JAX decoder; one tile against `decode_chunk` itself; a carried
    cache of another width refused; params set after construction reach
    the decode."""
    jv, tv = _wan_vaes()
    rng = np.random.default_rng(10)
    zs = [rng.standard_normal((1, 3, 8, 16, 16)).astype(np.float32) for _ in range(2)]
    jdec = jdis.DisaggregatedVAEDecoder(jv, [jax.devices()[0]], tiles=2, overlap=2)
    tdec = tdis.DisaggregatedVAEDecoder(tv, ["cpu", "cpu"], tiles=2, overlap=2)
    jc = tc = None
    for i, z in enumerate(zs):
        want, jc = jdec.decode_chunk(jnp.asarray(z), jc, first=i == 0)
        got, tc = tdec.decode_chunk(torch.from_numpy(z), tc, first=i == 0)
        np.testing.assert_allclose(got.assemble(), want.assemble(), **TOL)
    one = tdis.DisaggregatedVAEDecoder(tv, ["cpu"], tiles=1)
    px, _ = one.decode_chunk(torch.from_numpy(zs[0]), None, first=True)
    ref, _ = tv.decode_chunk(torch.from_numpy(zs[0]), None, first=True)
    assert torch.equal(px.tiles[0], torch.clamp(ref, -1, 1) * 0.5 + 0.5)
    with pytest.raises(ValueError, match="carried cache was made for the tile spans"):
        tdec.decode_chunk(torch.from_numpy(zs[0][..., :12, :]), tc, first=False)
    tv.params = jax.tree.map(lambda a: a * 0.5, tv.params)
    px2, _ = one.decode_chunk(torch.from_numpy(zs[0]), None, first=True)
    ref2, _ = tv.decode_chunk(torch.from_numpy(zs[0]), None, first=True)
    assert torch.equal(px2.tiles[0], torch.clamp(ref2, -1, 1) * 0.5 + 0.5)
    assert not torch.equal(px2.tiles[0], px.tiles[0])


def test_stream_with_disaggregated_decode_matches_local():
    """TRUE_STREAMING with the decode routed to a decode device (one tile)
    streams the local path's pixels; two tiles stay near them."""
    def build():
        cfg = tiny_test_config()
        cfg.runtime.num_frames = cfg.runtime.frames_per_segment = 4
        cfg.runtime.streaming_mode = StreamingMode.TRUE_STREAMING
        params = init_params(cfg.model, torch.Generator().manual_seed(0), "cpu", torch.float32)
        p = SelfForcingPipeline(cfg, params=params, vae=_port_vae(), dtype=torch.float32,
                                device="cpu")
        p.setup()
        return p

    want = []
    build().run_streaming_generation(["p"], num_segments=1,
                                     stream_callback=lambda px: want.append(px.numpy()))
    for tiles in (1, 2):
        dis = build()
        dis.set_disaggregated_decode(["cpu"], tiles=tiles)
        got = []
        dis.run_streaming_generation(["p"], num_segments=1,
                                     stream_callback=lambda px: got.append(px.assemble()))
        assert len(got) == len(want) > 0
        for g, w in zip(got, want):
            if tiles == 1:
                np.testing.assert_allclose(g, w, **TOL)
            else:
                assert g.shape == w.shape and float(np.abs(g - w).mean()) < 0.05


# --- multi-host ---

MULTIHOST = textwrap.dedent("""
    import sys
    sys.path.insert(0, {repo!r})
    import torch
    import torch.distributed as dist
    from inferix_tpu_torch.core.config import ParallelConfig
    from inferix_tpu_torch.core.interactive import InteractiveSession
    from inferix_tpu_torch.core.types import CheckpointResult, GenerationCommand
    from inferix_tpu_torch.parallel.multihost import (initialize_multihost, is_coordinator,
                                                      make_global_mesh, process_index)
    torch.set_num_threads(1)
    ok = initialize_multihost()
    try:
        make_global_mesh(ParallelConfig(tp=4))
        raise SystemExit("no world-size refusal")
    except ValueError as e:
        msg = str(e)
    mesh = make_global_mesh(ParallelConfig(pp=2))
    total = dist.all_reduce(t := torch.tensor([process_index() + 1.0])) or t
    me = process_index()
    mine = CheckpointResult(GenerationCommand.UPDATE_PROMPT, ("x" * 70000) if me == 0 else "no")
    got = InteractiveSession()._broadcast_result(mine)
    print(ok, is_coordinator(), mesh.stage, float(total), got.command.value,
          len(got.new_prompt or ""), "|", msg, flush=True)
    dist.destroy_process_group()
""")


def test_multihost_two_processes(tmp_path, monkeypatch):
    """Two processes join through the JAX package's env names: each is
    initialised, refuses a layout of 4 with the JAX message, builds pp 2
    across both, sums across both and takes process 0's decision (its
    70000-character prompt halved to fit 65536 bytes); NUM_PROCESSES=1 is a
    single-process run."""
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    script = tmp_path / "mh.py"
    script.write_text(MULTIHOST.format(repo=REPO))
    procs = []
    for pid in range(2):
        env = {k: v for k, v in os.environ.items()
               if k not in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "LOCAL_RANK")}
        env.update(COORDINATOR_ADDRESS=f"localhost:{port}", NUM_PROCESSES="2",
                   PROCESS_ID=str(pid), CUDA_VISIBLE_DEVICES="")
        procs.append(subprocess.Popen([sys.executable, str(script)], env=env,
                                      stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                                      text=True))
    outs = [p.communicate(timeout=120) for p in procs]
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0, err
    lines = [o.strip().split(" | ") for o, _ in outs]
    for pid, (head, msg) in enumerate(lines):
        ok, coord, stage, total, cmd, plen = head.split()
        assert (ok, coord, stage, total) == ("True", str(pid == 0), str(pid), "3.0")
        assert cmd == "update_prompt" and int(plen) == 35000
        assert msg == ("parallel config (dp=1, sp=1, tp=4, pp=1) needs 4 devices but the "
                       "job has 2 (processes=2)")
    from inferix_tpu_torch.parallel.multihost import initialize_multihost
    monkeypatch.setenv("NUM_PROCESSES", "1")
    assert initialize_multihost() is False
