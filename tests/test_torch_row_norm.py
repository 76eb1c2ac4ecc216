"""The row kernels of the bf16 Wan layer's norm chains (`ops/row_norm.py`):
their plain versions bit for bit against the chains they replace, on the
CPU in bfloat16 at reduced widths, the wrappers' operand checks, and the
layer's dispatch to them (the predicates forced on, so the wrappers run
their plain versions) bit-equal to the plain chain over whole forwards.
"""
import numpy as np
import pytest
import torch

from inferix_tpu_torch.core.config import tiny_test_config
from inferix_tpu_torch.kvcache.cache import init_kv_cache
from inferix_tpu_torch.models.wan import causal_dit as tdit
from inferix_tpu_torch.ops import row_norm as rn
from inferix_tpu_torch.ops.norms import layer_norm
from inferix_tpu_torch.ops.rope import apply_rope, build_rope_tables, rope_angles
from inferix_tpu_torch.parallel.tensor_parallel import rms_norm_tp, rms_norms_tp
from inferix_tpu_torch.utils.params import init_params

EPS = 1e-6
BF16 = torch.bfloat16


def _bf16(rng, *shape, scale=1.0, shift=0.0):
    return torch.from_numpy((rng.standard_normal(shape) * scale + shift)
                            .astype(np.float32)).to(BF16)


def _f32(rng, *shape):
    return torch.from_numpy(rng.standard_normal(shape).astype(np.float32))


def _equal(a, b):
    assert a.dtype == b.dtype and a.shape == b.shape
    assert torch.equal(a.view(torch.int16), b.view(torch.int16)), \
        f"{(a != b).sum().item()} of {a.numel()} differ"


@pytest.mark.parametrize("b,c", [(1, 64), (2, 256), (1, 1536)])
def test_ln_modulate_reference_is_the_chain(b, c):
    """LN -> bf16, then h * bf16(1 + scale) + bf16(shift) per frame (F = 3),
    shift and scale strided slices of the [B, F, 6, C] modulation, as
    block_forward hands them over; rows with an offset and a spread."""
    rng = np.random.default_rng(c + b)
    f, fs = 3, 10
    x = _bf16(rng, b, f * fs, c, scale=3.0, shift=0.5)
    mod = _f32(rng, b, f, 6, c)
    for i in (0, 3):
        shift, scale = mod[:, :, i], mod[:, :, i + 1]
        want = tdit._modulate(layer_norm(x, eps=EPS), shift, scale, f)
        _equal(rn.ln_rows_reference(x, EPS, shift=shift, scale=scale), want)
        _equal(rn.ln_rows(x, EPS, shift=shift, scale=scale), want)


@pytest.mark.parametrize("affine", [True, False])
def test_ln_affine_reference_is_the_chain(affine):
    """norm3: the affine weight and bias in f32, one cast; without them the
    LN alone; on [B, S, C] and [M, C] rows."""
    rng = np.random.default_rng(3)
    x = _bf16(rng, 2, 12, 384, scale=2.0, shift=-1.0)
    w, bias = (_bf16(rng, 384), _bf16(rng, 384)) if affine else (None, None)
    want = layer_norm(x, w, bias, EPS)
    _equal(rn.ln_rows_reference(x, EPS, w, bias), want)
    _equal(rn.ln_rows(x, EPS, w, bias), want)
    _equal(rn.ln_rows(x.reshape(24, 384), EPS, w, bias), want.reshape(24, 384))


@pytest.mark.parametrize("b,heads,hd", [(1, 4, 32), (2, 12, 128)])
def test_qk_rms_rope_reference_is_the_chain(b, heads, hd):
    """q and k read from the fused [B, S, 3C] qkv output (column views, no
    copy), each RMS-normed with its weight and rotated from the once-a-forward
    cos / sin table: bit-equal to rms_norms_tp at tp 1, then apply_rope."""
    rng = np.random.default_rng(hd)
    c, f, gh, gw = heads * hd, 3, 2, 3
    s = f * gh * gw
    qkv = _bf16(rng, b, s, 3 * c, scale=2.0)
    q_p, k_p, _ = qkv.chunk(3, dim=-1)
    wq, wk = _bf16(rng, c), _bf16(rng, c)
    angles = rope_angles(build_rope_tables(hd, 64, device="cpu"), f, gh, gw, 5)
    q, k = rms_norms_tp(None, (q_p, k_p), (wq, wk), EPS, c)
    want = [apply_rope(t.reshape(b, s, heads, hd), angles).reshape(b, s, c) for t in (q, k)]
    rope = rn.rope_cos_sin(angles)
    for got in (rn.rms_rows_reference((q_p, k_p), (wq, wk), EPS, rope, hd),
                rn.rms_rows((q_p, k_p), (wq, wk), EPS, rope, hd)):
        for g, w in zip(got, want):
            _equal(g, w)
            assert g.is_contiguous()


def test_rms_without_rope_and_per_stream_angles():
    """The cross q's RMS norm (no rope) against rms_norm_tp at tp 1; q / k
    with per-stream [B, S, D/2] angles (a [B] start, continuous batching)
    against apply_rope, the table's batch stride taken."""
    rng = np.random.default_rng(11)
    b, heads, hd, f, gh, gw = 2, 4, 32, 3, 2, 2
    c, s = heads * hd, f * gh * gw
    cq, w = _bf16(rng, b, s, c, scale=4.0), _bf16(rng, c)
    want = rms_norm_tp(None, cq, w, EPS, c)
    _equal(rn.rms_rows_reference((cq,), (w,), EPS)[0], want)
    _equal(rn.rms_rows((cq,), (w,), EPS)[0], want)
    angles = rope_angles(build_rope_tables(hd, 64, device="cpu"), f, gh, gw,
                         torch.tensor([0, 7]))
    assert angles.shape == (b, s, hd // 2)
    qkv = _bf16(rng, b, s, 3 * c)
    q_p, k_p, _ = qkv.chunk(3, dim=-1)
    wq, wk = _bf16(rng, c), _bf16(rng, c)
    q, k = rms_norms_tp(None, (q_p, k_p), (wq, wk), EPS, c)
    got = rn.rms_rows((q_p, k_p), (wq, wk), EPS, rn.rope_cos_sin(angles), hd)
    for g, t in zip(got, (q, k)):
        _equal(g, apply_rope(t.reshape(b, s, heads, hd), angles).reshape(b, s, c))


@pytest.mark.parametrize("per_stream", [False, True])
def test_table_rope_is_apply_rope(per_stream):
    """The rope from the once-a-forward cos / sin table, pair by pair as the
    kernel takes it, bit-equal to apply_rope on bf16 rows."""
    rng = np.random.default_rng(5)
    b, heads, hd = 2, 3, 16
    tables = build_rope_tables(hd, 32, device="cpu")
    start = torch.tensor([1, 4]) if per_stream else 2
    angles = rope_angles(tables, 2, 3, 2, start)
    s = angles.shape[-2]
    y = _bf16(rng, b, s, heads * hd, scale=5.0)
    want = apply_rope(y.reshape(b, s, heads, hd), angles).reshape(b, s, heads * hd)
    _equal(rn._rope_pairs(y, *rn.rope_cos_sin(angles), hd), want)


def test_wrappers_refuse_what_the_kernels_cannot_read():
    """As the act-quant wrappers' `_check_x`: a non-bf16, non-contiguous or
    misaligned input, a width the rows cannot load, bad operands; and no
    launch counted on the CPU."""
    before = (rn.ln_rows.launches, rn.rms_rows.launches)
    rng = np.random.default_rng(2)
    x = _bf16(rng, 1, 6, 64)
    mod = _f32(rng, 1, 3, 6, 64)
    shift, scale = mod[:, :, 0], mod[:, :, 1]
    w = _bf16(rng, 64)
    misaligned = torch.zeros(1 + 6 * 64, dtype=BF16)[1:].view(1, 6, 64)
    for exc, match, call in (
            (TypeError, "bfloat16", lambda: rn.ln_rows(x.float(), EPS, shift=shift, scale=scale)),
            (ValueError, "contiguous", lambda: rn.ln_rows(x.transpose(1, 2).contiguous()
                                                          .transpose(1, 2), EPS)),
            (ValueError, "aligned", lambda: rn.ln_rows(misaligned, EPS)),
            (ValueError, "multiple of 8", lambda: rn.ln_rows(x[..., :60].contiguous(), EPS)),
            (ValueError, "up to", lambda: rn.ln_rows(torch.zeros(2, rn.MAX_WIDTH + 8,
                                                                 dtype=BF16), EPS)),
            (ValueError, "weight with bias", lambda: rn.ln_rows(x, EPS, w)),
            (ValueError, "not both", lambda: rn.ln_rows(x, EPS, w, w, shift, scale)),
            (ValueError, "float32", lambda: rn.ln_rows(x, EPS, shift=shift.to(BF16),
                                                       scale=scale.to(BF16))),
            (ValueError, "frames", lambda: rn.ln_rows(x[:, :5].contiguous(), EPS, shift=shift,
                                                      scale=scale)),
            (ValueError, "bias", lambda: rn.ln_rows(x, EPS, w, w.float())),
            (TypeError, "bfloat16", lambda: rn.rms_rows((x.float(),), (w,), EPS)),
            (ValueError, "row-strided", lambda: rn.rms_rows((x.transpose(0, 1),), (w,), EPS)),
            (ValueError, "aligned", lambda: rn.rms_rows((misaligned,), (w,), EPS)),
            (ValueError, "weight", lambda: rn.rms_rows((x,), (w[:32],), EPS)),
            (ValueError, "row stride", lambda: rn.rms_rows(
                (x, torch.zeros(1, 6, 128, dtype=BF16)[..., :64]), (w, w), EPS)),
            (ValueError, "one or two", lambda: rn.rms_rows((x, x, x), (w, w, w), EPS)),
            (ValueError, "head_dim", lambda: rn.rms_rows(
                (x,), (w,), EPS, (torch.zeros(6, 6), torch.zeros(6, 6)), 12)),
            (ValueError, "cos / sin", lambda: rn.rms_rows(
                (x,), (w,), EPS, (torch.zeros(5, 8), torch.zeros(5, 8)), 16)),
            (ValueError, "float32", lambda: rn.rms_rows(
                (x,), (w,), EPS, (torch.zeros(6, 8).double(), torch.zeros(6, 8).double()),
                16))):
        with pytest.raises(exc, match=match):
            call()
    assert (rn.ln_rows.launches, rn.rms_rows.launches) == before


def test_dispatch_predicates():
    """CPU tensors take the plain chains; the q / k views of the fused qkv
    output have evenly strided rows, 3C apart; a transposed view does not."""
    x = torch.zeros(2, 6, 64, dtype=BF16)
    assert not rn.rows_take(x)
    q, k, _ = torch.zeros(2, 6, 3 * 64, dtype=BF16).chunk(3, dim=-1)
    assert rn._row_stride(q) == rn._row_stride(k) == 192
    assert rn._row_stride(x) == 64 and rn._row_stride(x.transpose(0, 1)) is None
    assert not rn.qk_rows_take(q, k, 32)


def _tiny_bf16(seed):
    cfg = tiny_test_config()
    g = torch.Generator().manual_seed(seed)
    params = tdit.fuse_qkv_params(init_params(cfg.model, g, device="cpu", dtype=BF16))
    blocks = params["blocks"]
    rng = np.random.default_rng(seed)
    # norm weights and the norm3 bias away from 1 and 0, so each operand counts
    for leaf in (blocks["self_attn"]["norm_q"], blocks["self_attn"]["norm_k"],
                 blocks["cross_attn"]["norm_q"], blocks["norm3"]):
        for name, t in leaf.items():
            leaf[name] = _bf16(rng, *t.shape, scale=0.3, shift=1.0 if name == "w" else 0.0)
    blocks["modulation"] = blocks["modulation"] * 20.0
    return cfg, params


def _forward(cfg, params, b, start, frames, x, t, ctx):
    statics = tdit.make_statics(cfg.model, b, frames, 8, 8, BF16)
    tables = build_rope_tables(cfg.model.head_dim, cfg.model.rope_max_seq_len, device="cpu")
    xattn = tdit.precompute_crossattn_cache(params, cfg.model, ctx)
    cache = init_kv_cache(statics.spec, device="cpu")
    flow, cache = tdit.dit_forward_inference(params, statics, tables, x, t, xattn, cache,
                                             start)
    return flow, cache


@pytest.mark.parametrize("b,start", [(1, 16), (2, torch.tensor([0, 48]))])
def test_layer_dispatch_through_the_wrappers_is_the_plain_chain(monkeypatch, b, start):
    """The bf16 tiny DiT (2 layers, 3-frame blocks, fused qkv): forwards with
    the row predicates forced on, so block_forward and head_forward route
    every chain through ln_rows / rms_rows (their plain versions on the
    CPU, handed the tables of one rope_cos_sin a forward), bit-equal to the
    plain chain in flow and cache; a [B] start takes per-stream tables. The
    wrappers are called 2 L + L + 1 and L + L times a forward."""
    cfg, params = _tiny_bf16(7)
    rng = np.random.default_rng(8)
    frames = 3
    x = _bf16(rng, b, frames, 8, 8, 16)
    t = torch.full((b, frames), 750.0)
    ctx = _bf16(rng, b, 16, 64)
    plain = _forward(cfg, params, b, start, frames, x, t, ctx)
    calls = {"ln": 0, "rms": 0, "tables": 0}

    def counted(key, fn):
        def call(*a, **k):
            calls[key] += 1
            return fn(*a, **k)
        return call

    monkeypatch.setattr(tdit, "rows_take", lambda x, *w: x.dtype == BF16)
    monkeypatch.setattr(tdit, "qk_rows_take", lambda q, k, hd, *w: q.dtype == BF16)
    monkeypatch.setattr(tdit, "ln_rows", counted("ln", rn.ln_rows))
    monkeypatch.setattr(tdit, "rms_rows", counted("rms", rn.rms_rows))
    monkeypatch.setattr(tdit, "rope_cos_sin", counted("tables", rn.rope_cos_sin))
    rows = _forward(cfg, params, b, start, frames, x, t, ctx)
    layers = cfg.model.num_layers
    assert calls == {"ln": 3 * layers + 1, "rms": 2 * layers, "tables": 1}
    _equal(rows[0], plain[0])
    for got, want in zip(rows[1], plain[1]):
        if want is not None:
            _equal(got, want)
