"""UMT5 / T5 text encoder in PyTorch (port of
`inferix_tpu/models/text/umt5.py:1-357`; MAGI's `MagiT5Embedder` and its
caption cleaning are not ported yet).

Pre-norm T5 blocks with UNSCALED attention plus a relative position bias
(one table per layer for UMT5, `shared_pos=False`; one table shared by all
layers for t5-v1_1), a gated GELU (tanh) feed-forward, T5LayerNorm (no mean
subtraction) and a final norm. Layers are stacked on a leading [L] axis, as
in the JAX tree, and run in a Python loop. All linears are plain matmuls in
the activations' dtype (the JAX package's `jnp.dot`); the attention is plain
tensor ops: float32 logits from the operands, the bias and the -1e9 mask
added, a float32 softmax.

UMT5-XXL: vocab 256384, dim 4096, ffn 10240, 64 heads, 24 layers, 32 buckets.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F

from ...core.device import resolve_device
from ...core.memory import stream_layer_forward, tree_map
from ..wan.causal_dit import layer_params

Params = Dict[str, Any]


@dataclasses.dataclass(frozen=True)
class UMT5Config:
    vocab_size: int = 256384
    dim: int = 4096
    dim_attn: int = 4096
    dim_ffn: int = 10240
    num_heads: int = 64
    num_layers: int = 24
    num_buckets: int = 32
    max_dist: int = 128
    # t5-v1_1 (the MAGI text tower): one relative-position bias table, from
    # the first layer, shared by every layer; UMT5 keeps one per layer
    shared_pos: bool = False

    @property
    def head_dim(self) -> int:
        return self.dim_attn // self.num_heads


def tiny_umt5_config() -> UMT5Config:
    return UMT5Config(vocab_size=128, dim=64, dim_attn=64, dim_ffn=128,
                      num_heads=4, num_layers=2, num_buckets=8, max_dist=16)


def t5_v1_1_xxl_config() -> UMT5Config:
    """google/t5-v1_1-xxl encoder: 24 layers, d_model 4096, d_ff 10240,
    64 heads x d_kv 64, vocab 32128, a shared relative bias."""
    return UMT5Config(vocab_size=32128, shared_pos=True)


def tiny_t5_v1_1_config() -> UMT5Config:
    return dataclasses.replace(tiny_umt5_config(), shared_pos=True)


# ---------------------------------------------------------------------------
# Relative position buckets (host side, bidirectional)
# ---------------------------------------------------------------------------

def relative_position_buckets(seq_len: int, num_buckets: int,
                              max_dist: int = 128) -> np.ndarray:
    """[L, L] int32 bucket ids (the reference's bidirectional
    `_relative_position_bucket`)."""
    ctx = np.arange(seq_len)[:, None]
    mem = np.arange(seq_len)[None, :]
    rel_pos = mem - ctx
    nb = num_buckets // 2
    rel_buckets = (rel_pos > 0).astype(np.int64) * nb
    rel_pos = np.abs(rel_pos)
    max_exact = nb // 2
    with np.errstate(divide="ignore"):
        rel_pos_large = max_exact + (
            np.log(np.maximum(rel_pos, 1) / max_exact)
            / math.log(max_dist / max_exact) * (nb - max_exact)
        ).astype(np.int64)
    rel_pos_large = np.minimum(rel_pos_large, nb - 1)
    rel_buckets += np.where(rel_pos < max_exact, rel_pos, rel_pos_large)
    return rel_buckets.astype(np.int32)


# ---------------------------------------------------------------------------
# Params
# ---------------------------------------------------------------------------

def normal(shape, std: float, generator: torch.Generator, dtype: torch.dtype,
           device: torch.device) -> torch.Tensor:
    """N(0, std^2) drawn in float32 and cast to dtype, a slab of at most 64M
    values at a time (so a large table never needs a float32 copy whole)."""
    out = torch.empty(shape, dtype=dtype, device=device)
    rows = out.view(-1, shape[-1])
    step = max(1, (1 << 26) // shape[-1])
    for r0 in range(0, rows.shape[0], step):
        part = rows[r0:r0 + step]
        part.copy_(torch.randn(part.shape, generator=generator, dtype=torch.float32,
                               device=device).mul_(std))
    return out


def init_umt5_params(cfg: UMT5Config, generator: torch.Generator,
                     device: str | torch.device = "cuda",
                     dtype: torch.dtype = torch.bfloat16) -> Params:
    """Random parameters from the JAX package's distributions (not its
    bits): linear weights N(0, 1/in) [in, out], the token embedding N(0, 1),
    the relative-bias tables N(0, 1/(2 * buckets * heads)) in float32, norm
    weights 1. Blocks stacked on [L]. `generator` must live on `device`."""
    dev = resolve_device(device)
    L = cfg.num_layers

    def lin(i, o):
        return {"w": normal((L, i, o), i ** -0.5, generator, dtype, dev)}

    def ones(*shape):
        return torch.ones(shape, dtype=dtype, device=dev)

    pos_std = (2 * cfg.num_buckets * cfg.num_heads) ** -0.5
    blocks = {
        "norm1": {"w": ones(L, cfg.dim)},
        "attn": {"q": lin(cfg.dim, cfg.dim_attn), "k": lin(cfg.dim, cfg.dim_attn),
                 "v": lin(cfg.dim, cfg.dim_attn), "o": lin(cfg.dim_attn, cfg.dim)},
        "norm2": {"w": ones(L, cfg.dim)},
        "ffn": {"gate": lin(cfg.dim, cfg.dim_ffn), "fc1": lin(cfg.dim, cfg.dim_ffn),
                "fc2": lin(cfg.dim_ffn, cfg.dim)},
    }
    if not cfg.shared_pos:
        blocks["pos_emb"] = normal((L, cfg.num_buckets, cfg.num_heads), pos_std,
                                   generator, torch.float32, dev)
    params = {
        "token_embedding": normal((cfg.vocab_size, cfg.dim), 1.0, generator, dtype, dev),
        "blocks": blocks,
        "norm": {"w": ones(cfg.dim)},
    }
    if cfg.shared_pos:
        params["shared_pos_emb"] = normal((cfg.num_buckets, cfg.num_heads), pos_std,
                                          generator, torch.float32, dev)
    return params


# ---------------------------------------------------------------------------
# Forward
# ---------------------------------------------------------------------------

def _t5_norm(p: Params, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    xf = x.float()
    out = xf * torch.rsqrt((xf * xf).mean(-1, keepdim=True) + eps)
    return (p["w"].float() * out).to(x.dtype)


def _dot(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    return torch.matmul(x, w.to(x.dtype))


def _bias_table(table: torch.Tensor, buckets: torch.Tensor) -> torch.Tensor:
    """[buckets, H] table -> [1, H, L, L] float32 bias."""
    return table[buckets].permute(2, 0, 1)[None]


def _t5_layer_body(x: torch.Tensor, blk: Params, mask_bias: torch.Tensor,
                   pos_bias: Optional[torch.Tensor], buckets: torch.Tensor,
                   nh: int, hd: int) -> torch.Tensor:
    """One encoder layer. pos_bias: the shared bias [1, H, L, L], or None
    for the per-layer bias the block carries (UMT5)."""
    b, L = x.shape[:2]
    if pos_bias is None:
        pos_bias = _bias_table(blk["pos_emb"], buckets)
    h = _t5_norm(blk["norm1"], x)
    a = blk["attn"]
    q = _dot(h, a["q"]["w"]).reshape(b, L, nh, hd).transpose(1, 2)
    k = _dot(h, a["k"]["w"]).reshape(b, L, nh, hd).transpose(1, 2)
    v = _dot(h, a["v"]["w"]).reshape(b, L, nh, hd).transpose(1, 2)
    # T5 attention is unscaled; float32 logits from the operands
    logits = torch.matmul(q.float(), k.float().transpose(-1, -2))
    logits = logits + pos_bias + mask_bias
    probs = torch.softmax(logits, dim=-1).to(v.dtype)
    o = torch.matmul(probs, v).transpose(1, 2).reshape(b, L, nh * hd)
    x = x + _dot(o, a["o"]["w"])

    h = _t5_norm(blk["norm2"], x)
    f = blk["ffn"]
    gate = F.gelu(_dot(h, f["gate"]["w"]), approximate="tanh")
    ff = _dot(h, f["fc1"]["w"]) * gate
    return x + _dot(ff, f["fc2"]["w"])


def umt5_encode(params: Params, cfg: UMT5Config, ids: torch.Tensor,
                mask: Optional[torch.Tensor] = None,
                stream_layers: bool = False) -> torch.Tensor:
    """ids: [B, L] int; mask: [B, L] (1 = real token). Returns [B, L, dim]
    in the token embedding's dtype, computed on ids' device.

    stream_layers=True runs the layer stack through
    `core.memory.stream_layer_forward`: params["blocks"] (and the token
    embedding and shared bias table) may live in host memory and are
    streamed to the device one layer at a time while the previous layer
    computes; the embedding rows are gathered on the host and only the
    [B, L, dim] result is copied. Bit-equal to the resident run."""
    dev = ids.device
    b, L = ids.shape
    emb = params["token_embedding"]
    if emb.device != dev:
        # host-side gather: only the [B, L, dim] rows are transferred
        x = emb[ids.to(emb.device)].to(dev)
    else:
        x = emb[ids]
    buckets = torch.as_tensor(
        relative_position_buckets(L, cfg.num_buckets, cfg.max_dist),
        dtype=torch.long, device=dev)
    if mask is None:
        mask = torch.ones(b, L, dtype=torch.int32, device=dev)
    mask_bias = torch.where(mask[:, None, None, :].to(dev) > 0,
                            torch.zeros((), device=dev),
                            torch.full((), -1e9, device=dev))   # [B, 1, 1, L] f32
    nh, hd = cfg.num_heads, cfg.head_dim
    shared_bias = None
    if "shared_pos_emb" in params:
        shared_bias = _bias_table(params["shared_pos_emb"].to(dev), buckets)

    def layer(xc, blk):
        return _t5_layer_body(xc, blk, mask_bias, shared_bias, buckets, nh, hd)

    if stream_layers:
        x = stream_layer_forward(params["blocks"], layer, x, device=dev)
    else:
        for i in range(cfg.num_layers):
            x = layer(x, layer_params(params["blocks"], i))
    return _t5_norm({"w": params["norm"]["w"].to(dev)}, x)


class WanTextEncoder:
    """Prompts -> padded text features [B, text_len, dim] (the reference's
    `WanTextEncoder`: tokenize, encode, zero the padded positions).

    tokenizer: a callable like a HF tokenizer (`tokenizer(prompts,
    padding="max_length", truncation=True, max_length=text_len,
    return_tensors="np")` -> {"input_ids", "attention_mask"}).
    stream_layers=True keeps the tower's blocks, token embedding and shared
    bias table in host memory (pinned when `device` is a card) and streams
    one layer at a time to the device (`umt5_encode`)."""

    def __init__(self, cfg: UMT5Config = UMT5Config(),
                 params: Optional[Params] = None, tokenizer=None,
                 text_len: int = 512, dtype: torch.dtype = torch.bfloat16,
                 stream_layers: bool = False,
                 device: str | torch.device = "cuda",
                 generator: Optional[torch.Generator] = None):
        self.cfg = cfg
        self.text_len = text_len
        self.dtype = dtype
        self.device = resolve_device(device)
        if params is None:
            g = generator or torch.Generator(device=self.device).manual_seed(0)
            params = init_umt5_params(cfg, g, device=self.device, dtype=dtype)
        self.tokenizer = tokenizer
        self.stream_layers = stream_layers
        if stream_layers:
            params = dict(params)
            pin = self.device.type == "cuda"
            for key in ("blocks", "token_embedding", "shared_pos_emb"):
                if key in params:
                    params[key] = tree_map(
                        lambda a: a if a.device.type == "cpu" else
                        torch.empty(a.shape, dtype=a.dtype, pin_memory=pin).copy_(a),
                        params[key])
        self.params = params

    def _tokenize(self, prompts):
        if self.tokenizer is None:
            raise RuntimeError(
                "no tokenizer configured: pass precomputed embeddings or a "
                "tokenizer (google/umt5-xxl)")
        enc = self.tokenizer(prompts, padding="max_length", truncation=True,
                             max_length=self.text_len, return_tensors="np")
        return np.asarray(enc["input_ids"]), np.asarray(enc["attention_mask"])

    @torch.inference_mode()
    def __call__(self, prompts) -> torch.Tensor:
        ids, mask = self._tokenize(list(prompts))
        ids = torch.as_tensor(ids, dtype=torch.long, device=self.device)
        mask = torch.as_tensor(mask, dtype=torch.int32, device=self.device)
        feats = umt5_encode(self.params, self.cfg, ids, mask,
                            stream_layers=self.stream_layers)
        # zero the padded positions (the reference cuts at the sequence
        # lengths, then pads with zeros)
        return (feats * mask[..., None].to(feats.dtype)).to(self.dtype)


# ---------------------------------------------------------------------------
# HF checkpoint conversion (T5EncoderModel: t5-v1_1 and UMT5 layouts)
# ---------------------------------------------------------------------------

def convert_t5_encoder_state_dict(sd, cfg: UMT5Config,
                                  dtype: torch.dtype = torch.bfloat16,
                                  device: str | torch.device = "cuda") -> Params:
    """HF `T5EncoderModel` state dict (torch tensors) -> the param tree.

    Both bias layouts: t5-v1_1 keeps one `relative_attention_bias` in block
    0 (cfg.shared_pos=True), UMT5 one per block. Linear weights [out, in]
    are transposed to [in, out]; the bias tables stay float32."""
    dev = resolve_device(device)

    def t(x, dt=dtype):
        return torch.as_tensor(x).detach().to(device=dev, dtype=torch.float32).to(dt)

    def lin(name):
        return {"w": t(sd[f"{name}.weight"]).t().contiguous()}

    embed_key = "shared.weight" if "shared.weight" in sd else "encoder.embed_tokens.weight"
    blocks = []
    for i in range(cfg.num_layers):
        pre = f"encoder.block.{i}"
        att = f"{pre}.layer.0.SelfAttention"
        p = {
            "norm1": {"w": t(sd[f"{pre}.layer.0.layer_norm.weight"])},
            "attn": {n: lin(f"{att}.{n}") for n in ("q", "k", "v", "o")},
            "norm2": {"w": t(sd[f"{pre}.layer.1.layer_norm.weight"])},
            "ffn": {"gate": lin(f"{pre}.layer.1.DenseReluDense.wi_0"),
                    "fc1": lin(f"{pre}.layer.1.DenseReluDense.wi_1"),
                    "fc2": lin(f"{pre}.layer.1.DenseReluDense.wo")},
        }
        if not cfg.shared_pos:
            p["pos_emb"] = t(sd[f"{att}.relative_attention_bias.weight"], torch.float32)
        blocks.append(p)
    params = {
        "token_embedding": t(sd[embed_key]),
        "blocks": tree_map(lambda *xs: torch.stack(xs), *blocks),
        "norm": {"w": t(sd["encoder.final_layer_norm.weight"])},
    }
    if cfg.shared_pos:
        params["shared_pos_emb"] = t(
            sd["encoder.block.0.layer.0.SelfAttention.relative_attention_bias.weight"],
            torch.float32)
    return params
