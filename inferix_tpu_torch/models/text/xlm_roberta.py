"""XLM-RoBERTa text encoder and its CLIP head in PyTorch (port of
`inferix_tpu/models/text/xlm_roberta.py`).

Token, type and position embeddings (positions `pad_id + cumsum(mask) *
mask`), post-norm attention blocks (pre-norm when `post_norm` is false), the
erf GELU, and the CLIP text head: masked mean pooling, then a GELU MLP to
the CLIP embed dim. Every product and norm runs in the input's dtype, as the
JAX einsums do; the padding bias is float32's lowest value, added to the
logits in float32 before a float32 softmax. (The JAX function keeps its
layer carry in the tree's dtype too, and so runs a float32 tree only: with a
bf16 tree the float32 bias promotes its carry and its scan refuses it.)
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

import torch
import torch.nn.functional as F

from ...core.device import resolve_device
from ...core.memory import tree_map
from ..wan.causal_dit import layer_params
from .umt5 import normal

Params = Dict[str, Any]


@dataclasses.dataclass(frozen=True)
class XLMRobertaConfig:
    vocab_size: int = 250002
    max_seq_len: int = 514
    type_size: int = 1
    pad_id: int = 1
    dim: int = 1024
    num_heads: int = 16
    num_layers: int = 24
    post_norm: bool = True
    eps: float = 1e-5
    out_dim: Optional[int] = None   # CLIP head projection (None = encoder only)


def tiny_xlm_roberta_config() -> XLMRobertaConfig:
    return XLMRobertaConfig(vocab_size=128, max_seq_len=32, dim=64,
                            num_heads=4, num_layers=2, out_dim=16)


def init_xlm_roberta_params(cfg: XLMRobertaConfig, generator: torch.Generator,
                            device: str | torch.device = "cuda",
                            dtype: torch.dtype = torch.float32) -> Params:
    """Random parameters from the JAX package's distributions (not its
    bits): linear weights N(0, 1/in) [in, out] with zero biases (the head
    has none), embeddings N(0, 0.02^2), LayerNorms 1 / 0. Blocks stacked on
    [L]. `generator` must live on `device`."""
    dev = resolve_device(device)
    L, d = cfg.num_layers, cfg.dim

    def lin(i, o, layers=(L,), bias=True):
        p = {"w": normal((*layers, i, o), i ** -0.5, generator, dtype, dev)}
        if bias:
            p["b"] = torch.zeros((*layers, o), dtype=dtype, device=dev)
        return p

    def ln(*lead):
        return {"w": torch.ones((*lead, d), dtype=dtype, device=dev),
                "b": torch.zeros((*lead, d), dtype=dtype, device=dev)}

    params = {
        "token_embedding": normal((cfg.vocab_size, d), 0.02, generator, dtype, dev),
        "type_embedding": normal((cfg.type_size, d), 0.02, generator, dtype, dev),
        "pos_embedding": normal((cfg.max_seq_len, d), 0.02, generator, dtype, dev),
        "norm": ln(),
        "blocks": {"attn": {n: lin(d, d) for n in ("q", "k", "v", "o")},
                   "norm1": ln(L),
                   "ffn": {"fc1": lin(d, 4 * d), "fc2": lin(4 * d, d)},
                   "norm2": ln(L)},
    }
    if cfg.out_dim:
        mid = (d + cfg.out_dim) // 2
        params["head"] = {"fc1": lin(d, mid, (), bias=False),
                          "fc2": lin(mid, cfg.out_dim, (), bias=False)}
    return params


def _ln(p: Params, x: torch.Tensor, eps: float) -> torch.Tensor:
    mu = x.mean(-1, keepdim=True)
    var = (x - mu).square().mean(-1, keepdim=True)
    return (x - mu) * torch.rsqrt(var + eps) * p["w"].to(x.dtype) + p["b"].to(x.dtype)


def _linear(p: Params, x: torch.Tensor) -> torch.Tensor:
    out = torch.matmul(x, p["w"].to(x.dtype))
    if "b" in p:
        out = out + p["b"].to(x.dtype)
    return out


def xlm_roberta_encode(params: Params, cfg: XLMRobertaConfig,
                       ids: torch.Tensor) -> torch.Tensor:
    """ids: [B, L] int -> features [B, L, dim] (before pooling), in the
    tree's dtype."""
    b, s = ids.shape
    mask = (ids != cfg.pad_id).to(torch.int32)
    pos = cfg.pad_id + torch.cumsum(mask, dim=1) * mask
    x = (params["token_embedding"][ids]
         + params["type_embedding"][torch.zeros_like(ids)]
         + params["pos_embedding"][pos])
    if cfg.post_norm:
        x = _ln(params["norm"], x, cfg.eps)
    attn_bias = torch.where(mask[:, None, None, :] > 0,
                            torch.zeros((), device=ids.device),
                            torch.full((), torch.finfo(torch.float32).min,
                                       device=ids.device))   # [B, 1, 1, L] f32
    nh = cfg.num_heads
    hd = cfg.dim // nh

    def attention(p, h):
        q, k, v = (_linear(p[n], h).reshape(b, s, nh, hd).transpose(1, 2)
                   for n in ("q", "k", "v"))
        logits = torch.matmul(q, k.transpose(-1, -2)) / hd ** 0.5
        probs = torch.softmax(logits + attn_bias, dim=-1).to(v.dtype)
        out = torch.matmul(probs, v).transpose(1, 2).reshape(b, s, cfg.dim)
        return _linear(p["o"], out)

    for i in range(cfg.num_layers):
        blk = layer_params(params["blocks"], i)
        ffn = blk["ffn"]
        if cfg.post_norm:
            x = _ln(blk["norm1"], x + attention(blk["attn"], x), cfg.eps)
            ff = _linear(ffn["fc2"], F.gelu(_linear(ffn["fc1"], x)))
            x = _ln(blk["norm2"], x + ff, cfg.eps)
        else:
            x = x + attention(blk["attn"], _ln(blk["norm1"], x, cfg.eps))
            hn = _ln(blk["norm2"], x, cfg.eps)
            x = x + _linear(ffn["fc2"], F.gelu(_linear(ffn["fc1"], hn)))
    return x


def xlm_roberta_clip_text(params: Params, cfg: XLMRobertaConfig,
                          ids: torch.Tensor) -> torch.Tensor:
    """The CLIP text feature: encode, masked mean pooling, the MLP head.
    Returns [B, out_dim]."""
    x = xlm_roberta_encode(params, cfg, ids)
    mask = (ids != cfg.pad_id).to(x.dtype)[..., None]
    pooled = (x * mask).sum(dim=1) / torch.clamp(mask.sum(dim=1), min=1e-8)
    h = _linear(params["head"]["fc1"], pooled)
    return _linear(params["head"]["fc2"], F.gelu(h))


def convert_xlm_roberta_state_dict(sd, cfg: XLMRobertaConfig,
                                   dtype: torch.dtype = torch.float32,
                                   device: str | torch.device = "cuda") -> Params:
    """Torch `XLMRobertaWithHead` state dict -> the param tree (linear
    weights [out, in] transposed to [in, out])."""
    dev = resolve_device(device)

    def t(name, transpose=False):
        a = torch.as_tensor(sd[name]).detach().to(device=dev, dtype=torch.float32)
        return (a.t().contiguous() if transpose else a).to(dtype)

    def lin(name, bias=True):
        p = {"w": t(f"{name}.weight", transpose=True)}
        if bias:
            p["b"] = t(f"{name}.bias")
        return p

    def blk(i):
        pre = f"blocks.{i}"
        return {
            "attn": {n: lin(f"{pre}.attn.{n}") for n in ("q", "k", "v", "o")},
            "norm1": {"w": t(f"{pre}.norm1.weight"), "b": t(f"{pre}.norm1.bias")},
            "ffn": {"fc1": lin(f"{pre}.ffn.0"), "fc2": lin(f"{pre}.ffn.2")},
            "norm2": {"w": t(f"{pre}.norm2.weight"), "b": t(f"{pre}.norm2.bias")},
        }

    params = {
        "token_embedding": t("token_embedding.weight"),
        "type_embedding": t("type_embedding.weight"),
        "pos_embedding": t("pos_embedding.weight"),
        "norm": {"w": t("norm.weight"), "b": t("norm.bias")},
        "blocks": tree_map(lambda *xs: torch.stack(xs),
                           *[blk(i) for i in range(cfg.num_layers)]),
    }
    if cfg.out_dim and "head.0.weight" in sd:
        params["head"] = {"fc1": lin("head.0", bias=False),
                          "fc2": lin("head.2", bias=False)}
    return params
