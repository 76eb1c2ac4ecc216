"""Sequence-parallel attention over the port's mesh, with no KV cache (port
of `inferix_tpu/parallel/sp_attention.py`): Ulysses all-to-all, and ring
attention passing K/V or passing q.

Each rank passes its contiguous 1/sp of the tokens, q/k/v [B, S/sp, H, D],
and gets its tokens of the output back:
- `ulysses_attention`: one all-to-all turns the token shard into every
  token of 1/sp of the heads, attention runs locally over the whole
  sequence, and a second all-to-all turns it back (H % sp == 0);
- `ring_attention` (pass-kv): the K/V shards travel around the ring while
  each rank keeps its queries; the partial results merge with the
  log-sum-exp trick (`merge_attention_partials`);
- `ring_attention_pass_q`: the queries and their online-softmax state
  (acc, m, l) travel while the K/V stay; after sp hops every query is home.
The local attention is `attention_chunked`, as in the JAX package. No path
of either package calls these yet: the model's in-forward islands are in
`distributed_attention.py`.
"""
from __future__ import annotations

from typing import Optional

import torch

from ..ops.attention import attention_chunked, merge_attention_partials
from .distributed_attention import merge_step
from .mesh import SPMesh, heads_to_tokens, tokens_to_heads


def ulysses_attention(mesh: SPMesh, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      kv_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Attention through the head <-> sequence all-to-all. kv_mask: [S] or
    [B, S] over the whole sequence (every rank's)."""
    qg, kg, vg = (tokens_to_heads(mesh, x, 1) for x in (q, k, v))
    out, _ = attention_chunked(qg, kg, vg, kv_mask=kv_mask)
    return heads_to_tokens(mesh, out, 1)


def ring_attention(mesh: SPMesh, q: torch.Tensor, k: torch.Tensor,
                   v: torch.Tensor) -> torch.Tensor:
    """Ring attention, pass-kv: sp partial results, one a K/V shard, merged
    by their log-sum-exp."""
    outs, lses = [], []
    k_cur, v_cur = k, v
    for step in range(mesh.size):
        out_i, lse_i = attention_chunked(q, k_cur, v_cur)
        outs.append(out_i.float())
        lses.append(lse_i)
        if step < mesh.size - 1:
            k_cur, v_cur = mesh.ring_shift([k_cur, v_cur], [k.shape, v.shape])
    out, _ = merge_attention_partials(torch.stack(outs), torch.stack(lses))
    return out.to(q.dtype)


def ring_attention_pass_q(mesh: SPMesh, q: torch.Tensor, k: torch.Tensor,
                          v: torch.Tensor) -> torch.Tensor:
    """Ring attention, pass-q: the queries and their accumulators make sp
    hops around the ring, meeting every K/V shard once."""
    b, s, h, d = q.shape
    acc = torch.zeros(b, s, h, d, dtype=torch.float32, device=q.device)
    m = torch.full((b, h, s), float("-inf"), device=q.device)
    l_run = torch.zeros(b, h, s, device=q.device)
    q_cur = q
    for _ in range(mesh.size):
        out_i, lse_i = attention_chunked(q_cur, k, v)
        acc, m, l_run = merge_step(acc, m, l_run, out_i, lse_i)
        q_cur, acc, m, l_run = mesh.ring_shift(
            [q_cur, acc, m, l_run], [q.shape, acc.shape, m.shape, l_run.shape])
    out = acc / torch.clamp(l_run, min=1e-30).transpose(1, 2)[..., None]
    return out.to(q.dtype)
