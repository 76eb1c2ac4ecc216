"""Sequence-parallel attention inside the model forwards (port of
`inferix_tpu/parallel/distributed_attention.py`: Wan's ulysses, ring pass-q
and ring pass-kv cache islands, `sp_cache_attention`, MAGI's
`cso_chunk_attention` and `gqa_head_island`, and
`sp_comm_bytes_per_layer`).

Where the JAX package runs each island as a `shard_map` with
`all_to_all` / `ppermute`, the port runs one process a rank and exchanges
through the mesh (`parallel/mesh.py`). Each rank enters with q, k, v of its
frame shard of the block's tokens and its shard of the cache
(`wan_kv_cache_shard`):
- **ulysses** (heads over sp): `sp_write_block` quantizes (int8) or casts
  the rank's K/V rows, one all-to-all per field turns them into every token
  of the rank's heads, and they are written into its heads' cache;
  attention turns q the same way, attends over the rank's heads with the
  single-device dispatcher (`cache_attention`: B1 / B2 on the card), and
  turns the output back (`ulysses_cache_attention`);
- **ring pass-q** (slots over sp): the block's storage rows are gathered
  and each rank writes the pieces that fall in its slots; q and its
  online-softmax state (acc, m, l) make sp hops around the ring, attending
  each rank's slice (`ring_pass_q_cache_attention`);
- **ring pass-kv** (slots over sp): the same write; the K/V slices (with
  their scale slices under int8) travel while the queries stay
  (`ring_pass_kv_cache_attention`). A slice's mask is its live length,
  which both ends of a hop compute on the host, so only the live prefix of
  a slice is sent and a slice with no live token is not sent at all.

The ring modes' local attention (`_local_attn_lse`) is B1 / B2 with
`return_lse` on the card, and on the CPU the plain attention over the
dequantized slice that the single-device dispatcher takes there. Every
cache validity mask is a prefix of the slots, so each slice's live length
is known on the host; a slice with no live row skips the attention and
contributes out 0, lse -inf (rows of a [B] batch with no live token get lse
-inf too), which the merge weighs 0.

Under tp each rank enters with its tp-local heads (H / tp): the ulysses
all-to-all splits them again over sp, so the rank attends heads slice
t sp + s of tp sp (the JAX `("tp", "sp")` axis), and the ring modes keep
the rank's tp heads over its sp slot slice (JAX `wan_kv_cache_pspec`).

MAGI (`models/magi/dit.py`):
- **`cso_chunk_attention`**: q enters as the rank's token shard of every
  chunk (a contiguous 1/sp of each chunk's tokens, JAX `P("dp", None,
  "sp", ...)`); per chunk, an all-to-all turns it into every token of the
  chunk for the rank's heads, the GQA fold (B1 / B2 on the card) attends
  the rank's kv heads of the window cache over the chunk's span [start,
  min(end, current_end)) (host ints), and the reverse all-to-all follows;
  `whole_window=True` is "ulysses": one all-to-all pair for the whole
  window, the spans still a chunk each (JAX `:538-557`);
- **`gqa_head_island`**: the JAX island is collective-free because GSPMD
  reshards its inputs by heads; here q (and fresh k / v) are token shards,
  so they go through `tokens_to_heads`, the fold attends the rank's
  Hq / (tp sp) heads over its Hkv / (tp sp) kv heads, and the output comes
  back through `heads_to_tokens`. K/V computed from replicated inputs
  (the caption's) hold every token: the rank takes its kv heads, no
  exchange.
"""
from __future__ import annotations

from typing import List, Optional, Sequence, Tuple, Union

import torch

from ..kvcache.cache import (KVCacheSpec, block_fields, live_tokens, token_major,
                             valid_mask, write_fields)
from ..ops.attention import attention_chunked, cache_attention
from ..ops.flash_attention import (FP8, flash_attention_gqa, flash_attention_gqa_quant,
                                   flash_attention_prefix, flash_attention_prefix_quant)
from .mesh import (CacheShard, SPMesh, gather_frame_shards, heads_to_tokens,
                   tokens_to_heads)

MODES = ("ulysses", "ring", "ring_pass_q", "ring_pass_kv")
Lengths = Union[int, List[int]]


def _row_lengths(live, lo: int, hi: int) -> Lengths:
    """Live tokens of the slot slice [lo, hi): an int for an int live
    count, a list (one a row) for a [B] one."""
    if isinstance(live, int):
        return max(0, min(live, hi) - lo)
    return [max(0, min(int(x), hi) - lo) for x in live.tolist()]


def _most(n: Lengths) -> int:
    return n if isinstance(n, int) else max(n)


def _local_attn_lse(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, kv_len: Lengths,
                    k_scale: Optional[torch.Tensor] = None,
                    v_scale: Optional[torch.Tensor] = None
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """q [B, Sq, H, D] over the live prefix [0, kv_len) of a token-major
    cache slice k/v [B, n, H, D] (k_scale/v_scale [B, n, H] mark it int8):
    (out, lse [B, H, Sq] f32). On the card B1 / B2
    (`flash_attention_prefix*`); on the CPU the plain attention of the
    dequantized (or cast) slice, as `cache_attention` takes there. No live
    token in any row: no launch, out 0 and lse -inf; a row with none gets
    lse -inf."""
    b, sq, h, _ = q.shape
    if _most(kv_len) == 0:
        return (torch.zeros_like(q),
                torch.full((b, h, sq), float("-inf"), device=q.device))
    n = kv_len if isinstance(kv_len, int) else torch.tensor(kv_len, dtype=torch.int32)
    if q.is_cuda:
        if k_scale is not None:
            out, lse = flash_attention_prefix_quant(q, k, v, k_scale, v_scale, n,
                                                    return_lse=True)
        else:
            out, lse = flash_attention_prefix(q, k, v, n, return_lse=True)
    else:
        if k_scale is not None:
            k = (k.float() * k_scale[..., None].float()).to(q.dtype)
            v = (v.float() * v_scale[..., None].float()).to(q.dtype)
        elif k.dtype == FP8:
            k, v = k.to(q.dtype), v.to(q.dtype)
        idx = torch.arange(k.shape[1])
        mask = idx < (n if isinstance(n, int) else n[:, None])
        out, lse = attention_chunked(q, k, v, kv_mask=mask)
    if not isinstance(kv_len, int) and min(kv_len) == 0:
        dead = torch.tensor([x == 0 for x in kv_len], device=q.device)
        lse = lse.masked_fill(dead[:, None, None], float("-inf"))
        out = out.masked_fill(dead[:, None, None, None], 0)
    return out, lse


def merge_step(acc: torch.Tensor, m_run: torch.Tensor, l_run: torch.Tensor,
               out_i: torch.Tensor, lse_i: torch.Tensor):
    """Fold one partial result (out_i, lse_i) into the online-softmax state
    (acc [B, Sq, H, D] f32, m and l [B, H, Sq]); a -inf lse weighs 0."""
    m_new = torch.maximum(m_run, lse_i)
    m_safe = torch.where(torch.isfinite(m_new), m_new, torch.zeros_like(m_new))
    zero = torch.zeros_like(m_new)
    w_old = torch.where(torch.isfinite(m_run), torch.exp(m_run - m_safe), zero)
    w_new = torch.where(torch.isfinite(lse_i), torch.exp(lse_i - m_safe), zero)
    acc = acc * w_old.transpose(1, 2)[..., None] \
        + out_i.float() * w_new.transpose(1, 2)[..., None]
    return acc, m_new, l_run * w_old + w_new


def _finish(acc: torch.Tensor, l_run: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    return (acc / torch.clamp(l_run, min=1e-30).transpose(1, 2)[..., None]).to(dtype)


def _start_state(q: torch.Tensor):
    b, s, h, d = q.shape
    return (torch.zeros(b, s, h, d, dtype=torch.float32, device=q.device),
            torch.full((b, h, s), float("-inf"), device=q.device),
            torch.zeros(b, h, s, device=q.device))


# ---------------------------------------------------------------------------
# The write into a sharded cache
# ---------------------------------------------------------------------------

def sp_write_block(mesh: SPMesh, mode: str, spec: KVCacheSpec, shard: CacheShard,
                   layer: Tuple[torch.Tensor, ...], k: torch.Tensor, v: torch.Tensor,
                   current_start, frames: int) -> Tuple[torch.Tensor, ...]:
    """Write this rank's frame shard of the block's K/V [B, n/sp, H, D] into
    the sharded cache layer, in place. The rows go in storage form (int8
    codes and scales, quantized here by B4, or the cache dtype): under
    ulysses an all-to-all per field brings every token of this rank's heads;
    under the ring modes every rank's rows are gathered and this rank writes
    the pieces in its slots."""
    new = block_fields(spec, k, v)
    if mode == "ulysses":
        new = tuple(tokens_to_heads(mesh, f, frames) for f in new)
        return write_fields(spec, layer, new, current_start)
    new = tuple(gather_frame_shards(mesh, f, frames) for f in new)
    return write_fields(spec, layer, new, current_start, slot_range=(shard.lo, shard.hi))


# ---------------------------------------------------------------------------
# The islands, over the written cache
# ---------------------------------------------------------------------------

def ulysses_cache_attention(mesh: SPMesh, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                            kv_mask: Optional[torch.Tensor], frames: int,
                            k_scale: Optional[torch.Tensor] = None,
                            v_scale: Optional[torch.Tensor] = None,
                            kv_layout: str = "bshd",
                            logical_kv: Optional[int] = None) -> torch.Tensor:
    """q: this rank's frame shard [B, n/sp, H, D]; k/v: its heads' cache
    layer ([B, S, H/sp, D], or [B, H/sp, S, D] for "bhsd"; scales alike).
    Returns its frame shard of the output."""
    qg = tokens_to_heads(mesh, q, frames)
    out = cache_attention(qg, k, v, kv_mask=kv_mask, logical_kv=logical_kv,
                          k_scale=k_scale, v_scale=v_scale, kv_layout=kv_layout)
    return heads_to_tokens(mesh, out, frames)


def ring_pass_q_cache_attention(mesh: SPMesh, q: torch.Tensor, k: torch.Tensor,
                                v: torch.Tensor, kv_len: Lengths,
                                k_scale: Optional[torch.Tensor] = None,
                                v_scale: Optional[torch.Tensor] = None,
                                kv_layout: str = "bshd") -> torch.Tensor:
    """q: this rank's tokens [B, Sq, H, D]; k/v: its slot slice of the
    cache layer (scales alike), live for kv_len (int or one a row). The
    (q, acc, m, l) bundle makes sp hops; the K/V stay."""
    hm = kv_layout == "bhsd"
    k, v = token_major(k, hm), token_major(v, hm)
    if k_scale is not None:
        k_scale, v_scale = token_major(k_scale, hm), token_major(v_scale, hm)
    acc, m, l_run = _start_state(q)
    q_cur = q
    shapes = [q.shape, acc.shape, m.shape, l_run.shape]
    for _ in range(mesh.size):
        out_i, lse_i = _local_attn_lse(q_cur, k, v, kv_len, k_scale, v_scale)
        acc, m, l_run = merge_step(acc, m, l_run, out_i, lse_i)
        q_cur, acc, m, l_run = mesh.ring_shift([q_cur, acc, m, l_run], shapes)
    return _finish(acc, l_run, q.dtype)


def ring_pass_kv_cache_attention(mesh: SPMesh, q: torch.Tensor, k: torch.Tensor,
                                 v: torch.Tensor, kv_lens: Sequence[Lengths],
                                 k_scale: Optional[torch.Tensor] = None,
                                 v_scale: Optional[torch.Tensor] = None,
                                 kv_layout: str = "bshd") -> torch.Tensor:
    """As `ring_pass_q_cache_attention`, but the slices travel: kv_lens[o]
    is the live length of rank o's slice. At step t this rank holds rank
    (rank - t)'s slice; only its live prefix is sent on, with its scales."""
    hm = kv_layout == "bhsd"
    fields = [token_major(k, hm), token_major(v, hm)]
    if k_scale is not None:
        fields += [token_major(k_scale, hm), token_major(v_scale, hm)]
    n0 = _most(kv_lens[mesh.rank])
    cur = [f[:, :n0] for f in fields]
    acc, m, l_run = _start_state(q)
    for step in range(mesh.size):
        origin = (mesh.rank - step) % mesh.size
        out_i, lse_i = _local_attn_lse(q, cur[0], cur[1], kv_lens[origin], *cur[2:])
        acc, m, l_run = merge_step(acc, m, l_run, out_i, lse_i)
        if step < mesh.size - 1:
            n_next = _most(kv_lens[(origin - 1) % mesh.size])
            cur = mesh.ring_shift(cur, [(f.shape[0], n_next) + tuple(f.shape[2:])
                                        for f in cur])
    return _finish(acc, l_run, q.dtype)


def sp_cache_attention(mesh: SPMesh, mode: str, spec: KVCacheSpec, shard: CacheShard,
                       q: torch.Tensor, layer: Tuple[torch.Tensor, ...], current_end,
                       frames: int) -> torch.Tensor:
    """The island of `mode` over the written cache layer (k, v[, k_scale,
    v_scale]) of this rank's shard; current_end: the block's end position
    (int, or [B] CPU tensor)."""
    kv_layout = "bhsd" if spec.head_major else "bshd"
    scales = layer[2:] if spec.quantized else (None, None)
    if mode == "ulysses":
        kv_mask = valid_mask(spec, current_end, device=q.device)
        return ulysses_cache_attention(mesh, q, layer[0], layer[1], kv_mask, frames,
                                       *scales, kv_layout=kv_layout,
                                       logical_kv=spec.max_tokens)
    live = live_tokens(spec, current_end)
    if mode in ("ring", "ring_pass_q"):
        return ring_pass_q_cache_attention(
            mesh, q, layer[0], layer[1], _row_lengths(live, shard.lo, shard.hi),
            *scales, kv_layout=kv_layout)
    if mode == "ring_pass_kv":
        per = shard.hi - shard.lo
        lens = [_row_lengths(live, o * per, (o + 1) * per) for o in range(mesh.size)]
        return ring_pass_kv_cache_attention(mesh, q, layer[0], layer[1], lens, *scales,
                                            kv_layout=kv_layout)
    raise ValueError(f"unknown sp attention mode {mode!r}")


# ---------------------------------------------------------------------------
# MAGI: the CSO / ulysses window island and the head island
# ---------------------------------------------------------------------------

def _span_attention(q: torch.Tensor, fields: Sequence[torch.Tensor], start: int,
                    end: int) -> torch.Tensor:
    """The GQA fold of q [B, ct, Hq, D] over the token-major cache fields
    (k, v[, k_scale, v_scale]) on [start, end)."""
    if len(fields) == 4:
        return flash_attention_gqa_quant(q, *fields, kv_len=end, kv_start=start)
    return flash_attention_gqa(q, fields[0], fields[1], kv_len=end, kv_start=start)


def cso_chunk_attention(mesh: SPMesh, q: torch.Tensor, fields: Sequence[torch.Tensor],
                        token_ranges: Sequence[Tuple[int, int]], current_end: int,
                        whole_window: bool = False) -> torch.Tensor:
    """q: [B, n_chunks, ct/sp, Hq_loc, D], the rank's token shard of every
    chunk (its tp-local heads); fields: the rank's kv heads of the window
    cache layer, token-major views (k, v[, k_scale, v_scale]);
    token_ranges: each chunk's [start, end) in tokens. Returns the rank's
    shard of the output, q's shape."""
    b, nc, cs, h, d = q.shape
    if whole_window:
        qg = tokens_to_heads(mesh, q.reshape(b, nc * cs, h, d), nc)
        ct = qg.shape[1] // nc
        outs = [_span_attention(qg[:, ci * ct:(ci + 1) * ct], fields, start,
                                min(end, current_end))
                for ci, (start, end) in enumerate(token_ranges)]
        out = outs[0] if nc == 1 else torch.cat(outs, dim=1)
        return heads_to_tokens(mesh, out, nc).reshape(b, nc, cs, h, d)
    outs = []
    for ci, (start, end) in enumerate(token_ranges):
        qg = tokens_to_heads(mesh, q[:, ci], 1)
        outs.append(heads_to_tokens(
            mesh, _span_attention(qg, fields, start, min(end, current_end)), 1))
    return torch.stack(outs, dim=1)


def gqa_head_island(mesh: SPMesh, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    kv_len=None, kv_tokens_sharded: bool = True) -> torch.Tensor:
    """q: [B, S/sp, Hq_loc, D] the rank's token shard (tp-local heads);
    k/v: likewise token shards [B, Skv/sp, Hkv_loc, D], or with
    kv_tokens_sharded=False every token [B, Skv, Hkv_loc, D] (computed from
    replicated inputs). The rank attends its 1/sp of the heads over every
    token (kv_len: a prefix length, int or [B]; default all), and gets its
    token shard back."""
    qg = tokens_to_heads(mesh, q, 1)
    if kv_tokens_sharded:
        kg, vg = tokens_to_heads(mesh, k, 1), tokens_to_heads(mesh, v, 1)
    else:
        per = k.shape[2] // mesh.size
        if k.shape[2] % mesh.size:
            raise ValueError(f"{k.shape[2]} kv heads do not split over sp {mesh.size}")
        kg, vg = (x[:, :, mesh.rank * per:(mesh.rank + 1) * per] for x in (k, v))
    out = flash_attention_gqa(qg, kg, vg, kv_len=kg.shape[1] if kv_len is None else kv_len)
    return heads_to_tokens(mesh, out, 1)


def sp_comm_bytes_per_layer(mode: str, sp: int, tp: int, batch: int, block_tokens: int,
                            cache_tokens: int, num_heads: int, head_dim: int,
                            itemsize: int = 2) -> int:
    """The JAX package's count of the bytes each device puts on the wire for
    one layer's attention exchange in one forward (its formula, integer for
    integer). The port's own count (`SPMesh.sent_bytes`) differs: it adds
    the cache write's exchange, sends only the live prefix of a pass-kv
    slice and makes sp - 1 pass-kv hops."""
    if sp <= 1 or mode == "none":
        return 0
    h_loc = num_heads // tp
    if mode in ("ulysses", "cso"):
        local = batch * (block_tokens // sp) * h_loc * head_dim * itemsize
        return 2 * local * (sp - 1) // sp * sp
    if mode == "ring_pass_kv":
        kv_bytes = 2 * batch * (cache_tokens // sp) * h_loc * head_dim * itemsize
        mask_bytes = batch * (cache_tokens // sp)
        return sp * (kv_bytes + mask_bytes)
    q_bytes = batch * (block_tokens // sp) * h_loc * head_dim * itemsize
    acc_bytes = batch * (block_tokens // sp) * h_loc * head_dim * 4
    ml_bytes = 2 * batch * h_loc * (block_tokens // sp) * 4
    return sp * (q_bytes + acc_bytes + ml_bytes)
