"""MAGI special-token caption padding (a copy of
`inferix_tpu/pipeline/magi_tokens.py`, host-side numpy; `pad_special_tokens`
takes and returns tensors on the caller's device).

The reference prepends learned special-token embeddings to the caption
(`pipeline/magi/prompt_process.py:31-129`): style controls (HQ, static/
dynamic first frames, borderness, 3D/2D-anime) selected by PAD_* env
flags, negative-prompt tokens (CAPTION/LOGO/TRANS/BORDERNESS) under
NEG_PROMPT, and per-chunk DURATION_TOKEN_N countdowns under PAD_DURATION.
The token VECTORS live in an asset file the reference ships
(`example/magi/assets/special_tokens.npz`, `SPECIAL_TOKEN_PATH` env) —
they are model data, so this module implements the MECHANISM and loads
the vectors from a user-supplied path; nothing is vendored.

Layout parity with the reference npz:
  caption_token  [1, D]
  logo_token     [1, D]
  other_tokens   [N, D] with rows: 0 trans, 1 hq, 2 static-first-frames,
                 3 dynamic-first-frames, 4 borderness, 7..14 duration
                 tokens 1..8, 15 3d-model, 16 2d-anime.
"""
from __future__ import annotations

import os
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

_OTHER_ROWS = {
    "TRANS_TOKEN": 0,
    "HQ_TOKEN": 1,
    "STATIC_FIRST_FRAMES_TOKEN": 2,
    "DYNAMIC_FIRST_FRAMES_TOKEN": 3,
    "BORDERNESS_TOKEN": 4,
    "THREE_D_MODEL_TOKEN": 15,
    "TWO_D_ANIME_TOKEN": 16,
}
_ENV_FLAGS = {
    "PAD_STATIC": "STATIC_FIRST_FRAMES_TOKEN",
    "PAD_DYNAMIC": "DYNAMIC_FIRST_FRAMES_TOKEN",
    "PAD_BORDERNESS": "BORDERNESS_TOKEN",
    "PAD_HQ": "HQ_TOKEN",
    "PAD_THREE_D_MODEL": "THREE_D_MODEL_TOKEN",
    "PAD_TWO_D_ANIME": "TWO_D_ANIME_TOKEN",
}


def _env_is_true(name: str) -> bool:
    return os.getenv(name, "").lower() in ("1", "true", "yes", "on")


def load_special_tokens(path: Optional[str] = None
                        ) -> Dict[str, np.ndarray]:
    """SPECIAL_TOKEN_PATH npz -> {name: [1, D]} token table (reference
    prompt_process.py:31-58 naming)."""
    path = path or os.getenv("SPECIAL_TOKEN_PATH")
    if not path:
        raise ValueError(
            "special tokens need a path (arg or SPECIAL_TOKEN_PATH env) — "
            "the vectors are model assets, not shipped with this repo")
    data = np.load(path)
    other = np.asarray(data["other_tokens"], np.float32)
    table = {
        "CAPTION_TOKEN": np.asarray(data["caption_token"], np.float32
                                    ).reshape(1, -1),
        "LOGO_TOKEN": np.asarray(data["logo_token"], np.float32
                                 ).reshape(1, -1),
    }
    for name, row in _OTHER_ROWS.items():
        table[name] = other[row:row + 1]
    for i in range(8):
        table[f"DURATION_TOKEN_{i + 1}"] = other[7 + i:8 + i]
    return table


def special_token_keys_from_env() -> List[str]:
    """PAD_* env flags -> token key list (reference get_special_token_keys;
    PAD_DURATION appends the per-chunk countdown marker)."""
    keys = [tok for env, tok in _ENV_FLAGS.items() if _env_is_true(env)]
    if _env_is_true("PAD_DURATION"):
        keys.append("DURATION_TOKEN")
    return keys


def negative_special_token_keys_from_env() -> Optional[List[str]]:
    if _env_is_true("NEG_PROMPT"):
        return ["CAPTION_TOKEN", "LOGO_TOKEN", "TRANS_TOKEN",
                "BORDERNESS_TOKEN"]
    return None


def pad_special_tokens(
    caption_emb: torch.Tensor,    # [1, L, D]
    caption_mask: torch.Tensor,   # [1, L]
    keys: List[str],
    table: Dict[str, np.ndarray],
    max_length: int = 800,
    chunks_remaining: Optional[int] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Prepend each selected token (reference _pad_special_token: token
    first, caption truncated to max_length, mask extended). DURATION_TOKEN
    resolves to DURATION_TOKEN_{min(chunks_remaining, 8)}: the "N chunks
    remain" countdown the reference pads per chunk
    (prompt_process.py:107-126). Returns float32 (embeddings, mask) on
    caption_emb's device."""
    emb = torch.as_tensor(caption_emb).float()
    dev = emb.device
    mask = torch.as_tensor(caption_mask, device=dev).float()
    for key in keys:
        if key == "DURATION_TOKEN":
            if chunks_remaining is None:
                raise ValueError(
                    "DURATION_TOKEN needs chunks_remaining (it encodes the "
                    "per-chunk countdown)")
            key = f"DURATION_TOKEN_{min(max(int(chunks_remaining), 1), 8)}"
        tok = torch.as_tensor(np.asarray(table[key], np.float32), device=dev).reshape(1, 1, -1)
        emb = torch.cat([tok.expand(emb.shape[0], 1, emb.shape[2]), emb],
                        dim=1)[:, :max_length]
        mask = torch.cat([torch.ones(mask.shape[0], 1, dtype=mask.dtype, device=dev),
                          mask], dim=1)[:, :max_length]
    return emb, mask
