"""Mid-generation state checkpoints (port of `inferix_tpu/utils/state_checkpoint.py`).

A running stream's KV cache, positions, random state and trailing latents
are saved to one compressed npz and read back, so a stream resumes bit for
bit where it stopped, also in another process:

    save_generation_state(path, cache=cache, generator=g, frames_done=2)
    state = load_generation_state(path, device="cuda")

Keys are the tree's paths joined by '/'; a suffix marks what numpy cannot
hold as it is: `__bf16` and `__fp8` (bf16 and e4m3 values stored as
float32, exactly), `__none`, `__scalar` (a Python number). The format is the
JAX package's, so an npz that either package writes is read by the other
for its arrays. Random state is each package's own: the port stores a
`torch.Generator` as its `get_state()` bytes (`__generator_cpu` /
`__generator_cuda`), the JAX package its key data (`__prngkey`, read here
as the raw uint32 array).
"""
from __future__ import annotations

import os
from typing import Any, Dict

import numpy as np
import torch

from ..core.device import resolve_device

_GENERATOR = "__generator_"


def _flatten(tree: Dict[str, Any], prefix: str = "") -> Dict[str, np.ndarray]:
    out = {}
    for k, v in tree.items():
        key = f"{prefix}/{k}" if prefix else k
        if isinstance(v, dict):
            out.update(_flatten(v, key))
        elif v is None:
            out[f"{key}__none"] = np.zeros(0, np.uint8)
        elif isinstance(v, torch.Generator):
            out[f"{key}{_GENERATOR}{v.device.type}"] = v.get_state().numpy()
        elif isinstance(v, torch.Tensor):
            t = v.detach().cpu()
            if t.dtype == torch.float8_e4m3fn:
                out[f"{key}__fp8"] = t.float().numpy()
            elif t.dtype == torch.bfloat16:
                out[f"{key}__bf16"] = t.float().numpy()
            else:
                out[key] = t.numpy()
        elif isinstance(v, np.ndarray):
            out[key] = v
        else:
            out[f"{key}__scalar"] = np.asarray(v)
    return out


def _unflatten(flat: Dict[str, np.ndarray], dev: torch.device) -> Dict[str, Any]:
    tree: Dict[str, Any] = {}
    for key, arr in flat.items():
        if key.endswith("__none"):
            key, val = key[: -len("__none")], None
        elif _GENERATOR in key:
            key, kind = key.rsplit(_GENERATOR, 1)
            val = torch.Generator(device=dev if kind == "cuda" else "cpu")
            val.set_state(torch.from_numpy(arr))
        elif key.endswith("__bf16"):
            key = key[: -len("__bf16")]
            val = torch.from_numpy(arr).to(dev).to(torch.bfloat16)
        elif key.endswith("__fp8"):
            key = key[: -len("__fp8")]
            val = torch.from_numpy(arr).to(dev).to(torch.float8_e4m3fn)
        elif key.endswith("__scalar"):
            key = key[: -len("__scalar")]
            val = arr.item() if arr.ndim == 0 else arr
        else:
            if key.endswith("__prngkey"):
                key = key[: -len("__prngkey")]
            val = torch.from_numpy(arr).to(dev)
        parts = key.split("/")
        node = tree
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = val
    return tree


def save_generation_state(path: str, **state: Any) -> str:
    """Save named trees (a cache, latents, a generator, positions, ...) to
    one compressed npz; a NamedTuple (a `KVCache`) is saved as its fields."""
    flat = _flatten({k: (v._asdict() if hasattr(v, "_asdict") else v)
                     for k, v in state.items()})
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    np.savez_compressed(path, **flat)
    return path


def load_generation_state(path: str, device: str | torch.device = "cuda") -> Dict[str, Any]:
    """The trees saved by `save_generation_state`, their tensors on
    `device` (a CUDA generator is restored on it too)."""
    dev = resolve_device(device)
    with np.load(path, allow_pickle=False) as data:
        return _unflatten({k: data[k] for k in data.files}, dev)
