"""Native parameter checkpoints (port of `inferix_tpu/utils/native_checkpoint.py`).

A reference checkpoint is converted once (`utils/checkpoint.py`) and can
then be saved in the port's own form, so that a server skips the torch
parse and the layout transposes on every start. Quantized leaves (int8 or
e4m3 codes with their float32 scales) round-trip as they are, bit for bit.

The JAX package saves with orbax; the port saves with torch (one
`torch.save` of the nested tree in a directory, loaded memory-mapped and
weights-only), because the card's machine has no orbax. An orbax directory
and a port directory do not read each other.
"""
from __future__ import annotations

import os
from typing import Any, Dict, Optional

import torch

from ..core.device import resolve_device
from ..core.memory import tree_map

Params = Dict[str, Any]

_FILE = "params.pt"


def save_params(path: str, params: Params) -> str:
    """Save a parameter tree (nested dicts and lists of tensors) to the
    directory `path`; returns its absolute path."""
    path = os.path.abspath(path)
    os.makedirs(path, exist_ok=True)
    # a copy of each leaf, so that a view saves its own bytes and not its base's
    torch.save(tree_map(lambda x: x.detach().to("cpu", copy=True), params),
               os.path.join(path, _FILE))
    return path


def load_params(path: str, target: Optional[Params] = None,
                device: str | torch.device = "cuda") -> Params:
    """Load a tree saved by `save_params`. With `target` (a tree of the same
    structure), each leaf takes the dtype and device of its counterpart
    there; without one, every leaf goes to `device` as saved."""
    tree = torch.load(os.path.join(os.path.abspath(path), _FILE), map_location="cpu",
                      mmap=True, weights_only=True)
    if target is not None:
        return tree_map(lambda x, t: x.to(device=t.device, dtype=t.dtype), tree, target)
    dev = resolve_device(device)
    return tree_map(lambda x: x.to(dev), tree)
