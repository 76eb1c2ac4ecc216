"""Component-level device <-> host memory manager and the layer streamer
(port of `inferix_tpu/core/memory.py`).

`AsyncMemoryManager`: registered components (parameter trees: generator,
text encoder, VAE) swap between the card and host memory under a byte
budget, least recently used first, with `use()` / `exclusive()` contexts
and `prefetch`. Host copies are pinned when the component lives on a card.

`stream_layer_forward`: run a stack of layers whose stacked parameters live
in host memory, copying layer i + 1 from pinned host memory on a side CUDA
stream while layer i computes, with at most `prefetch` layer buffers on the
card (the reference's `DynamicSwapInstaller` low-VRAM mode).

Trees are nested dicts (and lists) of tensors, as everywhere in the port.
"""
from __future__ import annotations

import contextlib
import threading
import time
from typing import Any, Callable, Dict, List, Optional

import torch

from .device import resolve_device


def tree_map(fn: Callable, *trees: Any) -> Any:
    """fn over the leaves of one or more trees of the same structure."""
    first = trees[0]
    if isinstance(first, dict):
        return {k: tree_map(fn, *(t[k] for t in trees)) for k in first}
    if isinstance(first, (list, tuple)):
        return [tree_map(fn, *xs) for xs in zip(*trees)]
    return fn(*trees)


def tree_leaves(tree: Any) -> List[Any]:
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in tree_leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in tree_leaves(v)]
    return [tree]


def _tree_bytes(tree: Any) -> int:
    return sum(x.numel() * x.element_size() for x in tree_leaves(tree)
               if isinstance(x, torch.Tensor))


def to_host(tree: Any) -> Any:
    """A host copy of the tree: pinned tensors for leaves on a card (async
    copies back, the JAX `pinned_host` memory kind), plain CPU tensors
    otherwise."""
    def move(x):
        if not isinstance(x, torch.Tensor) or x.device.type == "cpu":
            return x
        return torch.empty(x.shape, dtype=x.dtype, pin_memory=True).copy_(x)

    return tree_map(move, tree)


def to_device(tree: Any, device: torch.device) -> Any:
    return tree_map(lambda x: x.to(device, non_blocking=True)
                    if isinstance(x, torch.Tensor) else x, tree)


class ManagedComponent:
    def __init__(self, name: str, tree: Any, on_update: Optional[Callable] = None):
        self.name = name
        self.tree = tree
        self.on_device = True
        self.last_used = time.monotonic()
        self.nbytes = _tree_bytes(tree)
        # called with the (moved) tree, so that its owner can rebind it
        self.on_update = on_update


class AsyncMemoryManager:
    """Budget-driven component swapper. A registered tree counts as on the
    device; `offload` and the budget move it to the host."""

    def __init__(self, budget_bytes: Optional[int] = None,
                 device: str | torch.device = "cuda"):
        self.budget_bytes = budget_bytes
        self.device = resolve_device(device)
        self._components: Dict[str, ManagedComponent] = {}
        self._lock = threading.Lock()

    # -- registration -------------------------------------------------------

    def register(self, name: str, tree: Any,
                 on_update: Optional[Callable] = None) -> None:
        with self._lock:
            self._components[name] = ManagedComponent(name, tree, on_update)

    def get(self, name: str) -> Any:
        return self._components[name].tree

    def device_bytes(self) -> int:
        return sum(c.nbytes for c in self._components.values() if c.on_device)

    # -- movement -----------------------------------------------------------

    def _move(self, comp: ManagedComponent, to_dev: bool) -> None:
        if comp.on_device == to_dev:
            return
        comp.tree = to_device(comp.tree, self.device) if to_dev else to_host(comp.tree)
        comp.on_device = to_dev
        if comp.on_update is not None:
            comp.on_update(comp.tree)

    def offload(self, name: str) -> None:
        with self._lock:
            self._move(self._components[name], to_dev=False)

    def prefetch(self, name: str) -> None:
        """Start moving a component to the device (an async copy from pinned
        memory on the card)."""
        with self._lock:
            comp = self._components[name]
            # a resident component brings no new bytes: counting them again
            # on top of device_bytes() would evict every other component
            incoming = 0 if comp.on_device else comp.nbytes
            self._ensure_budget(incoming, exclude=name)
            self._move(comp, to_dev=True)

    def _ensure_budget(self, incoming: int, exclude: str) -> None:
        if self.budget_bytes is None:
            return
        resident = [c for c in self._components.values()
                    if c.on_device and c.name != exclude]
        resident.sort(key=lambda c: c.last_used)
        while resident and self.device_bytes() + incoming > self.budget_bytes:
            self._move(resident.pop(0), to_dev=False)

    # -- contexts -----------------------------------------------------------

    @contextlib.contextmanager
    def use(self, name: str):
        """The component on the device for the duration."""
        self.prefetch(name)
        comp = self._components[name]
        comp.last_used = time.monotonic()
        yield comp.tree

    @contextlib.contextmanager
    def exclusive(self, name: str):
        """Offload every other component, then run with this one on the
        device; the others stay on the host afterwards (the reference's
        choreography around the VAE decode)."""
        with self._lock:
            for other in self._components.values():
                if other.name != name:
                    self._move(other, to_dev=False)
            self._move(self._components[name], to_dev=True)
        comp = self._components[name]
        comp.last_used = time.monotonic()
        yield comp.tree


def stream_layer_forward(blocks_host: Any, layer_fn: Callable, carry: Any,
                         device: str | torch.device, prefetch: int = 2) -> Any:
    """Run a layer stack whose stacked parameters live in host memory,
    streaming one layer at a time to `device`.

    blocks_host: a tree whose leaves are host tensors stacked on axis 0
    (leaf[i] is layer i's; pin them for the copies to overlap compute).
    layer_fn(carry, block) -> carry, with block the tree of one layer's
    tensors on the device.

    On a card, `prefetch` buffer sets of one layer each are allocated once
    and reused in turn: layer i's parameters are copied into set i % prefetch
    on a side stream, after the layer that used the set before has run (an
    event on the compute stream), and the compute stream waits for the copy
    (an event on the side stream). So the copies of the next layers overlap
    this layer's compute, at most `prefetch` layers are on the card, and the
    host never waits for the card. On the CPU the layers run in turn."""
    dev = resolve_device(device)
    leaves = tree_leaves(blocks_host)
    if not leaves:
        return carry
    n = leaves[0].shape[0]
    if dev.type != "cuda":
        for i in range(n):
            carry = layer_fn(carry, tree_map(lambda a: a[i].to(dev), blocks_host))
        return carry
    compute = torch.cuda.current_stream(dev)
    side = torch.cuda.Stream(dev)
    sets = min(prefetch, n)
    bufs = [tree_map(lambda a: torch.empty(a.shape[1:], dtype=a.dtype, device=dev),
                     blocks_host) for _ in range(sets)]
    ready = [torch.cuda.Event() for _ in range(sets)]
    done = [torch.cuda.Event() for _ in range(sets)]

    def fetch(i: int) -> None:
        j = i % sets
        with torch.cuda.stream(side):
            if i >= sets:
                side.wait_event(done[j])   # the layer that used set j has run
            tree_map(lambda buf, a: buf.copy_(a[i], non_blocking=True),
                     bufs[j], blocks_host)
            ready[j].record(side)

    for i in range(sets):
        fetch(i)
    for i in range(n):
        j = i % sets
        compute.wait_event(ready[j])
        carry = layer_fn(carry, bufs[j])
        done[j].record(compute)
        if i + sets < n:
            fetch(i + sets)
    return carry
