"""Pipeline parallelism over the mesh's pp axis (port of
`inferix_tpu/parallel/pipeline_parallel.py`: `pp_pipeline`, `pp_scan_layers`).

The JAX package runs a GPipe schedule inside one `shard_map` over pp: the
stacked layer axis [L, ...] of the parameters and of the per-layer state
(the KV cache) is sharded over pp, microbatches stream through the stages,
each tick every stage runs its local layers on the microbatch it holds and
hands the activation on with one neighbour `ppermute`, bubble ticks skip
their compute under `lax.cond`, and the last stage's outputs reach every
stage through a `psum`.

The port runs one process a rank, eagerly. Stage p holds layers
[p L/pp, (p+1) L/pp) of the tree and of the state, and only those
(`stage_layers`). It takes the microbatches in order: stage 0 injects
microbatch i, every other stage receives it from stage p - 1 (`SPMesh.recv`,
posted before the stage's own send), runs its local layers on it and sends
the result to stage p + 1 (`SPMesh.send`). Stage p then works on
microbatch i at tick i + p, the GPipe schedule of M + pp - 1 ticks, and a
bubble tick is simply time the stage spends waiting in `recv`: no layer runs
on it, so each rank makes exactly M x L/pp layer applications
(`pp_pipeline.layer_applications` counts them). The chain of sends has no
cycle, so gloo's blocking sends cannot deadlock. After the last microbatch
the last stage's outputs go to every stage by one broadcast over the pp
group. State is threaded per layer: a layer's new state is written back
into the stage's state (in place where the layer wrote it in place).
"""
from __future__ import annotations

from typing import Any, Callable, List, Optional, Tuple

import torch

from .mesh import Mesh, SPMesh


def _map(fn: Callable, tree: Any) -> Any:
    """fn on every tensor of a tree of dicts, lists, tuples and named tuples
    (None kept)."""
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):   # a named tuple
        return type(tree)(*(_map(fn, v) for v in tree))
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map(fn, v) for v in tree)
    return None if tree is None else fn(tree)


def _leaves(tree: Any) -> List[torch.Tensor]:
    out: List[torch.Tensor] = []
    _map(out.append, tree)
    return out


def _rebuild(like: Any, leaves: List[torch.Tensor]) -> Any:
    it = iter(leaves)
    return _map(lambda _: next(it), like)


def pp_group(mesh) -> SPMesh:
    """The pp group of a `Mesh`; an `SPMesh` is taken as the pp group
    itself; None is one stage."""
    if mesh is None:
        return SPMesh(rank=0, size=1, backend="gloo", device="cpu", name="pp")
    return mesh.pp if isinstance(mesh, Mesh) else mesh


def stage_layers(tree: Any, mesh, num_layers: Optional[int] = None) -> Any:
    """Stage p's layers [p L/pp, (p+1) L/pp) of every tensor of a tree whose
    leading axis is the layer axis, each a tensor of its own (the whole
    tree can then be freed). The tree as it is at pp 1. L % pp != 0 raises
    ValueError."""
    pp = pp_group(mesh)
    leaves = _leaves(tree)
    n = num_layers if num_layers is not None else leaves[0].shape[0]
    if n % pp.size:
        raise ValueError(f"{n} layers do not split over pp {pp.size}")
    if pp.size == 1:
        return tree
    per = n // pp.size
    lo = pp.rank * per
    for t in leaves:
        if t.shape[0] != n:
            raise ValueError(f"a leaf of shape {tuple(t.shape)} has no leading axis of "
                             f"{n} layers")
    return _map(lambda t: t[lo:lo + per].clone(), tree)


def pp_pipeline(
    mesh,
    layer_fn: Callable[..., Tuple[Any, Any]],
    stacked_params: Any,        # the stage's layers: a tree with leading L/pp axis
    microbatches: Any,          # a tree with leading M axis: the layer-0 activations
    layer_state: Any = None,    # optional tree with leading L/pp axis
    pass_mb_index: bool = False,
    collect: bool = True,
) -> Tuple[Any, Any]:
    """Run every microbatch through all L layers, the stage's L/pp of them
    here.

    layer_fn(params_slice, state_slice, x[, mb_idx]) -> (x_out,
    new_state_slice) applies ONE layer (the slices have no leading layer
    axis; state_slice is None without layer_state; mb_idx, the microbatch
    index, is passed with pass_mb_index, so that a layer can address the
    microbatch's rows of a shared state such as the KV cache's batch rows).
    x_out keeps x's tree, shapes and dtypes. Returns (the outputs with a
    leading M axis on every stage, the stage's updated layer_state).
    collect=False skips the final broadcast: the outputs are then the last
    stage's only (None elsewhere). mesh: a `Mesh`, its pp group, or None
    (one stage)."""
    pp = pp_group(mesh)
    local = _leaves(stacked_params)[0].shape[0]
    mb_leaves = _leaves(microbatches)
    m = mb_leaves[0].shape[0]
    first, last = pp.rank == 0, pp.rank == pp.size - 1
    wire = [(tuple(a.shape[1:]), a.dtype) for a in mb_leaves]
    outs = []
    for i in range(m):
        x_i = _map(lambda a: a[i], microbatches)
        # the stage's receive comes before its send: the chain has no cycle
        x = x_i if first else _rebuild(x_i, pp.recv(wire, pp.rank - 1))
        for layer in range(local):
            p_l = _map(lambda a: a[layer], stacked_params)
            s_l = _map(lambda a: a[layer], layer_state)
            args = (p_l, s_l, x) + ((i,) if pass_mb_index else ())
            x, s_new = layer_fn(*args)
            pp_pipeline.layer_applications += 1
            if layer_state is not None:
                for old, new in zip(_leaves(s_l), _leaves(s_new)):
                    if new.data_ptr() != old.data_ptr():
                        old.copy_(new)
        if not last:
            pp.send(_leaves(x), pp.rank + 1)
        else:
            outs.append(x)
    if not collect and not last:
        return None, layer_state
    if last:
        stacked = [torch.stack(ls) for ls in zip(*(_leaves(o) for o in outs))]
    else:
        stacked = [torch.empty((m,) + s, dtype=d, device="meta") for s, d in wire]
    if collect and pp.size > 1:
        stacked = [pp.broadcast(t, pp.size - 1) for t in stacked]
    return _rebuild(microbatches, stacked), layer_state


pp_pipeline.layer_applications = 0


def pp_scan_layers(mesh, layer_fn: Callable[[Any, torch.Tensor], torch.Tensor],
                   stacked_params: Any, x: torch.Tensor) -> torch.Tensor:
    """One activation through every stage's layers (one microbatch: the
    stages run in turn, each on its own layers)."""
    outs, _ = pp_pipeline(mesh, lambda p, s, h: (layer_fn(p, h), s), stacked_params, x[None])
    return outs[0]
