"""Seeded weight trees, made on the device in a few large draws.

A tree is first described leaf by leaf (`Leaf`: shape, dtype and how it is
drawn), then made at once: every uniform leaf of one dtype is a view of one
flat draw U(-1, 1) scaled by its bound, every normal leaf a view of one
flat N(0, 1) draw scaled by its std, the rest ones or zeros. The same seed
gives the same tree on the same device. The trees have the layout of the
program's own parameter trees (linear weights [in, out], transformer layers
stacked on a leading axis, VAE convs [kt, kh, kw, Cin, Cout]), so the program
and the reference are handed the same tensors.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, List, Tuple

import torch


@dataclasses.dataclass(frozen=True)
class Leaf:
    shape: Tuple[int, ...]
    dtype: torch.dtype
    kind: str            # "uniform" (scale = bound), "normal" (scale = std), "ones", "zeros"
    scale: float = 1.0


def _leaves(tree, path=()):
    if isinstance(tree, Leaf):
        yield path, tree
    elif isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, path + (k,))
    else:
        for i, v in enumerate(tree):
            yield from _leaves(v, path + (i,))


def _rebuild(tree, made, path=()):
    if isinstance(tree, Leaf):
        return made[path]
    if isinstance(tree, dict):
        return {k: _rebuild(v, made, path + (k,)) for k, v in tree.items()}
    return [_rebuild(v, made, path + (i,)) for i, v in enumerate(tree)]


def materialize(spec, generator: torch.Generator, device) -> Any:
    """The tree of `spec` with every leaf made on `device` from `generator`."""
    leaves = list(_leaves(spec))
    made: Dict[tuple, torch.Tensor] = {}
    for kind in ("uniform", "normal"):
        for dtype in sorted({lf.dtype for _, lf in leaves if lf.kind == kind}, key=str):
            group = [(p, lf) for p, lf in leaves if lf.kind == kind and lf.dtype == dtype]
            total = sum(math.prod(lf.shape) for _, lf in group)
            flat = torch.empty(total, dtype=dtype, device=device)
            if kind == "uniform":
                flat.uniform_(-1.0, 1.0, generator=generator)
            else:
                flat.normal_(0.0, 1.0, generator=generator)
            at = 0
            for p, lf in group:
                n = math.prod(lf.shape)
                made[p] = flat[at:at + n].view(lf.shape).mul_(lf.scale)
                at += n
    for p, lf in leaves:
        if lf.kind in ("ones", "zeros"):
            fill = torch.ones if lf.kind == "ones" else torch.zeros
            made[p] = fill(lf.shape, dtype=lf.dtype, device=device)
    return _rebuild(spec, made)


# -- Wan2.1 DiT --------------------------------------------------------------


def wan_dit_spec(m: Dict, modulation_std: float, dtype=torch.bfloat16) -> Dict:
    """The block-causal Wan DiT (t2v) of the model section `m`: linears
    U(-1/sqrt(in), 1/sqrt(in)) with zero biases, unit norm weights, AdaLN
    modulation tables N(0, modulation_std^2) in float32; the time embedding
    MLP and its projection in float32 (Wan keeps them so)."""
    d, ffn, L = m["dim"], m["ffn_dim"], m["num_layers"]
    patch = math.prod(m.get("patch_size", (1, 2, 2)))
    f32 = torch.float32

    def lin(i, o, dt=dtype, layers=()):
        return {"w": Leaf((*layers, i, o), dt, "uniform", 1.0 / math.sqrt(i)),
                "b": Leaf((*layers, o), dt, "zeros")}

    def attn():
        return {**{n: lin(d, d, layers=(L,)) for n in ("q", "k", "v", "o")},
                "norm_q": {"w": Leaf((L, d), dtype, "ones")},
                "norm_k": {"w": Leaf((L, d), dtype, "ones")}}

    return {
        "patch_embedding": lin(patch * m.get("in_dim", 16), d),
        "text_embedding": {"fc1": lin(m.get("text_dim", 4096), d), "fc2": lin(d, d)},
        "time_embedding": {"fc1": lin(m.get("freq_dim", 256), d, f32), "fc2": lin(d, d, f32)},
        "time_projection": lin(d, 6 * d, f32),
        "blocks": {
            "self_attn": attn(),
            "cross_attn": attn(),
            "norm3": {"w": Leaf((L, d), dtype, "ones"), "b": Leaf((L, d), dtype, "zeros")},
            "ffn": {"fc1": lin(d, ffn, layers=(L,)), "fc2": lin(ffn, d, layers=(L,))},
            "modulation": Leaf((L, 6, d), f32, "normal", modulation_std),
        },
        "head": {"head": lin(d, patch * m.get("out_dim", 16)),
                 "modulation": Leaf((2, d), f32, "normal", modulation_std)},
    }


# -- Wan2.1 causal VAE decoder -----------------------------------------------


def wan_vae_decoder_spec(v: Dict, dtype=torch.bfloat16) -> Dict:
    """The Wan2.1 VAE's decoder and its 1x1x1 `conv2` (section `v`: dim,
    z_dim, dim_mult, num_res_blocks, temperal_downsample): conv weights and
    biases U(-1/sqrt(fan_in), 1/sqrt(fan_in)), RMS-norm gammas 1, the
    attention output projection U(-1/sqrt(C), 1/sqrt(C)) (drawn, so the
    attention changes the pixels)."""
    dim, z = v["dim"], v["z_dim"]
    mult = tuple(v["dim_mult"])
    t_up = tuple(reversed(v["temperal_downsample"]))

    def cv(kt, kh, kw, cin, cout):
        bound = 1.0 / math.sqrt(kt * kh * kw * cin)
        return {"w": Leaf((kt, kh, kw, cin, cout), dtype, "uniform", bound),
                "b": Leaf((cout,), dtype, "uniform", bound)}

    def gamma(c):
        return {"gamma": Leaf((c,), dtype, "ones")}

    def res(cin, cout):
        p = {"norm1": gamma(cin), "conv1": cv(3, 3, 3, cin, cout),
             "norm2": gamma(cout), "conv2": cv(3, 3, 3, cout, cout)}
        if cin != cout:
            p["shortcut"] = cv(1, 1, 1, cin, cout)
        return p

    def attn(c):
        return {"norm": gamma(c), "qkv": cv(1, 1, 1, c, 3 * c),
                "proj": {"w": Leaf((1, 1, 1, c, c), dtype, "uniform", c ** -0.5),
                         "b": Leaf((c,), dtype, "zeros")}}

    dims = [dim * u for u in (mult[-1], *reversed(mult))]
    ups: List[Dict] = []
    for i, (cin, cout) in enumerate(zip(dims[:-1], dims[1:])):
        if i in (1, 2, 3):
            cin = cin // 2
        for _ in range(v["num_res_blocks"] + 1):
            ups.append({"res": res(cin, cout)})
            cin = cout
        if i != len(mult) - 1:
            mode = "upsample3d" if t_up[i] else "upsample2d"
            r = {"conv": cv(1, 3, 3, cout, cout // 2)}
            if mode == "upsample3d":
                r["time_conv"] = cv(3, 1, 1, cout, 2 * cout)
            ups.append({f"resample:{mode}": r})
    dec = {"conv1": cv(3, 3, 3, z, dims[0]),
           "middle": {"res1": res(dims[0], dims[0]), "attn": attn(dims[0]),
                      "res2": res(dims[0], dims[0])},
           "upsamples": ups,
           "head_norm": gamma(dim),
           "head_conv": cv(3, 3, 3, dim, 3)}
    return {"decoder": dec, "conv2": cv(1, 1, 1, z, z)}
