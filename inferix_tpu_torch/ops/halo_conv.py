"""Stride-1 3x3(xkt) convolution for the VAE decode: the wrappers of the
hand-written CUDA kernels (`csrc/halo_conv.cu`) and their plain PyTorch
versions.

Port of `inferix_tpu/ops/halo_conv.py`: `halo_conv3d` (`:225`, TPU kernel
`_halo_conv_kernel` `:59`) and `halo_conv3d_w8a8` (`:161`, TPU kernel
`_halo_conv_kernel_i8` `:113`). The contract is the JAX one: x
[Tin, H, W, Cin], w [kt, 3, 3, Cin, Cout], b [Cout]; temporal VALID (the
causal caller prepends kt - 1 frames), spatial SAME, stride 1, f32
accumulation; the output [Tin - kt + 1, H, W, Cout] in x's dtype.

W8A8: a per-tensor activation scale s_x = max(absmax(x), 1e-8) / 127 and a
per-output-channel weight scale s_w = max(absmax(w[..., n]), 1e-8) / 127,
codes round(v / s) half to even clipped to +-127, computed here as the JAX
wrapper computes them in XLA (`halo_conv.py:183-190`); the kernel sums the
codes exactly and applies f32(acc) * (s_x * s_w) + b. The divisions by 127
are by a device scalar: PyTorch's CUDA division by a Python number
multiplies by the reciprocal, which moves scales by an ulp.

The kernels read the weight as [kt, 9, Cout, Cin]: per tap, each output
channel's Cin values contiguous (the rows of the TMA box that is wgmma's B
operand). `pack_weight` builds that operand (for W8A8 the weight codes and
s_w) once per conv; a caller that keeps it passes it as `packed`, else each
call builds it. TMA needs 16-byte rows, so the kernels take Cin a multiple
of 8 (bf16) or 16 (s8 codes): for any other Cin (the VAE encoder's RGB
input, Cin 3) `pack_weight` pads the operand's Cin with zero weights and the
wrapper pads x's channels with zeros. The sums are unchanged, and so are
B7's scales (the zeros raise no absmax), so this is exact. `tile_plan`
picks the kernel's tile for a conv class. The activation scale stays per
call, as in the JAX contract: on the card `quantize_conv_act` computes it
and the codes in one fused pair of passes (absmax, then codes), bit-equal
to its plain version `_quantize_conv_act`.

On CUDA tensors each wrapper launches its kernel (bfloat16 x) or raises; it
never falls back. On CPU tensors it takes its plain version.
"""
from __future__ import annotations

import ctypes
import math
from typing import NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from .. import _build


def _geometry(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor):
    if x.dim() != 4 or w.dim() != 5:
        raise ValueError(f"x must be [Tin, H, W, Cin] and w [kt, 3, 3, Cin, Cout], "
                         f"got {tuple(x.shape)} and {tuple(w.shape)}")
    kt, kh, kw, cin, cout = w.shape
    if kh != 3 or kw != 3:
        raise ValueError(f"the halo conv is specialised to 3x3 spatial, got {kh}x{kw}")
    if x.shape[-1] != cin or tuple(b.shape) != (cout,):
        raise ValueError(f"x {tuple(x.shape)}, w {tuple(w.shape)} and b "
                         f"{tuple(b.shape)} do not agree")
    t_out = x.shape[0] - (kt - 1)
    if t_out < 1:
        raise ValueError(f"{x.shape[0]} frames are too few for kt = {kt}")
    return kt, cin, cout, t_out


def tap_sum(xp: torch.Tensor, w: torch.Tensor, acc_dtype: torch.dtype) -> torch.Tensor:
    """A stride-1, temporal- and spatial-VALID conv as the sum over its
    kt*kh*kw taps of shifted x windows times the tap's weight, in the order
    dt, dh, dw: xp [..., Tp, Hp, Wp, Cin] (already padded), w [kt, kh, kw,
    Cin, Cout], both in acc_dtype; returns [..., Tp - kt + 1, Hp - kh + 1,
    Wp - kw + 1, Cout] in acc_dtype."""
    kt, kh, kw, cin, cout = w.shape
    *lead, tp, hp, wp, _ = xp.shape
    t_out, h_out, w_out = tp - (kt - 1), hp - (kh - 1), wp - (kw - 1)
    acc = torch.zeros(math.prod(lead) * t_out * h_out * w_out, cout, dtype=acc_dtype,
                      device=xp.device)
    for dt in range(kt):
        for dh in range(kh):
            for dw in range(kw):
                xs = xp[..., dt:dt + t_out, dh:dh + h_out, dw:dw + w_out, :]
                acc.addmm_(xs.reshape(-1, cin), w[dt, dh, dw])
    return acc.reshape(*lead, t_out, h_out, w_out, cout)


def halo_conv3d_reference(x: torch.Tensor, w: torch.Tensor,
                          b: torch.Tensor) -> torch.Tensor:
    """Plain version of the bf16 kernel: the kt*9 tap-shifted products in
    f32 on x and w in x's dtype, in the order dt, dh, dw (the arithmetic of
    JAX `vae.py:_conv3d_shifted_matmul`), + b in f32, cast to x's dtype."""
    _geometry(x, w, b)
    xp = F.pad(x.float(), (0, 0, 1, 1, 1, 1))
    out = tap_sum(xp, w.to(x.dtype).float(), torch.float32) + b.float()
    return out.to(x.dtype)


def _codes(v: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    return torch.clamp(torch.round(v / s), -127, 127).to(torch.int8)


def _quantize_conv_act(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of the activation quantization kernel: (codes s8 like x,
    s_x f32 0-dim) with s_x = max(absmax(x), 1e-8) / 127 and codes
    clamp(round(x / s_x), -127, 127), both divisions true ones."""
    xf = x.float()
    s_x = torch.clamp_min(xf.abs().amax(), 1e-8) / xf.new_full((), 127.0)
    return _codes(xf, s_x), s_x


def quantize_conv_act(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The W8A8 conv's per-tensor activation quantization: (codes s8 of x's
    shape, s_x f32 0-dim). On CUDA tensors (bfloat16, contiguous, a multiple
    of 8 elements) this launches the fused absmax + codes kernel pair and
    counts it in `quantize_conv_act.launches`; on CPU tensors it takes the
    plain version."""
    if not x.is_cuda:
        return _quantize_conv_act(x)
    if x.dtype != torch.bfloat16 or not x.is_contiguous():
        raise TypeError(f"the activation quantization kernel takes contiguous bfloat16 "
                        f"x, got {x.dtype} with strides {x.stride()}")
    if x.numel() % 8 or x.numel() == 0 or x.data_ptr() % 16:
        raise ValueError(f"the activation quantization kernel needs a 16-byte aligned "
                         f"x of a positive multiple of 8 elements, got {x.numel()}")
    q = torch.empty(x.shape, dtype=torch.int8, device=x.device)
    scal = torch.empty(2, dtype=torch.float32, device=x.device)  # [absmax, s_x]
    with torch.cuda.device(x.device):
        err = _library().inferix_conv_act_quant(
            x.data_ptr(), q.data_ptr(), scal.data_ptr(), x.numel(),
            torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"conv activation quantization launch failed: CUDA error {err}")
    quantize_conv_act.launches += 1
    return q, scal[1]


quantize_conv_act.launches = 0


def quantize_conv_weight(w: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(w codes s8 [kt, 3, 3, Cin, Cout], s_w f32 [Cout]): the JAX
    wrapper's per-output-channel weight quantization."""
    wf = w.float()
    s_w = torch.clamp_min(wf.abs().amax(dim=(0, 1, 2, 3)), 1e-8) \
        / wf.new_full((), 127.0)
    return _codes(wf, s_w), s_w


def quantize_conv_w8a8(x: torch.Tensor, w: torch.Tensor
                       ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(x codes s8, w codes s8 [kt, 3, 3, Cin, Cout], sv = s_x * s_w f32
    [Cout]): the JAX wrapper's per-tensor activation and per-output-channel
    weight quantization."""
    x_q, s_x = _quantize_conv_act(x)
    w_q, s_w = quantize_conv_weight(w)
    return x_q, w_q, s_x * s_w


def halo_conv3d_w8a8_reference(x: torch.Tensor, w: torch.Tensor,
                               b: torch.Tensor) -> torch.Tensor:
    """Plain version of the W8A8 kernel: the same codes, their products
    summed exactly (int32 on the CPU; float64 on the card, exact since
    |acc| <= 127^2 * kt * 9 * Cin < 2^53), then f32(acc) * sv + b in f32,
    cast to x's dtype."""
    _geometry(x, w, b)
    x_q, w_q, sv = quantize_conv_w8a8(x, w)
    acc_dtype = torch.float64 if x.is_cuda else torch.int32
    xp = F.pad(x_q.to(acc_dtype), (0, 0, 1, 1, 1, 1))
    acc = tap_sum(xp, w_q.to(acc_dtype), acc_dtype)
    out = acc.to(torch.float32) * sv + b.float()
    return out.to(x.dtype)


_ARGTYPES = {
    "inferix_halo_conv3d": ([ctypes.c_void_p] * 6      # x, w, bias, s_x, s_w, out
                            + [ctypes.c_int] * 9       # Tin, H, W, Cin, Cout, kt, n_tile, wgs, int8
                            + [ctypes.c_void_p]),      # stream
    "inferix_conv_act_quant": ([ctypes.c_void_p] * 3   # x, q, scal
                               + [ctypes.c_longlong, ctypes.c_void_p]),
}


def _library() -> ctypes.CDLL:
    lib = _build.load_library("halo_conv")
    for name, argtypes in _ARGTYPES.items():
        fn = getattr(lib, name)
        if fn.argtypes is None:
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
    return lib


# The kernel's tile (csrc/halo_conv.cu): 16 output columns by 8 * wgs rows
# (wgs consumer warpgroups of two 8 x 8-pixel m64 blocks) by n_tile output
# channels; its halo box has 2 more rows and columns.
TILE_COLS = 16


class TilePlan(NamedTuple):
    """The kernel's tiling of one conv class and what it costs in L2 -> SM
    traffic (the halo boxes and weight tiles every tile loads, counting the
    bytes that lie inside x and w: the zeros TMA fills at the border and
    past Cin and Cout cost no traffic, and the border is not subtracted)."""

    n_tile: int      # output channels a tile: 96, or 8 where Cout <= 8
    wgs: int         # consumer warpgroups
    tiles: int       # Tout * ceil(H / rows) * ceil(W / 16) * ceil(Cout / n_tile)
    halo_bytes: int  # L2 -> SM, all tiles
    weight_bytes: int

    @property
    def rows(self) -> int:
        return 8 * self.wgs

    @property
    def l2_bytes(self) -> int:
        return self.halo_bytes + self.weight_bytes


def tile_plan(tin: int, h: int, w: int, cin: int, cout: int, kt: int,
              int8: bool) -> TilePlan:
    """The tile the wrapper launches for x [tin, h, w, cin] and a kt x 3 x 3
    weight to cout channels: n_tile 96 (Cout 96, 192, 384 in 1, 2, 4 tiles;
    other Cout ragged) or 8 (Cout <= 8, the RGB head), and the warpgroup
    count (2 or 3: 16 or 24 rows) that pads H least, 3 on a tie."""
    esz = 1 if int8 else 2
    t_out = tin - kt + 1
    n_tile = 8 if cout <= 8 else 96
    wgs = min((3, 2), key=lambda g: -(-h // (8 * g)) * 8 * g)
    rows = 8 * wgs
    spatial = -(-h // rows) * -(-w // TILE_COLS)
    n_nt = -(-cout // n_tile)
    tiles = t_out * spatial * n_nt
    halo = tiles * kt * (rows + 2) * (TILE_COLS + 2) * cin * esz
    weights = t_out * spatial * kt * 9 * cin * esz * cout  # each tile its n_tile rows
    return TilePlan(n_tile, wgs, tiles, halo, weights)


def _launch(xk: torch.Tensor, wk: torch.Tensor, b: torch.Tensor, s_x, s_w,
            kt: int, cout: int, int8: bool) -> torch.Tensor:
    tin, h, wd, cin = xk.shape
    if xk.data_ptr() % 16 or wk.data_ptr() % 16:
        raise ValueError("x and the packed weight need 16-byte aligned bases")
    plan = tile_plan(tin, h, wd, cin, cout, kt, int8)
    out = torch.empty(tin - kt + 1, h, wd, cout, dtype=torch.bfloat16, device=xk.device)
    bias = b.to(torch.float32).contiguous()
    with torch.cuda.device(xk.device):
        err = _library().inferix_halo_conv3d(
            xk.data_ptr(), wk.data_ptr(), bias.data_ptr(),
            s_x.data_ptr() if int8 else None, s_w.data_ptr() if int8 else None,
            out.data_ptr(), tin, h, wd, cin, cout, kt, plan.n_tile, plan.wgs, int(int8),
            torch.cuda.current_stream(xk.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"halo_conv3d kernel launch failed: CUDA error {err}")
    return out


class PackedWeight(NamedTuple):
    """A conv weight as the kernel reads it: wk [kt, 9, Cout, Cin] (tap
    (dh, dw) as 3 dh + dw; per tap each output channel's Cin values
    contiguous), bf16 or, for W8A8, the weight codes with their scale s_w
    [Cout] f32."""

    wk: torch.Tensor
    s_w: Optional[torch.Tensor]


def padded_cin(cin: int, width: int) -> int:
    """Cin rounded up to a multiple of width: 8 for bf16, 16 for s8 codes."""
    return -(-cin // width) * width


def pack_weight(w: torch.Tensor, w8a8: bool = False) -> PackedWeight:
    """w [kt, 3, 3, Cin, Cout] -> the operand of the bf16 (or W8A8) kernel,
    [kt, 9, Cout, Cin'] with Cin' = Cin rounded up to a multiple of 8 (16
    for W8A8) and zero weights past Cin. s_w is the scale of the unpadded
    weight."""
    w_el, s_w = quantize_conv_weight(w) if w8a8 else (w.to(torch.bfloat16), None)
    kt, _, _, cin, cout = w_el.shape
    wk = w_el.permute(0, 1, 2, 4, 3).reshape(kt, 9, cout, cin)
    return PackedWeight(F.pad(wk, (0, padded_cin(cin, 16 if w8a8 else 8) - cin))
                        .contiguous(), s_w)


def _check_packed(packed: PackedWeight, w: torch.Tensor, w8a8: bool) -> None:
    kt, _, _, cin, cout = w.shape
    want = (kt, 9, cout, padded_cin(cin, 16 if w8a8 else 8))
    dtype = torch.int8 if w8a8 else torch.bfloat16
    if (tuple(packed.wk.shape) != want or packed.wk.dtype != dtype
            or packed.wk.device != w.device or (packed.s_w is None) == w8a8):
        raise ValueError(f"packed weight {tuple(packed.wk.shape)} {packed.wk.dtype} "
                         f"does not belong to w {tuple(w.shape)} on {w.device} "
                         f"(want {want} {dtype}, from pack_weight(w, w8a8={w8a8}))")


def _kernel_input(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, width: int
                  ) -> torch.Tensor:
    """Check the CUDA operands; return x as the kernel reads it, its
    channels zero-padded to a multiple of width (16-byte rows)."""
    if not (w.is_cuda and b.is_cuda and w.device == x.device == b.device):
        raise ValueError("x, w and b must lie on the same CUDA device")
    if x.dtype != torch.bfloat16:
        raise TypeError(f"the halo conv kernels take bfloat16 x on the card, got "
                        f"{x.dtype} (the plain version takes float32 on the CPU)")
    if not x.is_contiguous():
        raise ValueError(f"x must be contiguous, got strides {x.stride()}")
    pad = padded_cin(x.shape[-1], width) - x.shape[-1]
    return F.pad(x, (0, pad)) if pad else x


def halo_conv3d(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                packed: Optional[PackedWeight] = None) -> torch.Tensor:
    """Stride-1, spatial-SAME, temporal-VALID conv with bias, f32
    accumulation: x [Tin, H, W, Cin], w [kt, 3, 3, Cin, Cout], b [Cout] ->
    [Tin - kt + 1, H, W, Cout] in x's dtype. On CUDA tensors this launches
    the bf16 kernel on `packed` (`pack_weight(w)`, built here if None; x's
    channels zero-padded to a multiple of 8) and counts the launch in
    `halo_conv3d.launches`; on CPU tensors it takes the plain version."""
    kt, _, cout, _ = _geometry(x, w, b)
    if packed is not None:
        _check_packed(packed, w, False)
    if not x.is_cuda:
        if w.is_cuda or b.is_cuda:
            raise ValueError("x, w and b must lie on one device")
        return halo_conv3d_reference(x, w, b)
    xk = _kernel_input(x, w, b, 8)
    packed = packed if packed is not None else pack_weight(w)
    out = _launch(xk, packed.wk, b, None, None, kt, cout, False)
    halo_conv3d.launches += 1
    return out


halo_conv3d.launches = 0


def halo_conv3d_w8a8(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                     packed: Optional[PackedWeight] = None) -> torch.Tensor:
    """The same conv in W8A8 (per-tensor activation scale, per-output-channel
    weight scale, exact int32 sums, f32 epilogue): a lossy serving mode. On
    CUDA tensors this quantizes x (`quantize_conv_act`, its own kernel and
    count; x's channels zero-padded to a multiple of 16 first, which moves
    neither s_x nor a code) and launches the int8 kernel (bf16 x) on
    `packed` (`pack_weight(w, w8a8=True)`, built here if None), counting the
    launch in `halo_conv3d_w8a8.launches`; on CPU tensors it takes the plain
    version."""
    kt, _, cout, _ = _geometry(x, w, b)
    if packed is not None:
        _check_packed(packed, w, True)
    if not x.is_cuda:
        if w.is_cuda or b.is_cuda:
            raise ValueError("x, w and b must lie on one device")
        return halo_conv3d_w8a8_reference(x, w, b)
    xk = _kernel_input(x, w, b, 16)
    packed = packed if packed is not None else pack_weight(w, w8a8=True)
    x_q, s_x = quantize_conv_act(xk)
    out = _launch(x_q, packed.wk, b, s_x, packed.s_w, kt, cout, True)
    halo_conv3d_w8a8.launches += 1
    return out


halo_conv3d_w8a8.launches = 0
