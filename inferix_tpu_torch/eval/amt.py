"""AMT-S frame interpolation, the backbone of the motion-smoothness metric:
the port's copy of `inferix_tpu/eval/amt.py`.

The VBench motion-smoothness dimension drops a clip's odd frames,
re-synthesizes each by interpolating between its even neighbours with AMT-S
(embt = 0.5), and scores (255 - mean |actual - interpolated|) / 255 over the
uint8 frames (reference `LV-Bench/vbench/motion_smoothness.py:69-175`).

A condensed re-derivation of the AMT-S eval path (the reference vendors it at
`LV-Bench/vbench/third_party/amt`): one decoder factory, functional instance
norms, the bidirectional correlation pyramid as a closure. Parameter names
mirror the official module tree, so `amt-s.pth['state_dict']` loads
directly; `tests/fixtures/amt_tiny.npz` is the golden the reference's code
produced at a tiny config. Plain PyTorch: cuDNN convolutions, `grid_sample`
warps and one batched matmul for the correlation volume on the card.
`load_amt_s` and `MotionSmoothnessAMT` run on the card by default, and raise
without one.
"""
from __future__ import annotations

import math
from typing import List, Optional, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from ..core.device import resolve_device


def _resize(x, s):
    return F.interpolate(x, scale_factor=s, mode="bilinear",
                         align_corners=False)


def _convrelu(cin, cout, k=3, s=1, p=1):
    return nn.Sequential(nn.Conv2d(cin, cout, k, s, p), nn.PReLU(cout))


def _inorm(x):
    return F.instance_norm(x, eps=1e-5)


def warp(img, flow):
    """Border-padded bilinear backwarp (amt/utils/flow_utils.py)."""
    b, _, h, w = flow.shape
    xx = torch.linspace(-1.0, 1.0, w, device=img.device).view(1, 1, 1, w).expand(b, -1, h, -1)
    yy = torch.linspace(-1.0, 1.0, h, device=img.device).view(1, 1, h, 1).expand(b, -1, -1, w)
    grid = torch.cat([xx, yy], 1).to(img)
    flow_n = torch.cat([flow[:, 0:1] / ((w - 1.0) / 2.0),
                        flow[:, 1:2] / ((h - 1.0) / 2.0)], 1)
    grid = (grid + flow_n).permute(0, 2, 3, 1)
    return F.grid_sample(img, grid, mode="bilinear", padding_mode="border",
                         align_corners=True)


def _coords_grid(b, h, w, device):
    gy, gx = torch.meshgrid(torch.arange(h, device=device), torch.arange(w, device=device),
                            indexing="ij")
    return torch.stack([gx, gy], 0).float()[None].repeat(b, 1, 1, 1)


def _lookup(volume, coords, radius):
    """Sample a (2r+1)^2 window around per-pixel centroids from one pyramid
    level. volume: [B*H1*W1, 1, H2, W2]; coords: [B, H1, W1, 2] in LEVEL
    pixels."""
    r = radius
    b, h1, w1, _ = coords.shape
    d = torch.linspace(-r, r, 2 * r + 1, device=coords.device)
    # the official window enumeration stacks the (dy, dx) meshgrid and adds
    # component 0 to x — reproduce exactly (the flattened feature order is
    # what the update blocks' conv weights were trained on)
    delta = torch.stack(torch.meshgrid(d, d, indexing="ij"), -1)
    pts = coords.reshape(b * h1 * w1, 1, 1, 2) + delta.view(1, 2 * r + 1,
                                                            2 * r + 1, 2)
    h2, w2 = volume.shape[-2:]
    xg = 2 * pts[..., 0:1] / (w2 - 1) - 1
    yg = 2 * pts[..., 1:2] / (h2 - 1) - 1
    out = F.grid_sample(volume, torch.cat([xg, yg], -1), align_corners=True)
    return out.view(b, h1, w1, -1)


def bidir_corr_pyramid(fmap0, fmap1, num_levels=4, radius=3):
    """All-pairs correlation both ways + avg-pooled pyramid; returns a
    lookup closure (coords0, coords1) -> (corr0, corr1)."""
    b, dim, h, w = fmap0.shape
    corr = torch.matmul(fmap0.view(b, dim, h * w).transpose(1, 2),
                        fmap1.view(b, dim, h * w)) / math.sqrt(dim)
    corr = corr.view(b, h, w, 1, h, w)
    corr_t = corr.permute(0, 4, 5, 3, 1, 2).contiguous()
    pyr = [corr.reshape(b * h * w, 1, h, w)]
    pyr_t = [corr_t.reshape(b * h * w, 1, h, w)]
    for _ in range(num_levels - 1):
        pyr.append(F.avg_pool2d(pyr[-1], 2, stride=2))
        pyr_t.append(F.avg_pool2d(pyr_t[-1], 2, stride=2))

    def lookup(coords0, coords1):
        c0 = coords0.permute(0, 2, 3, 1)
        c1 = coords1.permute(0, 2, 3, 1)
        outs, outs_t = [], []
        for i in range(num_levels):
            outs.append(_lookup(pyr[i], c0 / 2 ** i, radius))
            outs_t.append(_lookup(pyr_t[i], c1 / 2 ** i, radius))
        out = torch.cat(outs, -1).permute(0, 3, 1, 2).contiguous().float()
        out_t = torch.cat(outs_t, -1).permute(0, 3, 1, 2).contiguous().float()
        return out, out_t

    return lookup


class _Bottleneck(nn.Module):
    """Instance-norm bottleneck (feat_enc.BottleneckBlock, norm='instance' —
    the norms carry no parameters, so they are functional here)."""

    def __init__(self, cin, planes, stride=1):
        super().__init__()
        self.conv1 = nn.Conv2d(cin, planes // 4, 1)
        self.conv2 = nn.Conv2d(planes // 4, planes // 4, 3, stride, 1)
        self.conv3 = nn.Conv2d(planes // 4, planes, 1)
        self.downsample = None
        if stride != 1:
            self.downsample = nn.Sequential(nn.Conv2d(cin, planes, 1,
                                                      stride))

    def forward(self, x):
        y = F.relu(_inorm(self.conv1(x)))
        y = F.relu(_inorm(self.conv2(y)))
        y = F.relu(_inorm(self.conv3(y)))
        if self.downsample is not None:
            x = _inorm(self.downsample(x))
        return F.relu(x + y)


class _SmallEncoder(nn.Module):
    """feat_enc.SmallEncoder(output_dim=84, norm_fn='instance')."""

    def __init__(self, output_dim=84):
        super().__init__()
        self.conv1 = nn.Conv2d(3, 32, 7, 2, 3)
        self.layer1 = nn.Sequential(_Bottleneck(32, 32), _Bottleneck(32, 32))
        self.layer2 = nn.Sequential(_Bottleneck(32, 64, 2),
                                    _Bottleneck(64, 64))
        self.layer3 = nn.Sequential(_Bottleneck(64, 96, 2),
                                    _Bottleneck(96, 96))
        self.conv2 = nn.Conv2d(96, output_dim, 1)

    def forward(self, x):
        x = F.relu(_inorm(self.conv1(x)))
        return self.conv2(self.layer3(self.layer2(self.layer1(x))))


class _ResBlock(nn.Module):
    """ifrnet.ResBlock: main/side-channel interleave with PReLUs."""

    def __init__(self, ch, side):
        super().__init__()
        self.side = side
        self.conv1 = _convrelu(ch, ch)
        self.conv2 = _convrelu(side, side)
        self.conv3 = _convrelu(ch, ch)
        self.conv4 = _convrelu(side, side)
        self.conv5 = nn.Conv2d(ch, ch, 3, 1, 1)
        self.prelu = nn.PReLU(ch)

    def forward(self, x):
        out = self.conv1(x)
        out = self.conv3(torch.cat([out[:, :-self.side],
                                    self.conv2(out[:, -self.side:])], 1))
        out = self.conv5(torch.cat([out[:, :-self.side],
                                    self.conv4(out[:, -self.side:])], 1))
        return self.prelu(x + out)


def _decoder(cat_ch, mid_ch, out_ch, skip_ch):
    """One decoder stage: keys <name>.convblock.{0,1,2} as in ifrnet's
    Init/Intermediate/MultiFlow decoders (they differ only in channel
    arithmetic and forward wiring, which lives in AMTS below)."""
    m = nn.Module()
    m.convblock = nn.Sequential(
        _convrelu(cat_ch, mid_ch),
        _ResBlock(mid_ch, skip_ch),
        nn.ConvTranspose2d(mid_ch, out_ch, 4, 2, 1),
    )
    return m


class _SmallUpdate(nn.Module):
    """raft.SmallUpdateBlock: correlation-guided residual refinement."""

    def __init__(self, cdim, hidden=76, flow_dim=20, corr_dim=64, fc_dim=68,
                 corr_levels=4, radius=3, scale_factor=None):
        super().__init__()
        cor_planes = corr_levels * (2 * radius + 1) ** 2
        self.scale_factor = scale_factor
        self.convc1 = nn.Conv2d(2 * cor_planes, corr_dim, 1)
        self.convf1 = nn.Conv2d(4, flow_dim * 2, 7, padding=3)
        self.convf2 = nn.Conv2d(flow_dim * 2, flow_dim, 3, padding=1)
        self.conv = nn.Conv2d(corr_dim + flow_dim, fc_dim, 3, padding=1)
        lrelu = lambda: nn.LeakyReLU(negative_slope=0.1)  # noqa: E731
        self.gru = nn.Sequential(
            nn.Conv2d(fc_dim + 4 + cdim, hidden, 3, padding=1), lrelu(),
            nn.Conv2d(hidden, hidden, 3, padding=1))
        self.feat_head = nn.Sequential(
            nn.Conv2d(hidden, hidden, 3, padding=1), lrelu(),
            nn.Conv2d(hidden, cdim, 3, padding=1))
        self.flow_head = nn.Sequential(
            nn.Conv2d(hidden, hidden, 3, padding=1), lrelu(),
            nn.Conv2d(hidden, 4, 3, padding=1))

    def forward(self, net, flow, corr):
        s = self.scale_factor
        if s is not None:
            net = _resize(net, 1 / s)
        act = lambda t: F.leaky_relu(t, 0.1)  # noqa: E731
        cor = act(self.convc1(corr))
        flo = act(self.convf2(act(self.convf1(flow))))
        inp = act(self.conv(torch.cat([cor, flo], 1)))
        out = self.gru(torch.cat([inp, flow, net], 1))
        dnet, dflow = self.feat_head(out), self.flow_head(out)
        if s is not None:
            dnet = _resize(dnet, s)
            dflow = s * _resize(dflow, s)
        return dnet, dflow


class AMTS(nn.Module):
    """AMT-S (networks/AMT-S.py Model), eval path."""

    def __init__(self, corr_radius=3, corr_lvls=4, num_flows=3,
                 channels=(20, 32, 44, 56), skip_channels=20,
                 feat_dim=84):
        super().__init__()
        self.radius, self.corr_levels = corr_radius, corr_lvls
        self.num_flows = num_flows
        c0, c1, c2, c3 = channels
        self.feat_encoder = _SmallEncoder(feat_dim)
        self.encoder = nn.Module()
        prev = 3
        for i, ch in enumerate(channels, 1):
            setattr(self.encoder, f"pyramid{i}",
                    nn.Sequential(_convrelu(prev, ch, 3, 2, 1),
                                  _convrelu(ch, ch)))
            prev = ch
        self.decoder4 = _decoder(c3 * 2 + 1, c3 * 2, c2 + 4, skip_channels)
        self.decoder3 = _decoder(c2 * 3 + 4, c2 * 3, c1 + 4, skip_channels)
        self.decoder2 = _decoder(c1 * 3 + 4, c1 * 3, c0 + 4, skip_channels)
        self.decoder1 = _decoder(c0 * 3 + 4, c0 * 3, 8 * num_flows,
                                 skip_channels)
        upd = lambda cdim, s=None: _SmallUpdate(  # noqa: E731
            cdim, corr_levels=corr_lvls, radius=corr_radius, scale_factor=s)
        self.update4 = upd(c2)
        self.update3 = upd(c1, 2)
        self.update2 = upd(c0, 4)
        self.comb_block = nn.Sequential(
            nn.Conv2d(3 * num_flows, 6 * num_flows, 3, 1, 1),
            nn.PReLU(6 * num_flows),
            nn.Conv2d(6 * num_flows, 3, 3, 1, 1))

    def _pyramids(self, img):
        fs, x = [], img
        for i in range(1, 5):
            x = getattr(self.encoder, f"pyramid{i}")(x)
            fs.append(x)
        return fs

    def _corr_lookup(self, corr_fn, coord, flow0, flow1, embt, down=1):
        t1s, t0s = 1.0 / embt, 1.0 / (1.0 - embt)
        if down != 1:
            inv = 1.0 / down
            flow0 = inv * _resize(flow0, inv)
            flow1 = inv * _resize(flow1, inv)
        c0, c1 = corr_fn(coord + flow1 * t1s, coord + flow0 * t0s)
        return torch.cat([c0, c1], 1), torch.cat([flow0, flow1], 1)

    def _stage(self, update, dec_out, corr_fn, coord, embt, down):
        flow0, flow1, ft = dec_out
        corr, flow = self._corr_lookup(corr_fn, coord, flow0, flow1, embt,
                                       down)
        dft, dflow = update(ft, flow, corr)
        df0, df1 = torch.chunk(dflow, 2, 1)
        return flow0 + df0, flow1 + df1, ft + dft

    def forward(self, img0, img1, embt, scale_factor=1.0):
        mean_ = torch.cat([img0, img1], 2).mean((1, 2, 3), keepdim=True)
        img0, img1 = img0 - mean_, img1 - mean_
        img0_ = _resize(img0, scale_factor) if scale_factor != 1.0 else img0
        img1_ = _resize(img1, scale_factor) if scale_factor != 1.0 else img1
        b, _, h, w = img0_.shape
        coord = _coords_grid(b, h // 8, w // 8, img0.device)

        fmaps = self.feat_encoder(torch.cat([img0_, img1_], 0))
        fmap0, fmap1 = torch.split(fmaps, [b, b], 0)
        corr_fn = bidir_corr_pyramid(fmap0, fmap1, self.corr_levels,
                                     self.radius)
        f0 = self._pyramids(img0_)
        f1 = self._pyramids(img1_)

        # stage 4: init decoder (f0_4, f1_4, embt) -> flows at 1/8
        hh, ww = f0[3].shape[2:]
        out = self.decoder4.convblock(
            torch.cat([f0[3], f1[3], embt.repeat(1, 1, hh, ww)], 1))
        flow0, flow1 = torch.chunk(out[:, :4], 2, 1)
        ft = out[:, 4:]
        flow0, flow1, ft = self._stage(self.update4, (flow0, flow1, ft),
                                       corr_fn, coord, embt, 1)

        # stages 3, 2: intermediate decoders with warped skips
        for dec, upd, fl, down in ((self.decoder3, self.update3, 2, 2),
                                   (self.decoder2, self.update2, 1, 4)):
            w0, w1 = warp(f0[fl], flow0), warp(f1[fl], flow1)
            out = dec.convblock(torch.cat([ft, w0, w1, flow0, flow1], 1))
            nf0, nf1 = torch.chunk(out[:, :4], 2, 1)
            flow0 = nf0 + 2.0 * _resize(flow0, 2.0)
            flow1 = nf1 + 2.0 * _resize(flow1, 2.0)
            ft = out[:, 4:]
            flow0, flow1, ft = self._stage(upd, (flow0, flow1, ft), corr_fn,
                                           coord, embt, down)

        # stage 1: multi-flow decoder -> masks + residue at full res
        n = self.num_flows
        w0, w1 = warp(f0[0], flow0), warp(f1[0], flow1)
        out = self.decoder1.convblock(torch.cat([ft, w0, w1, flow0, flow1],
                                                1))
        dflow0, dflow1, mask, img_res = torch.split(
            out, [2 * n, 2 * n, n, 3 * n], 1)
        mask = torch.sigmoid(mask)
        flow0 = dflow0 + 2.0 * _resize(flow0, 2.0).repeat(1, n, 1, 1)
        flow1 = dflow1 + 2.0 * _resize(flow1, 2.0).repeat(1, n, 1, 1)
        if scale_factor != 1.0:
            inv = 1.0 / scale_factor
            flow0, flow1 = _resize(flow0, inv) * inv, _resize(flow1, inv) * inv
            mask, img_res = _resize(mask, inv), _resize(img_res, inv)

        # merge the flow hypotheses (multi_flow.multi_flow_combine)
        b, _, h, w = flow0.shape
        fl0 = flow0.reshape(-1, 2, h, w)
        fl1 = flow1.reshape(-1, 2, h, w)
        m = mask.reshape(-1, 1, h, w)
        res = img_res.reshape(-1, 3, h, w)
        i0 = torch.stack([img0] * n, 1).reshape(-1, 3, h, w)
        i1 = torch.stack([img1] * n, 1).reshape(-1, 3, h, w)
        mn = torch.stack([mean_] * n, 1).reshape(-1, 1, 1, 1)
        warps = (m * warp(i0, fl0) + (1 - m) * warp(i1, fl1) + mn + res)
        warps = warps.reshape(b, n, 3, h, w)
        pred = warps.mean(1) + self.comb_block(warps.view(b, -1, h, w))
        return torch.clamp(pred, 0, 1)


def load_amt_s(ckpt_path: str, device: str | torch.device = "cuda") -> AMTS:
    """Load the official amt-s.pth (the vendored loader reads
    ckpt['state_dict'] - motion_smoothness.py:88) on the CPU, then copy it to
    `device` once."""
    dev = resolve_device(device)
    model = AMTS()
    ckpt = torch.load(ckpt_path, map_location="cpu", weights_only=False)
    sd = ckpt.get("state_dict", ckpt)
    model.load_state_dict(sd)
    return model.to(dev).eval()


class MotionSmoothnessAMT:
    """VBench motion-smoothness: drop odd frames, re-interpolate from even
    neighbors (embt=0.5), score (255 - mean|diff|)/255."""

    def __init__(self, weights_path: str, device: str | torch.device = "cuda",
                 model: Optional[AMTS] = None):
        self.device = resolve_device(device)
        self.model = model if model is not None else load_amt_s(weights_path, self.device)

    @torch.no_grad()
    def interpolate(self, video: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        """video: [T, H, W, 3] float in [0, 1] or uint8. Returns the odd
        frames that have two even neighbours and AMT-S's interpolation of
        each from them, both uint8 [N, H, W, 3]."""
        v = np.asarray(video)
        if v.dtype != np.uint8:
            v = (np.clip(v, 0, 1) * 255).astype(np.uint8)
        frames: List[np.ndarray] = [v[i] for i in range(v.shape[0])]
        even = frames[0::2]
        if len(even) < 2:
            empty = np.zeros((0, *v.shape[1:]), np.uint8)
            return empty, empty
        tens = [torch.from_numpy(f).to(self.device).permute(2, 0, 1)[None].float() / 255.0
                for f in even]
        h, w = tens[0].shape[-2:]
        pad_h = (-h) % 16
        pad_w = (-w) % 16
        pad = [pad_w // 2, pad_w - pad_w // 2, pad_h // 2, pad_h - pad_h // 2]
        tens = [F.pad(t, pad, mode="replicate") for t in tens]
        embt = torch.full((1, 1, 1, 1), 0.5, device=self.device)
        outs = [tens[0]]
        for a, b in zip(tens[:-1], tens[1:]):
            outs += [self.model(a, b, embt), b]
        hh, ww = outs[0].shape[-2:]
        outs = [o[..., pad[2]:hh - pad[3], pad[0]:ww - pad[1]] for o in outs]
        interp = [(o * 255.0).squeeze(0).permute(1, 2, 0).cpu().numpy()
                  .clip(0, 255).astype(np.uint8) for o in outs[1::2]]
        return np.stack(frames[1::2][:len(interp)]), np.stack(interp)

    def __call__(self, video: np.ndarray) -> float:
        """video: [T, H, W, 3] float in [0, 1] or uint8."""
        return smoothness_score(*self.interpolate(video))


def smoothness_score(actual: np.ndarray, interp: np.ndarray) -> float:
    """(255 - mean |actual - interpolated|) / 255 over uint8 frames, the
    mean taken per frame, then over frames; 1.0 when there is none."""
    if len(interp) == 0:
        return 1.0
    diffs = [np.mean(cv2_absdiff(a, b)) for a, b in zip(actual, interp)]
    return float((255.0 - np.mean(diffs)) / 255.0)


def cv2_absdiff(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """cv2.absdiff on uint8 without the cv2 dependency."""
    return np.abs(a.astype(np.int16) - b.astype(np.int16)).astype(np.uint8)
