"""RAFT optical flow (Teed & Deng, ECCV 2020) for VBench dynamic degree: the
port's copy of `inferix_tpu/eval/raft.py`.

The official module naming (fnet / cnet / update_block, encoder conv1 /
layer1-3 / conv2, BasicMotionEncoder convc1..conv, SepConvGRU
convz1..convq2, FlowHead conv1 / conv2, the mask head), so the published
`raft-things.pth` loads directly after the DataParallel `module.` prefixes
are stripped. The all-pairs correlation pyramid, the iterative SepConvGRU
updates and the convex-mask 8x upsampling are plain PyTorch: cuDNN
convolutions and one batched matmul for the correlation volume on the card.
`load_raft` runs the model on the card by default, and raises without one.
"""
from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..core.device import resolve_device


class ResidualBlock(nn.Module):
    def __init__(self, in_planes, planes, norm_fn="instance", stride=1):
        super().__init__()
        self.conv1 = nn.Conv2d(in_planes, planes, 3, padding=1,
                               stride=stride)
        self.conv2 = nn.Conv2d(planes, planes, 3, padding=1)
        self.relu = nn.ReLU(inplace=True)

        def norm():
            if norm_fn == "batch":
                return nn.BatchNorm2d(planes)
            if norm_fn == "instance":
                return nn.InstanceNorm2d(planes)
            return nn.Sequential()

        self.norm1 = norm()
        self.norm2 = norm()
        if stride == 1:
            self.downsample = None
        else:
            self.norm3 = norm()
            self.downsample = nn.Sequential(
                nn.Conv2d(in_planes, planes, 1, stride=stride), self.norm3)

    def forward(self, x):
        y = self.relu(self.norm1(self.conv1(x)))
        y = self.relu(self.norm2(self.conv2(y)))
        if self.downsample is not None:
            x = self.downsample(x)
        return self.relu(x + y)


class BasicEncoder(nn.Module):
    """1/8-resolution feature tower: 7x7 stem + three 2-block stages."""

    def __init__(self, output_dim=256, norm_fn="instance"):
        super().__init__()
        if norm_fn == "batch":
            self.norm1 = nn.BatchNorm2d(64)
        elif norm_fn == "instance":
            self.norm1 = nn.InstanceNorm2d(64)
        else:
            self.norm1 = nn.Sequential()
        self.conv1 = nn.Conv2d(3, 64, 7, stride=2, padding=3)
        self.relu1 = nn.ReLU(inplace=True)

        def stage(inp, planes, stride):
            return nn.Sequential(
                ResidualBlock(inp, planes, norm_fn, stride=stride),
                ResidualBlock(planes, planes, norm_fn, stride=1))

        self.layer1 = stage(64, 64, 1)
        self.layer2 = stage(64, 96, 2)
        self.layer3 = stage(96, 128, 2)
        self.conv2 = nn.Conv2d(128, output_dim, 1)

    def forward(self, x):
        if isinstance(x, (tuple, list)):
            x = torch.cat(x, dim=0)
        x = self.relu1(self.norm1(self.conv1(x)))
        x = self.layer3(self.layer2(self.layer1(x)))
        return self.conv2(x)


class BasicMotionEncoder(nn.Module):
    def __init__(self, corr_levels=4, corr_radius=4):
        super().__init__()
        cor_planes = corr_levels * (2 * corr_radius + 1) ** 2
        self.convc1 = nn.Conv2d(cor_planes, 256, 1)
        self.convc2 = nn.Conv2d(256, 192, 3, padding=1)
        self.convf1 = nn.Conv2d(2, 128, 7, padding=3)
        self.convf2 = nn.Conv2d(128, 64, 3, padding=1)
        self.conv = nn.Conv2d(192 + 64, 128 - 2, 3, padding=1)

    def forward(self, flow, corr):
        c = F.relu(self.convc2(F.relu(self.convc1(corr))))
        f = F.relu(self.convf2(F.relu(self.convf1(flow))))
        out = F.relu(self.conv(torch.cat([c, f], dim=1)))
        return torch.cat([out, flow], dim=1)


class SepConvGRU(nn.Module):
    def __init__(self, hidden_dim=128, input_dim=256):
        super().__init__()
        hi = hidden_dim + input_dim
        self.convz1 = nn.Conv2d(hi, hidden_dim, (1, 5), padding=(0, 2))
        self.convr1 = nn.Conv2d(hi, hidden_dim, (1, 5), padding=(0, 2))
        self.convq1 = nn.Conv2d(hi, hidden_dim, (1, 5), padding=(0, 2))
        self.convz2 = nn.Conv2d(hi, hidden_dim, (5, 1), padding=(2, 0))
        self.convr2 = nn.Conv2d(hi, hidden_dim, (5, 1), padding=(2, 0))
        self.convq2 = nn.Conv2d(hi, hidden_dim, (5, 1), padding=(2, 0))

    def _step(self, h, x, convz, convr, convq):
        hx = torch.cat([h, x], dim=1)
        z = torch.sigmoid(convz(hx))
        r = torch.sigmoid(convr(hx))
        q = torch.tanh(convq(torch.cat([r * h, x], dim=1)))
        return (1 - z) * h + z * q

    def forward(self, h, x):
        h = self._step(h, x, self.convz1, self.convr1, self.convq1)
        h = self._step(h, x, self.convz2, self.convr2, self.convq2)
        return h


class FlowHead(nn.Module):
    def __init__(self, input_dim=128, hidden_dim=256):
        super().__init__()
        self.conv1 = nn.Conv2d(input_dim, hidden_dim, 3, padding=1)
        self.conv2 = nn.Conv2d(hidden_dim, 2, 3, padding=1)
        self.relu = nn.ReLU(inplace=True)

    def forward(self, x):
        return self.conv2(self.relu(self.conv1(x)))


class BasicUpdateBlock(nn.Module):
    def __init__(self, hidden_dim=128):
        super().__init__()
        self.encoder = BasicMotionEncoder()
        self.gru = SepConvGRU(hidden_dim=hidden_dim,
                              input_dim=128 + hidden_dim)
        self.flow_head = FlowHead(hidden_dim, hidden_dim=256)
        self.mask = nn.Sequential(
            nn.Conv2d(128, 256, 3, padding=1),
            nn.ReLU(inplace=True),
            nn.Conv2d(256, 64 * 9, 1, padding=0))

    def forward(self, net, inp, corr, flow):
        motion = self.encoder(flow, corr)
        inp = torch.cat([inp, motion], dim=1)
        net = self.gru(net, inp)
        delta_flow = self.flow_head(net)
        up_mask = 0.25 * self.mask(net)
        return net, up_mask, delta_flow


class CorrBlock:
    """All-pairs correlation pyramid with bilinear window lookup."""

    def __init__(self, fmap1, fmap2, num_levels=4, radius=4):
        self.num_levels = num_levels
        self.radius = radius
        b, d, h, w = fmap1.shape
        corr = torch.einsum(
            "bdij,bdkl->bijkl", fmap1, fmap2).reshape(b * h * w, 1, h, w)
        corr = corr / (d ** 0.5)
        self.pyramid = [corr]
        for _ in range(num_levels - 1):
            corr = F.avg_pool2d(corr, 2, stride=2)
            self.pyramid.append(corr)
        self.shape = (b, h, w)

    def __call__(self, coords):
        b, h, w = self.shape
        r = self.radius
        coords = coords.permute(0, 2, 3, 1)  # [B, H, W, 2]
        out = []
        for i, corr in enumerate(self.pyramid):
            dx = torch.linspace(-r, r, 2 * r + 1, device=coords.device)
            dy = torch.linspace(-r, r, 2 * r + 1, device=coords.device)
            delta = torch.stack(torch.meshgrid(dy, dx, indexing="ij"),
                                dim=-1)
            centroid = coords.reshape(b * h * w, 1, 1, 2) / 2 ** i
            grid = centroid + delta.reshape(1, 2 * r + 1, 2 * r + 1, 2)
            # normalize to [-1, 1] (align_corners=True)
            gh, gw = corr.shape[-2:]
            gx = 2 * grid[..., 0] / max(gw - 1, 1) - 1
            gy = 2 * grid[..., 1] / max(gh - 1, 1) - 1
            g = torch.stack([gx, gy], dim=-1)
            sampled = F.grid_sample(corr, g, align_corners=True)
            out.append(sampled.reshape(b, h, w, -1))
        return torch.cat(out, dim=-1).permute(0, 3, 1, 2).contiguous()


def _coords_grid(b, h, w, device):
    ys, xs = torch.meshgrid(torch.arange(h, device=device),
                            torch.arange(w, device=device), indexing="ij")
    return torch.stack([xs, ys], dim=0).float()[None].repeat(b, 1, 1, 1)


def _upsample_flow(flow, mask):
    """Convex-combination 8x upsampling."""
    b, _, h, w = flow.shape
    mask = mask.view(b, 1, 9, 8, 8, h, w)
    mask = torch.softmax(mask, dim=2)
    up = F.unfold(8 * flow, (3, 3), padding=1)
    up = up.view(b, 2, 9, 1, 1, h, w)
    up = torch.sum(mask * up, dim=2)
    up = up.permute(0, 1, 4, 2, 5, 3)
    return up.reshape(b, 2, 8 * h, 8 * w)


class RAFT(nn.Module):
    """Basic (non-small) RAFT. forward(img1, img2) with images in [0, 255]
    returns the 1/8-res flow and the upsampled flow (test mode)."""

    def __init__(self):
        super().__init__()
        self.hidden_dim = 128
        self.context_dim = 128
        self.fnet = BasicEncoder(output_dim=256, norm_fn="instance")
        self.cnet = BasicEncoder(output_dim=256, norm_fn="batch")
        self.update_block = BasicUpdateBlock(hidden_dim=128)

    @torch.no_grad()
    def forward(self, image1, image2, iters=20, test_mode=True):
        image1 = 2 * (image1 / 255.0) - 1.0
        image2 = 2 * (image2 / 255.0) - 1.0
        fmaps = self.fnet([image1, image2])
        fmap1, fmap2 = torch.chunk(fmaps, 2, dim=0)
        corr_fn = CorrBlock(fmap1.float(), fmap2.float())

        cnet = self.cnet(image1)
        net, inp = torch.split(cnet, [self.hidden_dim, self.context_dim],
                               dim=1)
        net, inp = torch.tanh(net), torch.relu(inp)

        b, _, h8, w8 = fmap1.shape
        coords0 = _coords_grid(b, h8, w8, image1.device)
        coords1 = coords0.clone()
        flow_up = None
        for _ in range(iters):
            corr = corr_fn(coords1)
            flow = coords1 - coords0
            net, up_mask, delta = self.update_block(net, inp, corr, flow)
            coords1 = coords1 + delta
            flow_up = _upsample_flow(coords1 - coords0, up_mask)
        return coords1 - coords0, flow_up


def load_raft(weights_path: str, device: str | torch.device = "cuda") -> RAFT:
    """Load `raft-things.pth` (official release; DataParallel `module.`
    prefixes stripped like the reference does, dynamic_degree.py:34-39) on
    the CPU, weights only, then copy it to `device` once."""
    dev = resolve_device(device)
    model = RAFT()
    ckpt = torch.load(weights_path, map_location="cpu", weights_only=True)
    ckpt = {k.replace("module.", ""): v for k, v in ckpt.items()}
    model.load_state_dict(ckpt)
    return model.to(dev).eval()


def pad_to_multiple_of_8(x: torch.Tensor) -> torch.Tensor:
    """InputPadder semantics (replicate-pad H and W to multiples of 8)."""
    h, w = x.shape[-2:]
    ph, pw = (-h) % 8, (-w) % 8
    return F.pad(x, [pw // 2, pw - pw // 2, ph // 2, ph - ph // 2],
                 mode="replicate")
