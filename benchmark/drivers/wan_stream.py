"""Live Self-Forcing Wan streams: clips generated block by block, each block
decoded as it lands, a new clip admitted when the last one ends (a closed
loop of `traffic["streams"]` = 1 stream).

The timed path is the port's: `SemiARGenerator.generate` (4 denoise
forwards and the clean-context rerun a block, over the global KV cache)
with `CausalVAE.decode_chunk` on each block in the block callback, as
`SelfForcingPipeline` streams in TRUE_STREAMING. A block is delivered when
its pixels are on the card: a CUDA event recorded after its decode. Its gap
is the time since the stream's previous delivery (the closed loop admits a
clip when the last one is delivered; the window's first clip at the
window's start). The host dispatches ahead and reads the events late: it
waits only for the delivery `LEAD_BLOCKS` blocks back, so that the card
stays fed while the host stands still, and at the window's end it sends
nothing more, waits for all it sent, and reads the clock after that wait.

Inputs from the seed: the weights (`benchmark/weights.py`), and a clip's
text features [1, 512, 4096], its noise and the renoise of each denoise
step, from a generator seeded by (seed, clip), handed to the program and,
in the check, to the reference.

The check (after the window, the program's state freed): one completed clip
drawn from the seed, its first and last block and one drawn between them.
The float32 reference (`reference/wan_dit.py`) writes its own cache by
rerunning the program's delivered latents of the blocks before each, then
denoises the sampled blocks from the same noise and renoise; the VAE
reference (`reference/wan_vae.py`) decodes the program's latents of the
clip's blocks in order. Compared: the largest relative L2 distance of a
sampled block's latents (x0_rel) and pixels (pixels_rel).
"""
from __future__ import annotations

import math
import random
import sys
import time
from typing import Dict, List, Optional, Tuple

import torch

from benchmark import harness, weights
from benchmark.counts import wan as wan_counts
from benchmark.reference.wan_dit import Schedule, WanReference, strict_fp32
from benchmark.reference.wan_vae import WanVAEDecoderReference

# deliveries the host may run ahead of the card: it waits for the one this
# many blocks back (~1.6 s of work), never for the block it just sent
LEAD_BLOCKS = 2


def rel(a: torch.Tensor, b: torch.Tensor) -> float:
    a, b = a.float(), b.float()
    return float((a - b).norm() / b.norm())


class Cell:
    def __init__(self, ctx: harness.Context):
        self.ctx = ctx
        self.dev = ctx.device
        self.conf = ctx.cell.config
        self.traffic = ctx.cell.traffic
        if self.traffic["streams"] != 1:
            raise ValueError("this driver runs one stream")
        eng = self.conf["engine"]
        self.m, self.r = eng["model"], eng["runtime"]
        self.fpb = self.m["num_frame_per_block"]
        self.frames = self.traffic["clip_latent_frames"]
        self.blocks = self.frames // self.fpb
        self.lat = (self.r["latent_height"], self.r["latent_width"], self.r["latent_channels"])
        self.outputs: Dict[Tuple[int, int], Tuple[torch.Tensor, torch.Tensor]] = {}
        self.completed: List[int] = []

    # -- inputs -------------------------------------------------------------

    def sync(self):
        if self.dev.type == "cuda":
            torch.cuda.synchronize(self.dev)

    def weights(self):
        g = torch.Generator(device=self.dev).manual_seed(
            harness.derive_seed(self.ctx.seed, "weights"))
        dit = weights.materialize(
            weights.wan_dit_spec(self.m, self.conf["init"]["modulation_std"]), g, self.dev)
        vae = weights.materialize(weights.wan_vae_decoder_spec(self.conf["vae"]), g, self.dev)
        return dit, vae

    def clip_inputs(self, key, frames: int):
        """(text [1, L, text_dim], noise [1, frames, h, w, c], renoise: per
        block the steps' noises [1, fpb, h, w, c]), bf16, one draw."""
        steps = len(self.r["denoising_step_list"])
        h, w, c = self.lat
        text = (1, self.m["text_len"], self.m["text_dim"])
        blk = (1, self.fpb, h, w, c)
        n_blocks = frames // self.fpb
        sizes = [math.prod(text), frames * h * w * c] + [math.prod(blk)] * (n_blocks * (steps - 1))
        g = torch.Generator(device=self.dev).manual_seed(harness.derive_seed(self.ctx.seed, *key))
        flat = torch.randn(sum(sizes), generator=g, device=self.dev).to(torch.bfloat16)
        parts = list(torch.split(flat, sizes))
        noise = parts[1].view(1, frames, h, w, c)
        ren = [p.view(blk) for p in parts[2:]]
        renoise = [ren[b * (steps - 1):(b + 1) * (steps - 1)] for b in range(n_blocks)]
        return parts[0].view(text), noise, renoise

    # -- set-up -------------------------------------------------------------

    def setup(self):
        from inferix_tpu_torch.core.config import EngineConfig
        from inferix_tpu_torch.models.wan.vae import CausalVAE, VAEConfig
        from inferix_tpu_torch.pipeline.semi_ar import SemiARGenerator
        from inferix_tpu_torch.quant.api import quantize_params

        cfg = EngineConfig.from_dict(self.conf["engine"])
        v = self.conf["vae"]
        dit, vae = self.weights()
        # as SelfForcingPipeline sets up: the tree quantized where the
        # configuration's quant section asks for it
        self.gen = SemiARGenerator(cfg, quantize_params(dit, cfg.quant), dtype=torch.bfloat16,
                                   device=self.dev)
        vcfg = VAEConfig(dim=v["dim"], z_dim=v["z_dim"], dim_mult=tuple(v["dim_mult"]),
                         num_res_blocks=v["num_res_blocks"],
                         temperal_downsample=tuple(v["temperal_downsample"]))
        self.vae = CausalVAE(vcfg, params=vae, dtype=torch.bfloat16, device=self.dev,
                             conv_impl=v["conv_impl"])
        del dit, vae
        # the work of each block of a clip, by the span it runs in
        q = self.fpb * self.gen.frame_seq
        fwd = len(self.r["denoising_step_list"])
        self.block_work = []
        for b in range(self.blocks):
            keys = (b + 1) * q
            work = [("dit", w) for w in (wan_counts.text_work(self.m) if b == 0 else [])]
            for _ in range(fwd):
                work += [("dit", w) for w in wan_counts.forward_work(self.m, q, keys, self.fpb)]
            if self.r.get("context_mode", "rerun") == "rerun":
                work += [("dit", w) for w in wan_counts.forward_work(self.m, q, keys, self.fpb,
                                                                     need_output=False)]
            work += [("decode", w) for w in wan_counts.vae_decode_work(
                v, self.fpb, self.lat[0], self.lat[1], first=b == 0)]
            self.block_work.append(work)
        # warm-up: a two-block clip, each block decoded (the first and a
        # later decode shape), through the window's own calls
        self.run_clip(("warmup",), 2 * self.fpb)
        self.sync()

    # -- the window ---------------------------------------------------------

    def run_clip(self, key, frames: int, clip: Optional[int] = None):
        """One clip through the program, each block decoded as it lands;
        in the window (clip given) each delivery is marked, not waited for."""
        text, noise, renoise = self.clip_inputs(key, frames)
        state = {"vcache": None}
        xattn = self.gen.encode_text_context(text)

        def on_block(x0, bi):
            dit_end = self.marks.mark() if clip is not None else None
            px, state["vcache"] = self.vae.decode_chunk(x0, state["vcache"], first=bi == 0)
            px = torch.clamp(px, -1, 1) * 0.5 + 0.5
            if clip is None:
                return
            self.deliveries.append((px.shape[1], dit_end, self.marks.mark(),
                                    self.block_work[bi]))
            self.outputs[(clip, bi)] = (x0, px)
            if len(self.deliveries) > LEAD_BLOCKS:
                self.marks.wait(self.deliveries[-1 - LEAD_BLOCKS][2])

        self.gen.generate(noise, xattn, renoise=renoise, block_callback=on_block)

    def window(self, seconds: float, rec: harness.Record):
        self.marks = harness.Marks(self.dev)
        self.deliveries = []
        rec.start()
        self.marks.start(rec.t0)
        clip = 0
        while clip == 0 or time.perf_counter() - rec.t0 < seconds:
            self.run_clip(("clip", clip), self.frames, clip)
            self.completed.append(clip)
            clip += 1
        self.sync()
        rec.stop()
        last = rec.t0
        for frames, dit_end, out, work in self.deliveries:
            t_dit, t_out = self.marks.time(dit_end), self.marks.time(out)
            rec.add(harness.Step(frames, {"dit": (last, t_dit), "decode": (t_dit, t_out)},
                                 work, gap=t_out - last))
            last = t_out

    def release(self):
        del self.gen, self.vae
        if self.dev.type == "cuda":
            torch.cuda.empty_cache()

    # -- the check ----------------------------------------------------------

    def reference_block(self, ref, sched, steps, text_kv, noise, renoise, b):
        """The reference's denoise of block b from the clip's noise and
        renoise."""
        x = noise[0, b * self.fpb:(b + 1) * self.fpb].float()
        for i, t in enumerate(steps):
            flow = ref.forward(x, t, text_kv, b * self.fpb)
            x0 = x - sched.sigma(t) * flow
            if i == len(steps) - 1:
                return x0
            s = sched.sigma(steps[i + 1])
            x = (1.0 - s) * x0 + s * renoise[b][i][0].float()

    def check(self) -> List[harness.Check]:
        limits = self.ctx.cell.workload["check"]["limits"]
        rng = random.Random(harness.derive_seed(self.ctx.seed, "sample"))
        clip = rng.choice(self.completed)
        last = self.blocks - 1
        sample = sorted({0, rng.randint(1, max(1, last - 1)), last})
        keep = {k: v for k, v in self.outputs.items() if k[0] == clip}
        self.outputs = keep
        x0s = [keep[(clip, b)][0][0] for b in range(last + 1)]
        strict_fp32()
        dit, vae = self.weights()
        del vae
        text, noise, renoise = self.clip_inputs(("clip", clip), self.frames)
        _, ph, pw = self.m["patch_size"]
        frame_seq = (self.lat[0] // ph) * (self.lat[1] // pw)
        ref = WanReference(self.m, dit, self.dev, self.fpb, self.lat[:2],
                           max_tokens=self.m["max_attention_frames"] * frame_seq)
        del dit
        sched = Schedule(self.r["timestep_shift"])
        steps = (sched.warp(self.r["denoising_step_list"]) if self.r["warp_denoising_step"]
                 else [float(s) for s in self.r["denoising_step_list"]])
        text_kv = ref.text(text[0])
        x0_rel = {}
        with torch.no_grad():
            for b in range(last + 1):
                if b in sample:
                    x0 = self.reference_block(ref, sched, steps, text_kv, noise, renoise, b)
                    x0_rel[b] = rel(x0s[b], x0)
                if b < last:
                    ref.forward(x0s[b].float(), float(self.r["context_noise"]), text_kv,
                                b * self.fpb, need_output=False)
            del ref, text_kv
            if self.dev.type == "cuda":
                torch.cuda.empty_cache()
            _, vae = self.weights()
            vref = WanVAEDecoderReference(vae, self.dev)
            del vae
            px_rel = {}
            for b in range(last + 1):
                px = torch.clamp(vref.decode(x0s[b].float()), -1, 1)
                if b in sample:
                    px_rel[b] = rel(keep[(clip, b)][1][0].float() * 2 - 1, px)
        for name, vals in (("x0_rel", x0_rel), ("pixels_rel", px_rel)):
            print(f"{name} by block of clip {clip}: " +
                  ", ".join(f"{b}: {v:.6g}" for b, v in vals.items()), file=sys.stderr)
        return [harness.Check("x0_rel", max(x0_rel.values()), limits["x0_rel"]),
                harness.Check("pixels_rel", max(px_rel.values()), limits["pixels_rel"])]
