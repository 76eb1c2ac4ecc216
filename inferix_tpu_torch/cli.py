"""Command-line entry points of the port: the commands of
`inferix_tpu/cli.py` but `vde` (self-forcing, causvid, stream, magi).

    python -m inferix_tpu_torch.cli self-forcing --model-path DIR --quant int8
    python -m inferix_tpu_torch.cli stream --backend file --segments 3
    python -m inferix_tpu_torch.cli causvid --rollouts 3
    python -m inferix_tpu_torch.cli magi --config examples/configs/magi_4p5b.json \
        --load DIT.pt --vae VAE_DIR --output out.mp4

or the console scripts `inferix-tpu-torch-self-forcing`,
`inferix-tpu-torch-causvid`, `inferix-tpu-torch-stream` and
`inferix-tpu-torch-magi`. Every command runs on the card, and fails when
there is none; `--cpu` runs the plain PyTorch path on the CPU instead.
`--tiny` runs the tiny test config in float32, the full config runs in
bf16. The `vde` command is not ported yet: asked for, it exits with an
error that names its roadmap item. Nothing heavy is imported before a
command runs.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from typing import List, Optional

import numpy as np

# Commands of the JAX CLI that the port does not have yet, and where they
# stand in ROADMAP.md.
NOT_PORTED = {"vde": "ROADMAP.md A14b (eval/ and the vde command)"}


def _common_parser(desc: str) -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=desc)
    p.add_argument("--prompt", type=str, default="a scenic mountain valley")
    p.add_argument("--config", type=str, default=None,
                   help="EngineConfig JSON path")
    p.add_argument("--model-path", type=str, default=None,
                   help="checkpoint dir or .pt file (random init if absent)")
    p.add_argument("--output", type=str, default="output.mp4")
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--frames", type=int, default=None,
                   help="latent frames to generate (default 21; 4 with "
                   "--tiny, whose attention window holds 6 frames)")
    p.add_argument("--quant", choices=["none", "int8", "fp8"], default="none")
    p.add_argument("--quant-kv", action="store_true",
                   help="quantize the KV cache to int8")
    p.add_argument("--decode-mode",
                   choices=["after_all", "per_block", "no_decode"],
                   default="after_all")
    p.add_argument("--context-mode", choices=["rerun", "last_step"],
                   default=None,
                   help="'last_step' skips the clean-context re-run "
                        "(4 forwards/block instead of 5; slightly noisier "
                        "context KV)")
    p.add_argument("--profile", action="store_true")
    p.add_argument("--tiny", action="store_true",
                   help="tiny test config (no real weights; smoke runs)")
    p.add_argument("--cpu", action="store_true",
                   help="run on the CPU (device='cpu'); the default is the "
                        "card, and a run without one fails")
    return p


def _device(args) -> str:
    return "cpu" if args.cpu else "cuda"


def _dtype(args):
    import torch

    return torch.float32 if args.tiny else torch.bfloat16


def _build_config(args):
    from .core.config import EngineConfig, tiny_test_config
    from .core.types import DecodeMode

    if args.config:
        cfg = EngineConfig.from_json(args.config)
    elif args.tiny:
        cfg = tiny_test_config()
    else:
        cfg = EngineConfig()
    if getattr(args, "frames", None) is None:
        args.frames = 4 if args.tiny else 21
    if args.model_path:
        cfg.model_path = args.model_path
    cfg.runtime.seed = args.seed
    cfg.runtime.decode_mode = DecodeMode(args.decode_mode)
    if args.quant != "none":
        cfg.quant.enabled = True
        cfg.quant.dtype = args.quant
        cfg.quant.quantize_kv_cache = args.quant_kv
    if getattr(args, "context_mode", None):
        cfg.runtime.context_mode = args.context_mode
    return cfg


def _to_numpy(video) -> np.ndarray:
    return video.detach().float().cpu().numpy()


def _save(video, path: str) -> None:
    from .core.media.streaming_backend import latents_to_uint8
    from .core.media.video_utils import save_video

    if video is None:
        print("NO_DECODE: latents only, nothing saved")
        return
    out = save_video(latents_to_uint8(_to_numpy(video)), path)
    print(f"saved {out}")


def main_self_forcing(argv: Optional[List[str]] = None) -> int:
    args = _common_parser("Self-Forcing semi-AR text-to-video").parse_args(argv)
    import torch

    from .core.types import StreamingMode
    from .pipeline.self_forcing import SelfForcingPipeline
    from .profiling.profiler import InferixProfiler, ProfilingConfig

    cfg = _build_config(args)
    profiler = InferixProfiler(ProfilingConfig(enabled=args.profile))
    pipe = SelfForcingPipeline(cfg, profiler=profiler, dtype=_dtype(args),
                               device=_device(args))
    t0 = time.perf_counter()
    if cfg.runtime.decode_mode.value == "per_block":
        # per-block decode happens in the streaming callback (TRUE_STREAMING
        # path); collect the pixel blocks and save their concatenation
        cfg.runtime.streaming_mode = StreamingMode.TRUE_STREAMING
        pixels = []
        pipe.run_streaming_generation([args.prompt], num_segments=1,
                                      stream_callback=pixels.append)
        video = torch.cat(pixels, dim=1) if pixels else None
    else:
        video = pipe.run_text_to_video([args.prompt], num_frames=args.frames)
    print(f"generated in {time.perf_counter() - t0:.1f}s")
    if args.profile:
        print(json.dumps(pipe.profiler.summary(), indent=2, default=str))
        pipe.profiler.save_report()
    if cfg.runtime.decode_mode.value != "no_decode":
        _save(video, args.output)
    return 0


def main_causvid(argv: Optional[List[str]] = None) -> int:
    p = _common_parser("CausVid multi-segment rollout")
    p.add_argument("--rollouts", type=int, default=3)
    p.add_argument("--overlap-frames", type=int, default=3)
    args = p.parse_args(argv)
    import torch

    from .pipeline.causvid import CausVidPipeline

    cfg = _build_config(args)
    pipe = CausVidPipeline(cfg, dtype=_dtype(args), device=_device(args))
    videos = pipe.run_rollouts(args.prompt, num_rollouts=args.rollouts,
                               num_overlap_frames=args.overlap_frames)
    _save(torch.cat(videos, dim=1), args.output)
    return 0


def main_magi(argv: Optional[List[str]] = None) -> int:
    p = _common_parser("MAGI-1 chunked generation")
    p.add_argument("--chunks", type=int, default=4)
    p.add_argument("--num-steps", type=int, default=None,
                   help="default: the config's value, else 8")
    p.add_argument("--window-size", type=int, default=4)
    # the common --config is the MAGI json here (examples/configs/magi_*)
    p.add_argument("--load", help="DiT checkpoint: sharded-safetensors dir "
                   "or .pt (reference MAGI layout)")
    p.add_argument("--vae", help="MAGI ViT-VAE checkpoint dir "
                   "(config.json + weights); enables pixel decode")
    p.add_argument("--t5", help="t5-v1_1-xxl dir (HF layout); encodes "
                   "--prompt instead of the zero caption")
    p.add_argument("--int8", action="store_true",
                   help="requantize a distill-quant (fp8) checkpoint to "
                   "W8A8 int8 at load")
    p.add_argument("--image", help="I2V: condition on this image")
    p.add_argument("--video", help="V2V: condition on this video's tail")
    p.add_argument("--aspect-policy", default="fit",
                   choices=("fit", "crop", "pad"))
    p.add_argument("--fps", type=int, default=16)
    args = p.parse_args(argv)
    import os

    import torch

    from .models.magi.dit import MagiModelConfig, tiny_magi_config
    from .pipeline.magi import MagiPipeline, MagiRuntimeConfig, magi_config_from_json

    dev, dtype = _device(args), _dtype(args)
    if args.config:
        mcfg, rt = magi_config_from_json(args.config)
        if args.num_steps is not None:
            rt.num_steps = args.num_steps
        rt.seed = args.seed
    else:
        mcfg = tiny_magi_config() if args.tiny else MagiModelConfig()
        rt = MagiRuntimeConfig(num_steps=args.num_steps or 8,
                               window_size=args.window_size, seed=args.seed,
                               chunk_width=2 if args.tiny else 6)

    params = None
    if args.load:
        from .utils.checkpoint import (convert_magi_state_dict, load_sharded_safetensors,
                                       load_torch_state_dict)

        sd = (load_sharded_safetensors(args.load) if os.path.isdir(args.load)
              else load_torch_state_dict(args.load))
        params = convert_magi_state_dict(sd, mcfg, dtype, dev)
        del sd
        if args.int8:
            from .quant.api import magi_distill_quant_to_int8

            params = magi_distill_quant_to_int8(params)

    lat = 8 if args.tiny else 90
    pipe = MagiPipeline(mcfg, rt, params=params, latent_h=lat, latent_w=lat,
                        max_chunks=args.chunks + 2, dtype=dtype, device=dev)

    vae = None
    if args.vae:
        from .utils.checkpoint import load_magi_vae

        vae = load_magi_vae(args.vae, device=dev)
    prefix = None
    if args.image or args.video:
        # I2V / V2V prefix conditioning (reference run_magi.py modes 2 / 3)
        from .pipeline.magi_media import (encode_prefix_latents, load_media, process_image,
                                          process_prefix_video)

        if vae is None:
            import dataclasses

            from .models.magi.vae import ViTVAE, ViTVAEConfig, tiny_vitvae_config

            vcfg = tiny_vitvae_config() if args.tiny else ViTVAEConfig()
            # the VAE's latent channels must match the DiT's latents
            vae = ViTVAE(dataclasses.replace(vcfg, z_chans=mcfg.latent_channels), device=dev)
        h = w = lat * vae.cfg.patch_size
        if args.image:
            frames = process_image(load_media(args.image)[0], h, w, args.aspect_policy)
        else:
            frames = process_prefix_video(load_media(args.video), args.fps, h, w,
                                          aspect_policy=args.aspect_policy)
        prefix = encode_prefix_latents(vae, frames, chunk_width=rt.chunk_width).to(dtype)

    if args.t5 and args.prompt:
        import glob

        from transformers import AutoTokenizer

        from .models.text.umt5 import (MagiT5Embedder, convert_t5_encoder_state_dict,
                                       t5_v1_1_xxl_config)
        from .pipeline.magi import magi_text_embeddings
        from .utils.checkpoint import load_sharded_safetensors, load_torch_state_dict

        # a tokenizer-only dir (no weight files) takes a random tower, with
        # a note; a dir with weight files must load them or fail
        t5_params = None
        bins = sorted(glob.glob(os.path.join(args.t5, "*.bin")))
        sts = glob.glob(os.path.join(args.t5, "*.safetensors"))
        if not bins and not sts:
            print(f"[t5] no weight files in {args.t5}; using random tower")
        else:
            sd = {}
            for b in bins:
                sd.update(load_torch_state_dict(b))
            if sts:
                sd.update(load_sharded_safetensors(args.t5))
            t5_params = convert_t5_encoder_state_dict(sd, t5_v1_1_xxl_config(), device=dev)
        emb = MagiT5Embedder(params=t5_params, device=dev,
                             tokenizer=AutoTokenizer.from_pretrained(args.t5))
        cap, cmask = magi_text_embeddings(args.prompt, embedder=emb)
        del emb
        cap = cap.float()
        # pad the 120-token embedding to the model's caption_max_length
        pad = mcfg.caption_max_length - cap.shape[1]
        if pad > 0:
            cap = torch.nn.functional.pad(cap, (0, 0, 0, pad))
            cmask = torch.nn.functional.pad(cmask, (0, pad))
    else:
        cap = torch.zeros(1, mcfg.caption_max_length, mcfg.caption_channels, device=dev)
        cmask = torch.ones(1, mcfg.caption_max_length, dtype=torch.int32, device=dev)

    if args.output and vae is None:
        print("note: --output needs --vae to decode; generating latents only")
    pixels = []
    for idx, chunk in pipe.generate_chunks(cap, cmask, chunk_num=args.chunks,
                                           prefix_latents=prefix):
        print(f"chunk {idx}: {tuple(chunk.shape)} "
              f"finite={bool(torch.isfinite(chunk).all())}")
        if vae is not None and args.output:
            pixels.append(vae.decode(chunk))
    if pixels and args.output:
        # decode gives [-1, 1]; _save takes [0, 1]
        _save(torch.cat(pixels, dim=1)[0] * 0.5 + 0.5, args.output)
    return 0


def main_stream(argv: Optional[List[str]] = None) -> int:
    p = _common_parser("Progressive / interactive streaming")
    p.add_argument("--segments", type=int, default=3)
    p.add_argument("--backend",
                   choices=["memory", "file", "gradio", "rtmp", "webrtc"],
                   default="file")
    p.add_argument("--interactive", action="store_true")
    p.add_argument("--port", type=int, default=8000)
    args = p.parse_args(argv)

    from .core.interactive import InteractiveSession
    from .core.media.streaming_backend import (create_streaming_backend,
                                               latents_to_uint8)
    from .core.types import StreamingMode
    from .pipeline.self_forcing import SelfForcingPipeline

    cfg = _build_config(args)
    cfg.runtime.streaming_mode = StreamingMode.TRUE_STREAMING
    pipe = SelfForcingPipeline(cfg, dtype=_dtype(args), device=_device(args))

    kwargs = {"path": args.output} if args.backend == "file" else \
        {"port": args.port} if args.backend in ("gradio", "webrtc") else {}
    backend = create_streaming_backend(args.backend, **kwargs)
    with backend:
        def cb(px):
            backend.stream_batch(latents_to_uint8(_to_numpy(px)))

        if args.interactive:
            session = InteractiveSession()
            pipe.run_interactive_generation(session, args.prompt,
                                            num_segments=args.segments,
                                            stream_callback=cb)
        else:
            pipe.run_streaming_generation([args.prompt],
                                          num_segments=args.segments,
                                          stream_callback=cb)
    frames = getattr(backend, "frames_streamed", None)
    print(f"streamed {frames} frames via {args.backend}")
    return 0


COMMANDS = {"self-forcing": main_self_forcing, "causvid": main_causvid,
            "stream": main_stream, "magi": main_magi}


def main(argv: Optional[List[str]] = None) -> int:
    """`python -m inferix_tpu_torch.cli <command> [flags]`; the command
    defaults to self-forcing."""
    argv = sys.argv[1:] if argv is None else list(argv)
    cmd = argv[0] if argv else "self-forcing"
    if cmd in NOT_PORTED:
        raise SystemExit(f"inferix_tpu_torch.cli: the {cmd!r} command is not ported "
                         f"yet; see {NOT_PORTED[cmd]}")
    if cmd not in COMMANDS:
        raise SystemExit(f"inferix_tpu_torch.cli: unknown command {cmd!r}; the port "
                         f"has {', '.join(COMMANDS)} (vde: {NOT_PORTED['vde']})")
    return COMMANDS[cmd](argv[1:])


if __name__ == "__main__":
    sys.exit(main())
