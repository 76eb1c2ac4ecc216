"""Command-line entry points of the port: the Wan commands of
`inferix_tpu/cli.py` (self-forcing, causvid, stream).

    python -m inferix_tpu_torch.cli self-forcing --model-path DIR --quant int8
    python -m inferix_tpu_torch.cli stream --backend file --segments 3
    python -m inferix_tpu_torch.cli causvid --rollouts 3

or the console scripts `inferix-tpu-torch-self-forcing`,
`inferix-tpu-torch-causvid` and `inferix-tpu-torch-stream`. Every command
runs on the card, and fails when there is none; `--cpu` runs the plain
PyTorch path on the CPU instead. `--tiny` runs the tiny test config in
float32, the full config runs in bf16. The `magi` and `vde` commands are not
ported yet: asked for, they exit with an error that names their roadmap
item. Nothing heavy is imported before a command runs.
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
NOT_PORTED = {"magi": "ROADMAP.md A12b (MAGI's VAE, pipelines and text tower)",
              "vde": "ROADMAP.md A14b (eval/ and the vde command)"}


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
            "stream": main_stream}


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
                         f"has {', '.join(COMMANDS)} (magi: {NOT_PORTED['magi']}; "
                         f"vde: {NOT_PORTED['vde']})")
    return COMMANDS[cmd](argv[1:])


if __name__ == "__main__":
    sys.exit(main())
