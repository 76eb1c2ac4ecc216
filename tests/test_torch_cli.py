"""The port's command line (`inferix_tpu_torch.cli`): the self-forcing,
causvid and stream commands at `--tiny --cpu`, with and without
`--model-path` (a reference-format checkpoint written under tmp_path), each
writing an .npz whose frames equal, exactly, those of the port's pipeline
run in this process with the same config and seed; each output's shape
equal to the JAX CLI's for the same arguments (its values differ: the two
packages draw other noise); the causvid and stream cases of that check are
in `tests/test_torch_cli_frames.py`. The magi command at `--tiny --cpu` with a
ViT-VAE directory written under tmp_path (config.json + safetensors): with
the tiny defaults, with a `--config` JSON whose num_steps it keeps, as a
module, and with `--image` on a PNG written here; its frames equal,
exactly, those of a `MagiPipeline` walk decoded by the same VAE in this
process. The vde command on an .npz written under tmp_path (uint8 frames, and
float frames in [0, 1]): its JSON equal, exactly, to the JAX `main_vde`'s on
the same file, with the default metrics, `--metrics`, `--weight-type log`
and `--compare` (both are host numpy; a fixture restores both packages'
metric registries, which the commands write). `python -m inferix_tpu_torch.cli`
dispatches like the JAX module; an unknown command exits with an error that
names the commands.
"""
import dataclasses
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from inferix_tpu_torch import cli
from inferix_tpu_torch.core.config import tiny_test_config
from inferix_tpu_torch.core.media.streaming_backend import latents_to_uint8
from inferix_tpu_torch.core.types import StreamingMode
from inferix_tpu_torch.pipeline.causvid import CausVidPipeline
from inferix_tpu_torch.pipeline.self_forcing import SelfForcingPipeline

from test_checkpoint_and_text import _torch_causal_wan_sd
from test_magi_vae_parity import TINY as TINY_VAE, make_vae_sd

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PROMPT = "a scenic mountain valley"  # the CLI's default prompt
ARGS = {"self-forcing": [], "causvid": ["--rollouts", "2"],
        "stream": ["--segments", "2", "--backend", "file"]}


@pytest.fixture(scope="module")
def checkpoint(tmp_path_factory):
    path = tmp_path_factory.mktemp("ckpt")
    torch.save({"generator_ema": _torch_causal_wan_sd(tiny_test_config().model, seed=2)},
               path / "self_forcing_dmd.pt")
    return str(path)


@pytest.fixture(scope="module")
def jax_shapes(tmp_path_factory):
    """The JAX CLI's output shape for a command's arguments (the JAX command
    run at the first request for it, so that a file runs only the JAX
    commands of its own cases)."""
    import jax

    jax.config.update("jax_platforms", "cpu")
    from inferix_tpu import cli as jcli

    out = tmp_path_factory.mktemp("jax")
    mains = {"self-forcing": jcli.main_self_forcing, "causvid": jcli.main_causvid,
             "stream": jcli.main_stream}
    shapes = {}

    def shape(cmd):
        if cmd not in shapes:
            path = str(out / f"{cmd}.npz")
            assert mains[cmd](["--tiny", "--cpu", "--output", path, *ARGS[cmd]]) == 0
            shapes[cmd] = np.load(path)["frames"].shape
        return shapes[cmd]

    return shape


def _in_process(cmd, model_path):
    """The frames the command should write, from the pipeline run here."""
    cfg = tiny_test_config()
    cfg.model_path = model_path
    cfg.runtime.seed = 42
    if cmd == "self-forcing":
        pipe = SelfForcingPipeline(cfg, dtype=torch.float32, device="cpu")
        video = pipe.run_text_to_video([PROMPT], num_frames=4)
        return latents_to_uint8(video.numpy())
    if cmd == "causvid":
        pipe = CausVidPipeline(cfg, dtype=torch.float32, device="cpu")
        videos = pipe.run_rollouts(PROMPT, num_rollouts=2, num_overlap_frames=3)
        return latents_to_uint8(torch.cat(videos, dim=1).numpy())
    cfg.runtime.streaming_mode = StreamingMode.TRUE_STREAMING
    pipe = SelfForcingPipeline(cfg, dtype=torch.float32, device="cpu")
    frames = []
    pipe.run_streaming_generation([PROMPT], num_segments=2,
                                  stream_callback=lambda px: frames.append(
                                      latents_to_uint8(px.numpy())))
    return np.concatenate(frames)


def check_command_frames(tmp_path, checkpoint, jax_shapes, cmd, with_path, capsys):
    """The command's .npz: uint8 frames of the JAX CLI's shape, equal to
    the pipeline's run here."""
    path = str(tmp_path / "x.npz")
    argv = [cmd, "--tiny", "--cpu", "--output", path, *ARGS[cmd]]
    if with_path:
        argv += ["--model-path", checkpoint]
    assert cli.main(argv) == 0
    got = np.load(path)["frames"]
    assert got.dtype == np.uint8 and got.shape == jax_shapes(cmd)
    np.testing.assert_array_equal(got, _in_process(cmd, checkpoint if with_path else None))
    if cmd == "stream":
        assert f"streamed {got.shape[0]} frames via file" in capsys.readouterr().out


# the causvid and stream cases are in tests/test_torch_cli_frames.py (the
# suite runs a file on one worker: two files take two)
@pytest.mark.parametrize("with_path", [False, True], ids=["random", "model_path"])
@pytest.mark.parametrize("cmd", ["self-forcing"])
def test_command_writes_the_pipeline_frames(tmp_path, checkpoint, jax_shapes, cmd,
                                            with_path, capsys):
    check_command_frames(tmp_path, checkpoint, jax_shapes, cmd, with_path, capsys)


@pytest.mark.parametrize("with_path", [False, True], ids=["random", "model_path"])
def test_stream_memory_backend(checkpoint, with_path, capsys):
    argv = ["stream", "--tiny", "--cpu", "--segments", "2", "--backend", "memory"]
    if with_path:
        argv += ["--model-path", checkpoint]
    assert cli.main(argv) == 0
    assert "streamed 22 frames via memory" in capsys.readouterr().out


def test_default_is_the_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default runs on it")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(["self-forcing", "--tiny", "--output", str(tmp_path / "x.npz")])


def _module(*args):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    return subprocess.run([sys.executable, "-m", "inferix_tpu_torch.cli", *args], cwd=REPO,
                          env=env, capture_output=True, text=True, timeout=300)


def test_module_dispatch(tmp_path, checkpoint):
    res = _module("self-forcing", "--tiny", "--cpu", "--model-path", checkpoint,
                  "--output", str(tmp_path / "sf.npz"))
    assert res.returncode == 0, res.stderr
    np.testing.assert_array_equal(np.load(tmp_path / "sf.npz")["frames"],
                                  _in_process("self-forcing", checkpoint))


def test_unknown_command_names_the_commands():
    res = _module("bogus", "--tiny", "--cpu")
    assert res.returncode != 0 and res.stdout == ""
    assert "unknown command 'bogus'" in res.stderr, res.stderr
    assert "self-forcing, causvid, stream, magi, vde" in res.stderr, res.stderr
    with pytest.raises(SystemExit, match="commands are .*vde"):
        cli.main(["bogus"])


@pytest.fixture
def vde_files(tmp_path):
    """Two 12-frame clips: uint8 codes, and float32 frames in [0, 1]; both
    packages' metric registries restored after the test."""
    from inferix_tpu.eval import vde as jvde
    from inferix_tpu_torch.eval import vde as tvde

    rng = np.random.default_rng(5)
    base = rng.integers(0, 256, (40, 48, 3)).astype(np.float32)
    a = np.stack([np.roll(base, 2 * i, axis=1)[:32] for i in range(12)]).astype(np.uint8)
    b = np.clip(a / 255.0 + 0.05 * rng.standard_normal(a.shape), 0, 1).astype(np.float32)
    np.savez(tmp_path / "a.npz", frames=a)
    np.savez(tmp_path / "b.npz", frames=b)
    saved = [(reg, dict(reg)) for reg in (tvde.BUILTIN_METRICS, jvde.BUILTIN_METRICS)]
    yield str(tmp_path / "a.npz"), str(tmp_path / "b.npz")
    for reg, old in saved:
        reg.clear()
        reg.update(old)


@pytest.mark.parametrize("flags", [[], ["--metrics", "brightness,clarity,motion_flow"],
                                   ["--weight-type", "log"], ["--compare"]],
                         ids=["default", "metrics", "log", "compare"])
def test_vde_matches_jax_main_vde(tmp_path, vde_files, flags, capsys):
    from inferix_tpu import cli as jcli

    a, b = vde_files
    flags = flags + [b] if flags == ["--compare"] else flags
    results = []
    for main, out in ((lambda argv: cli.main(["vde", *argv]), "port.json"),
                      (jcli.main_vde, "jax.json")):
        assert main([a, b, "--chunks", "3", *flags, "--output", str(tmp_path / out)]) == 0
        results.append(json.loads((tmp_path / out).read_text()))
    assert results[0] == results[1]
    assert list(results[0]) == [a, b]
    assert json.loads(capsys.readouterr().out.split("\n}\n")[0] + "\n}") == results[0]
    names = ({"brightness", "clarity", "motion_flow"} if "--metrics" in flags else
             {"brightness", "clarity", "motion", "aesthetic", "dynamic", "subject_consistency",
              "background_consistency", "clarity_musiq", "motion_flow", "dynamic_flow"})
    for scores in results[0].values():
        assert set(scores) == names
        assert all(np.isfinite(v) for v in scores.values())
    if "--compare" in flags:
        assert all(v == 0.0 for v in results[0][b].values())


def test_vde_module_dispatch(tmp_path, vde_files):
    a, _ = vde_files
    res = _module("vde", a, "--chunks", "4", "--metrics", "brightness,clarity",
                  "--output", str(tmp_path / "vde.json"))
    assert res.returncode == 0, res.stderr
    from inferix_tpu_torch.eval.vde import evaluate_video

    frames = np.load(a)["frames"].astype(np.float32) / 255.0
    want = {a: evaluate_video(frames, n_chunks=4, metrics=["brightness", "clarity"])}
    assert json.loads((tmp_path / "vde.json").read_text()) == json.loads(res.stdout) == want


MAGI_ARGS = ["--chunks", "2", "--num-steps", "4", "--window-size", "2"]
MAGI_CONFIG = {"model": {"num_layers": 2, "hidden_size": 128, "ffn_hidden_size": 256,
                         "num_attention_heads": 4, "num_query_groups": 2, "kv_channels": 32,
                         "caption_channels": 64, "caption_max_length": 8, "chunk_width": 2,
                         "rope_max_seq_len": 64},
               "runtime": {"cfg_number": 3, "num_steps": 4, "window_size": 2,
                           "chunk_width": 2, "seed": 7}}


@pytest.fixture(scope="module")
def magi_vae_dir(tmp_path_factory):
    """A tiny ViT-VAE (z 16, the tiny DiT's latent channels) as a reference
    directory: config.json (ddconfig) + diffusion_pytorch_model.safetensors."""
    from safetensors.torch import save_file

    path = tmp_path_factory.mktemp("magi_vae")
    cfg = dataclasses.replace(TINY_VAE, z_chans=16)
    dd = {k: getattr(cfg, k) for k in ("video_size", "video_length", "patch_size",
                                       "patch_length", "z_chans", "embed_dim", "depth",
                                       "num_heads")}
    (path / "config.json").write_text(json.dumps({"ddconfig": dd}))
    save_file({k: v.contiguous() for k, v in make_vae_sd(cfg).items()},
              str(path / "diffusion_pytorch_model.safetensors"))
    return str(path)


def _magi_in_process(vae_dir, config=None, image=None):
    """The frames the magi command should write: the walk and the decode in
    this process, with the command's config, seed and caption."""
    from inferix_tpu_torch.models.magi.dit import tiny_magi_config
    from inferix_tpu_torch.pipeline.magi import (MagiPipeline, MagiRuntimeConfig,
                                                 magi_config_from_json)
    from inferix_tpu_torch.pipeline.magi_media import (encode_prefix_latents, load_media,
                                                       process_image)
    from inferix_tpu_torch.utils.checkpoint import load_magi_vae

    if config:
        mcfg, rt = magi_config_from_json(config)
        rt.seed = 42
    else:
        mcfg = tiny_magi_config()
        rt = MagiRuntimeConfig(num_steps=4, window_size=2, seed=42, chunk_width=2)
    pipe = MagiPipeline(mcfg, rt, latent_h=8, latent_w=8, max_chunks=4, dtype=torch.float32,
                        device="cpu")
    vae = load_magi_vae(vae_dir, device="cpu")
    prefix = None
    if image:
        frames = process_image(load_media(image)[0], 32, 32, "fit")
        prefix = encode_prefix_latents(vae, frames, chunk_width=rt.chunk_width)
    cap = torch.zeros(1, mcfg.caption_max_length, mcfg.caption_channels)
    cmask = torch.ones(1, mcfg.caption_max_length, dtype=torch.int32)
    px = [vae.decode(c) for _, c in pipe.generate_chunks(cap, cmask, 2, prefix_latents=prefix)]
    return latents_to_uint8((torch.cat(px, dim=1)[0] * 0.5 + 0.5).numpy())


@pytest.mark.parametrize("with_config", [False, True], ids=["tiny", "config"])
def test_magi_command_writes_the_pipeline_frames(tmp_path, magi_vae_dir, with_config):
    """`magi --tiny --cpu --vae DIR`: the tiny defaults, or a --config JSON
    (cfg 3, num_steps 4 kept: no --num-steps given)."""
    path = str(tmp_path / "magi.npz")
    argv = ["magi", "--tiny", "--cpu", "--vae", magi_vae_dir, "--output", path, "--chunks", "2"]
    config = None
    if with_config:
        config = str(tmp_path / "magi_tiny.json")
        with open(config, "w") as f:
            json.dump(MAGI_CONFIG, f)
        argv += ["--config", config]
    else:
        argv += MAGI_ARGS[2:]
    assert cli.main(argv) == 0
    got = np.load(path)["frames"]
    # 2 chunks of 2 latent frames, 2 pixel frames each, at 8 x 4 = 32 pixels
    assert got.dtype == np.uint8 and got.shape == (8, 32, 32, 3)
    np.testing.assert_array_equal(got, _magi_in_process(magi_vae_dir, config))


def test_magi_module_dispatch(tmp_path, magi_vae_dir):
    res = _module("magi", "--tiny", "--cpu", "--vae", magi_vae_dir, *MAGI_ARGS,
                  "--output", str(tmp_path / "magi.npz"))
    assert res.returncode == 0, res.stderr
    assert "chunk 1: (1, 2, 8, 8, 16) finite=True" in res.stdout
    np.testing.assert_array_equal(np.load(tmp_path / "magi.npz")["frames"],
                                  _magi_in_process(magi_vae_dir))


def test_magi_image_prefix(tmp_path, magi_vae_dir):
    """`--image` on a PNG written with imageio: the image encoded as one
    prefix chunk, one chunk generated after it."""
    imageio = pytest.importorskip("imageio")
    png = str(tmp_path / "prefix.png")
    imageio.imwrite(png, np.random.default_rng(3).integers(0, 256, (20, 24, 3)).astype(np.uint8))
    path = str(tmp_path / "magi.npz")
    assert cli.main(["magi", "--tiny", "--cpu", "--vae", magi_vae_dir, "--image", png,
                     *MAGI_ARGS, "--output", path]) == 0
    got = np.load(path)["frames"]
    assert got.shape == (4, 32, 32, 3)
    np.testing.assert_array_equal(got, _magi_in_process(magi_vae_dir, image=png))
