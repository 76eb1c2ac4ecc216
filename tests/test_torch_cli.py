"""The port's command line (`inferix_tpu_torch.cli`): the self-forcing,
causvid and stream commands at `--tiny --cpu`, with and without
`--model-path` (a reference-format checkpoint written under tmp_path), each
writing an .npz whose frames equal, exactly, those of the port's pipeline
run in this process with the same config and seed; each output's shape
equal to the JAX CLI's for the same arguments (its values differ: the two
packages draw other noise). `python -m inferix_tpu_torch.cli` dispatches
like the JAX module; `magi` and `vde` exit with an error that names their
roadmap item.
"""
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
    """The JAX CLI's output shape for each command's arguments."""
    import jax

    jax.config.update("jax_platforms", "cpu")
    from inferix_tpu import cli as jcli

    out = tmp_path_factory.mktemp("jax")
    mains = {"self-forcing": jcli.main_self_forcing, "causvid": jcli.main_causvid,
             "stream": jcli.main_stream}
    shapes = {}
    for cmd, main in mains.items():
        path = str(out / f"{cmd}.npz")
        assert main(["--tiny", "--cpu", "--output", path, *ARGS[cmd]]) == 0
        shapes[cmd] = np.load(path)["frames"].shape
    return shapes


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


@pytest.mark.parametrize("with_path", [False, True], ids=["random", "model_path"])
@pytest.mark.parametrize("cmd", list(ARGS))
def test_command_writes_the_pipeline_frames(tmp_path, checkpoint, jax_shapes, cmd,
                                            with_path, capsys):
    path = str(tmp_path / "x.npz")
    argv = [cmd, "--tiny", "--cpu", "--output", path, *ARGS[cmd]]
    if with_path:
        argv += ["--model-path", checkpoint]
    assert cli.main(argv) == 0
    got = np.load(path)["frames"]
    assert got.dtype == np.uint8 and got.shape == jax_shapes[cmd]
    np.testing.assert_array_equal(got, _in_process(cmd, checkpoint if with_path else None))
    if cmd == "stream":
        assert f"streamed {got.shape[0]} frames via file" in capsys.readouterr().out


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


@pytest.mark.parametrize("cmd,item", [("magi", "A12b"), ("vde", "A14b"), ("bogus", "A12b")])
def test_commands_not_ported_name_the_roadmap(cmd, item):
    res = _module(cmd, "--tiny", "--cpu")
    assert res.returncode != 0 and res.stdout == ""
    assert "ROADMAP.md" in res.stderr and item in res.stderr, res.stderr
    with pytest.raises(SystemExit, match=item):
        cli.main([cmd])
