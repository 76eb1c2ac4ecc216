"""The causvid and stream commands of the port's command line at `--tiny
--cpu`, with and without `--model-path`: each .npz's frames equal, exactly,
those of the port's pipeline run in this process with the same config and
seed, and of the JAX CLI's shape for the same arguments
(`tests/test_torch_cli.py` holds the self-forcing cases and the rest of the
command line; the suite runs one file on one worker, so the cases of two
files run on two)."""
import pytest

from test_torch_cli import check_command_frames, checkpoint, jax_shapes  # noqa: F401


@pytest.mark.parametrize("with_path", [False, True], ids=["random", "model_path"])
@pytest.mark.parametrize("cmd", ["causvid", "stream"])
def test_command_writes_the_pipeline_frames(tmp_path, checkpoint, jax_shapes, cmd,  # noqa: F811
                                            with_path, capsys):
    check_command_frames(tmp_path, checkpoint, jax_shapes, cmd, with_path, capsys)
