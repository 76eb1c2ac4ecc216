"""The port's media backends (`inferix_tpu_torch.core.media`), monitoring
(`core.monitoring`) and prompt expander (`utils.prompt_extend`): the port's
versions of tests/test_media_memory.py's backend tests, `save_video`
without `imageio`, the rank printing, and the prompt logic against the JAX
package's on a set of prompts (exact equality: the logic is a copy).
"""
import sys

import numpy as np
import pytest

from inferix_tpu.utils import prompt_extend as jpe
from inferix_tpu_torch.core import monitoring
from inferix_tpu_torch.core.media.streaming_backend import (
    MemoryQueueBackend, create_streaming_backend, latents_to_uint8)
from inferix_tpu_torch.core.media.video_utils import (FileStreamingBackend, load_video,
                                                      save_video)
from inferix_tpu_torch.utils import prompt_extend as tpe

PROMPTS = ["a scenic mountain valley", "一只猫在草地上奔跑", "A cat 在 the park",
           "", "日本", "x" * 3 + "猫", "\"Hello\", said the robot. 你好"]


def test_memory_backend_queue():
    b = create_streaming_backend("memory")
    assert isinstance(b, MemoryQueueBackend)
    with b:
        b.stream_batch(np.zeros((3, 8, 8, 3), np.uint8))
        assert b.frames_streamed == 3
        assert b.queue.qsize() == 3
    assert not b.connected


def test_latents_to_uint8():
    v = np.linspace(0, 1, 2 * 2 * 2 * 3).reshape(1, 2, 2, 2, 3)
    u = latents_to_uint8(v)
    assert u.dtype == np.uint8 and u.shape == (2, 2, 2, 3)
    assert u.max() == 255 and u.min() == 0


def test_file_backend_roundtrip(tmp_path):
    b = FileStreamingBackend(path=str(tmp_path / "out.npz"), fps=8)
    with b:
        b.stream_batch(np.full((2, 4, 4, 3), 7, np.uint8))
        b.stream_batch(np.full((1, 4, 4, 3), 9, np.uint8))
    frames = load_video(b.path)
    assert frames.shape == (3, 4, 4, 3)
    assert frames[0, 0, 0, 0] == 7 and frames[2, 0, 0, 0] == 9


def test_gradio_backend_raises_without_gradio():
    b = create_streaming_backend("gradio")
    with pytest.raises(RuntimeError, match="gradio"):
        b.connect()


def test_streaming_backend_factory_all_names():
    mem = create_streaming_backend("memory")
    mem.connect()
    mem.stream_batch(np.zeros((2, 4, 4, 3), np.uint8))
    assert mem.frames_streamed == 2
    mem.disconnect()
    for name in ("gradio", "webrtc", "rtmp"):
        try:
            b = create_streaming_backend(name)
        except (ImportError, RuntimeError) as e:
            msg = str(e).lower()
            assert name in msg or "not found" in msg or "unavailable" in msg, (name, e)
        else:
            assert hasattr(b, "connect") and hasattr(b, "stream_batch")
    with pytest.raises(ValueError, match="unknown streaming backend"):
        create_streaming_backend("nope")
    u8 = latents_to_uint8(np.full((1, 2, 4, 4, 3), 0.5, np.float32))
    assert u8.dtype == np.uint8 and u8.shape == (2, 4, 4, 3)


def test_save_video_without_imageio(tmp_path, monkeypatch):
    """With `imageio` missing, an .npz is written as asked and an .mp4
    falls back to .npz; frames in [0, 1] are quantized as latents_to_uint8
    does."""
    monkeypatch.setitem(sys.modules, "imageio", None)
    with pytest.raises(ImportError):
        import imageio  # noqa: F401
    frames = np.random.default_rng(0).integers(0, 256, (3, 4, 4, 3), dtype=np.uint8)
    out = save_video(frames, str(tmp_path / "a.npz"))
    assert out == str(tmp_path / "a.npz")
    np.testing.assert_array_equal(load_video(out), frames)
    out = save_video(frames, str(tmp_path / "sub" / "b.mp4"))
    assert out == str(tmp_path / "sub" / "b.npz")
    np.testing.assert_array_equal(load_video(out), frames)
    out = save_video(frames.astype(np.float32) / 255.0, str(tmp_path / "c.npz"))
    np.testing.assert_array_equal(load_video(out), frames)
    with pytest.raises(ImportError):
        save_video(frames, str(tmp_path / "d.gif"))


def test_rank_printing(capsys):
    monitoring.print_rank_0("only", "rank", 0)
    monitoring.print_per_rank("hello")
    assert capsys.readouterr().out.splitlines() == ["only rank 0", "[rank 0/1] hello"]


def test_prompt_logic_equals_jax():
    for p in PROMPTS:
        assert tpe.detect_language(p) == jpe.detect_language(p), p
        for task in ("t2v", "i2v"):
            for lang in (None, "en", "ch"):
                assert (tpe.decide_system_prompt(task, lang, p)
                        == jpe.decide_system_prompt(task, lang, p)), (p, task, lang)
        tx, jx = tpe.PassthroughPromptExpander(), jpe.PassthroughPromptExpander()
        assert tx(p, task="i2v") == jx(p, task="i2v") == p
        sp = tpe.decide_system_prompt(prompt=p)
        assert tx.extend(p, sp, seed=3) == tpe.PromptOutput(True, p, 3, sp, "")
        assert tpe.create_prompt_expander("none").__class__ is tpe.PassthroughPromptExpander
    with pytest.raises(ValueError, match="unknown prompt expander"):
        tpe.create_prompt_expander("nope")


def test_qwen_expander_clear_errors(tmp_path, monkeypatch):
    """Without transformers: the JAX package's error. With it but without
    the model on this machine: an error naming the model (nothing is
    downloaded)."""
    monkeypatch.setenv("HF_HUB_OFFLINE", "1")
    monkeypatch.setenv("TRANSFORMERS_OFFLINE", "1")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tpe.QwenPromptExpander(model_name=str(tmp_path), device="cuda")
    with monkeypatch.context() as m:
        m.setitem(sys.modules, "transformers", None)
        with pytest.raises(RuntimeError, match="transformers"):
            tpe.QwenPromptExpander(model_name=str(tmp_path), device="cpu")
    with pytest.raises(RuntimeError, match="not on this machine"):
        tpe.QwenPromptExpander(model_name=str(tmp_path / "absent"), device="cpu")
    with pytest.raises(RuntimeError, match="dashscope"):
        tpe.DashScopePromptExpander()
