"""The port's VBench model plug-ins (`inferix_tpu_torch/eval/raft.py`,
`eval/amt.py`, `eval/vbench_real.py`) against the JAX package's, on the CPU.

RAFT and AMT-S load one seeded state dict written under tmp_path into both
packages' modules and run on the same seeded frames in float32: the flows,
interpolated frames and scores are held equal within 1e-6 (absolute and
relative; both run the same PyTorch ops on the same CPU, and agree to the
bit here). AMT-S is also held to the golden of the reference's vendored code,
`tests/fixtures/amt_tiny.npz` (read, not changed), at the JAX test's 2e-5.
Both loaders keep their contracts: RAFT strips DataParallel's `module.`
prefixes and loads weights only; AMT-S reads `ckpt.get("state_dict", ckpt)`
and any pickled checkpoint. The three `transformers` metrics run on one
tiny model each (a module-scope fixture writes them under tmp_path) and are
held to the JAX classes within 1e-6. MUSIQ raises without `pyiqa`. Every
port class gets device="cpu": its default is the card (see
`tests/test_torch_ops.py::test_default_entry_points_raise_without_a_card`).
"""
import argparse
import os
import pickle

import numpy as np
import pytest
import torch

from inferix_tpu.eval import amt as jamt
from inferix_tpu.eval import raft as jraft
from inferix_tpu.eval import vbench_real as jreal
from inferix_tpu.eval import vde as jvde
from inferix_tpu_torch.eval import amt as tamt
from inferix_tpu_torch.eval import raft as traft
from inferix_tpu_torch.eval import vbench_real as treal
from inferix_tpu_torch.eval import vde as tvde

TOL = dict(rtol=1e-6, atol=1e-6)
APPROX = dict(rel=1e-6, abs=1e-6)
FIXTURE = os.path.join(os.path.dirname(__file__), "fixtures", "amt_tiny.npz")


def _chunk(t=5, h=32, w=32, seed=0):
    return np.random.default_rng(seed).random((t, h, w, 3)).astype(np.float32)


def _moving(t=5, h=128, w=128, seed=0):
    """A smooth texture sliding 3 px a frame, float32 in [0, 1]."""
    rng = np.random.default_rng(seed)
    base = rng.random((h + 3 * t, w + 3 * t, 3))
    for _ in range(4):
        base = 0.25 * (np.roll(base, 1, 0) + np.roll(base, -1, 0)
                       + np.roll(base, 1, 1) + np.roll(base, -1, 1))
    base = (base - base.min()) / np.ptp(base)
    return np.stack([base[3 * i:3 * i + h, 3 * i:3 * i + w] for i in range(t)]).astype(np.float32)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One torch thread: the tier-1 run puts several test processes on the
    machine's cores at once, and their thread pools would contend."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def weights(tmp_path_factory):
    """Seeded RAFT (module.-prefixed, as raft-things.pth) and AMT-S (under
    "state_dict", as amt-s.pth) checkpoints."""
    path = tmp_path_factory.mktemp("eval_weights")
    torch.manual_seed(2)
    raft_sd = traft.RAFT().state_dict()
    torch.save({f"module.{k}": v for k, v in raft_sd.items()}, path / "raft-things.pth")
    torch.manual_seed(3)
    amt_sd = tamt.AMTS().state_dict()
    torch.save({"state_dict": amt_sd, "args": argparse.Namespace(model="AMT-S")},
               path / "amt-s.pth")
    return {"raft": str(path / "raft-things.pth"), "amt": str(path / "amt-s.pth"),
            "raft_sd": raft_sd, "amt_sd": amt_sd}


@pytest.fixture(scope="module")
def hf_dirs(tmp_path_factory):
    """One tiny CLIP vision tower, one tiny ViT and an aesthetic head."""
    from transformers import (CLIPVisionConfig, CLIPVisionModelWithProjection, ViTConfig,
                              ViTModel)

    path = tmp_path_factory.mktemp("hf")
    torch.manual_seed(0)
    CLIPVisionModelWithProjection(CLIPVisionConfig(
        hidden_size=32, intermediate_size=64, num_hidden_layers=2, num_attention_heads=2,
        image_size=32, patch_size=16, projection_dim=16)).save_pretrained(path / "clip")
    torch.manual_seed(1)
    ViTModel(ViTConfig(hidden_size=32, intermediate_size=64, num_hidden_layers=2,
                       num_attention_heads=2, image_size=32,
                       patch_size=16)).save_pretrained(path / "dino")
    torch.manual_seed(4)
    torch.save(torch.nn.Linear(16, 1).state_dict(), path / "aes.pth")
    return {k: str(path / k) for k in ("clip", "dino", "aes.pth")}


def test_raft_matches_jax(weights):
    port = traft.load_raft(weights["raft"], device="cpu")
    ref = jraft.load_raft(weights["raft"])
    img = torch.from_numpy(_moving(t=2, h=68, w=75, seed=5)).permute(0, 3, 1, 2) * 255.0
    img = traft.pad_to_multiple_of_8(img)
    torch.testing.assert_close(img, jraft.pad_to_multiple_of_8(
        torch.from_numpy(_moving(t=2, h=68, w=75, seed=5)).permute(0, 3, 1, 2) * 255.0))
    assert img.shape[-2:] == (72, 80)
    low, up = port(img[:1], img[1:], iters=3)
    jlow, jup = ref(img[:1], img[1:], iters=3)
    assert up.shape == (1, 2, 72, 80) and torch.isfinite(up).all()
    torch.testing.assert_close(low, jlow, **TOL)
    torch.testing.assert_close(up, jup, **TOL)


def test_load_raft_contract(weights, tmp_path):
    """`module.` prefixes stripped, the weights loaded exactly, and a file
    holding anything but tensors refused (weights_only)."""
    model = traft.load_raft(weights["raft"], device="cpu")
    assert not model.training
    for k, v in model.state_dict().items():
        torch.testing.assert_close(v, weights["raft_sd"][k], rtol=0, atol=0)
    bad = tmp_path / "raft-pickled.pth"
    torch.save({**{f"module.{k}": v for k, v in weights["raft_sd"].items()},
                "args": argparse.Namespace(small=False)}, bad)
    with pytest.raises(pickle.UnpicklingError):
        traft.load_raft(str(bad), device="cpu")


def test_amt_s_matches_reference_fixture():
    data = np.load(FIXTURE)
    sd = {k[4:]: torch.tensor(np.asarray(data[k])).float()
          for k in data.files if k.startswith("sd::")}
    port = tamt.AMTS(corr_radius=2, corr_lvls=2, num_flows=2)
    port.load_state_dict(sd, strict=True)
    ref = jamt.AMTS(corr_radius=2, corr_lvls=2, num_flows=2)
    ref.load_state_dict(sd, strict=True)
    img0, img1 = (torch.tensor(np.asarray(data[k])) for k in ("img0", "img1"))
    embt = torch.full((1, 1, 1, 1), 0.5)
    with torch.no_grad():
        out = port.eval()(img0, img1, embt)
        want = ref.eval()(img0, img1, embt)
    np.testing.assert_allclose(out.numpy(), np.asarray(data["out"]), atol=2e-5, rtol=2e-5)
    torch.testing.assert_close(out, want, **TOL)


def test_amt_s_matches_jax(weights):
    port = tamt.load_amt_s(weights["amt"], device="cpu")
    ref = jamt.load_amt_s(weights["amt"])
    n = sum(p.numel() for p in port.parameters())
    assert 2_900_000 < n < 3_200_000  # the official AMT-S is ~3.0M parameters
    frames = torch.from_numpy(_moving(t=2, seed=6)).permute(0, 3, 1, 2)
    embt = torch.full((1, 1, 1, 1), 0.5)
    with torch.no_grad():
        out = port(frames[:1], frames[1:], embt)
        want = ref(frames[:1], frames[1:], embt)
    assert out.shape == (1, 3, 128, 128)
    torch.testing.assert_close(out, want, **TOL)


def test_load_amt_s_contract(weights, tmp_path):
    """ckpt["state_dict"], or the bare state dict; pickled extras load."""
    for ckpt in ({"state_dict": weights["amt_sd"], "args": argparse.Namespace()},
                 weights["amt_sd"]):
        torch.save(ckpt, tmp_path / "amt.pth")
        model = tamt.load_amt_s(str(tmp_path / "amt.pth"), device="cpu")
        assert not model.training
        for k, v in model.state_dict().items():
            torch.testing.assert_close(v, weights["amt_sd"][k], rtol=0, atol=0)
    with pytest.raises((FileNotFoundError, OSError)):
        treal.AMTMotionSmoothness("/nonexistent/amt-s.pth", device="cpu")


def test_raft_dynamic_degree_matches_jax(weights):
    port = treal.RAFTDynamicDegree(weights["raft"], device="cpu", iters=3)
    ref = jreal.RAFTDynamicDegree(weights["raft"], iters=3)
    chunk = _moving(t=2, h=64, w=64, seed=7)
    scores, thres = port.pair_scores(chunk)
    assert thres == 6.0 * 64 / 256
    frames = torch.from_numpy(chunk).permute(0, 3, 1, 2) * 255.0
    np.testing.assert_allclose(scores, [ref._pair_score(frames[:1], frames[1:])], **TOL)
    assert port(chunk) == ref(chunk) == float(scores[0] > thres)


def test_amt_motion_smoothness_matches_jax(weights):
    port = treal.AMTMotionSmoothness(weights["amt"], device="cpu")
    ref = jreal.AMTMotionSmoothness(weights["amt"])
    chunk = _moving(t=4, h=120, w=136, seed=8)  # padded to 128 x 144 inside
    actual, interp = port.motion.interpolate(chunk)
    # frame 3 has one even neighbour: only frame 1 is interpolated
    assert actual.shape == interp.shape == (1, 120, 136, 3) and interp.dtype == np.uint8
    np.testing.assert_array_equal(actual, (chunk[1:2] * 255).astype(np.uint8))
    score = port(chunk)
    assert score == tamt.smoothness_score(actual, interp)
    assert score == pytest.approx(ref(chunk), **APPROX)
    assert port(chunk[:2]) == ref(chunk[:2]) == 1.0  # one even frame: nothing to interpolate


def test_clip_background_consistency_matches_jax(hf_dirs):
    port = treal.CLIPBackgroundConsistency(hf_dirs["clip"], device="cpu")
    ref = jreal.CLIPBackgroundConsistency(hf_dirs["clip"])
    chunk = _chunk(seed=9)
    assert port(chunk) == pytest.approx(ref(chunk), **APPROX)
    assert port(np.repeat(_chunk(t=1), 4, axis=0)) == pytest.approx(1.0, abs=1e-5)


def test_dino_subject_consistency_matches_jax(hf_dirs):
    port = treal.DINOSubjectConsistency(hf_dirs["dino"], device="cpu")
    ref = jreal.DINOSubjectConsistency(hf_dirs["dino"])
    chunk = _chunk(seed=10)
    assert port(chunk) == pytest.approx(ref(chunk), **APPROX)
    assert 0.0 <= port(chunk) <= 1.0


def test_laion_aesthetic_matches_jax(hf_dirs):
    port = treal.LAIONAesthetic(hf_dirs["clip"], hf_dirs["aes.pth"], device="cpu")
    ref = jreal.LAIONAesthetic(hf_dirs["clip"], hf_dirs["aes.pth"])
    chunk = _chunk(seed=11)
    assert np.isfinite(port(chunk))
    assert port(chunk) == pytest.approx(ref(chunk), **APPROX)


def test_musiq_needs_pyiqa():
    try:
        import pyiqa  # noqa: F401
    except ImportError:
        with pytest.raises(ImportError, match="pyiqa"):
            treal.MUSIQClarity(device="cpu")
    else:
        pytest.skip("pyiqa is installed: MUSIQ builds")


def test_register_real_metrics(hf_dirs, weights):
    """Real metrics replace the proxies in the port's registry, and only
    there; evaluate_video runs through them; an unknown name raises."""
    saved = [(reg, dict(reg)) for reg in (tvde.BUILTIN_METRICS, jvde.BUILTIN_METRICS)]
    try:
        built = treal.register_real_metrics(
            {"background_consistency": {"weights_path": hf_dirs["clip"]},
             "dynamic": {"weights_path": weights["raft"], "iters": 2}}, device="cpu")
        assert set(built) == {"background_consistency", "dynamic"}
        for name, fn in built.items():
            assert tvde.BUILTIN_METRICS[name] is fn
            assert jvde.BUILTIN_METRICS[name] is saved[1][1][name]
        assert isinstance(built["dynamic"], treal.RAFTDynamicDegree)
        video = _moving(t=4, h=64, w=64, seed=12)
        out = tvde.evaluate_video(video, n_chunks=2, metrics=list(built))
        chunks = tvde.split_chunks(video, 2)
        assert out == {name: tvde.vde(chunks, fn) for name, fn in built.items()}
        assert np.isfinite(out["background_consistency"])
        with pytest.raises(ValueError, match="unknown real metric"):
            treal.register_real_metrics({"nope": {}}, device="cpu")
    finally:
        for reg, old in saved:
            reg.clear()
            reg.update(old)
