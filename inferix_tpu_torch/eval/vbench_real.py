"""Real VBench metric plug-ins for the VDE harness: the port's copy of
`inferix_tpu/eval/vbench_real.py`.

The reference scores LV-Bench with trained models (`LV-Bench/metrics.py:
13-260`): MUSIQ-SPAQ for clarity, AMT-S for motion smoothness, RAFT for
dynamic degree, DINO ViT-B/16 for subject consistency, CLIP ViT-B/32 for
background consistency, CLIP ViT-L/14 + the LAION head for aesthetics. Each
plug-in loads from a weights path and is a callable `chunk -> float` over a
numpy chunk [T, H, W, 3] in [0, 1], the interface of the proxies in
`eval/vde.py` and `eval/flow_metrics.py`, so `register_real_metrics` swaps
them into the port's `BUILTIN_METRICS`.

Every plug-in runs on the card by default and raises without one; pass
device="cpu" for the CPU. The CLIP, DINO and aesthetic plug-ins import
`transformers` when built, and MUSIQ needs `pyiqa`: without the package each
raises ImportError (the card's machine has neither). RAFT (`eval/raft.py`)
and AMT-S (`eval/amt.py`) are the port's own models.
"""
from __future__ import annotations

from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..core.device import resolve_device

MetricFn = Callable[[np.ndarray], float]

_CLIP_MEAN = np.array([0.48145466, 0.4578275, 0.40821073], np.float32)
_CLIP_STD = np.array([0.26862954, 0.26130258, 0.27577711], np.float32)
_IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], np.float32)
_IMAGENET_STD = np.array([0.229, 0.224, 0.225], np.float32)


def _resize_frames(chunk: np.ndarray, size: int, device: torch.device,
                   mean: np.ndarray, std: np.ndarray) -> torch.Tensor:
    """[T, H, W, 3] in [0,1] -> [T, 3, size, size] on `device`, bicubic
    (the vbench clip/dino transforms resize to 224), then normalized."""
    import torch.nn.functional as F

    x = torch.from_numpy(np.ascontiguousarray(chunk)).float().to(device)
    x = F.interpolate(x.permute(0, 3, 1, 2), size=(size, size), mode="bicubic",
                      align_corners=False, antialias=True)
    return (x - torch.from_numpy(mean).to(device).view(1, 3, 1, 1)) \
        / torch.from_numpy(std).to(device).view(1, 3, 1, 1)


def _consistency_score(feats: torch.Tensor) -> float:
    """VBench subject/background consistency: mean over frames t>0 of
    (max(0, cos(f_{t-1}, f_t)) + max(0, cos(f_0, f_t))) / 2
    (`LV-Bench/metrics.py:84-139`)."""
    import torch.nn.functional as F

    feats = F.normalize(feats, dim=-1, p=2)
    sim, cnt = 0.0, 0
    for i in range(1, feats.shape[0]):
        sim_pre = max(0.0, float(F.cosine_similarity(
            feats[i - 1:i], feats[i:i + 1])))
        sim_fir = max(0.0, float(F.cosine_similarity(
            feats[0:1], feats[i:i + 1])))
        sim += (sim_pre + sim_fir) / 2
        cnt += 1
    return sim / max(cnt, 1)


class CLIPBackgroundConsistency:
    """background consistency via CLIP image embeddings
    (reference compute_background_consistency, metrics.py:108-139)."""

    def __init__(self, weights_path: str, device: str | torch.device = "cuda"):
        self.device = resolve_device(device)
        from transformers import CLIPVisionModelWithProjection

        self.model = CLIPVisionModelWithProjection.from_pretrained(
            weights_path).to(self.device).eval()
        self.size = self.model.config.image_size

    def __call__(self, chunk: np.ndarray) -> float:
        x = _resize_frames(chunk, self.size, self.device, _CLIP_MEAN, _CLIP_STD)
        with torch.no_grad():
            feats = self.model(pixel_values=x).image_embeds
        return _consistency_score(feats)


class DINOSubjectConsistency:
    """subject consistency via DINO ViT-B/16 CLS features
    (reference compute_subject_consistency, metrics.py:84-106)."""

    def __init__(self, weights_path: str, device: str | torch.device = "cuda"):
        self.device = resolve_device(device)
        from transformers import ViTModel

        self.model = ViTModel.from_pretrained(weights_path).to(self.device).eval()
        self.size = self.model.config.image_size

    def __call__(self, chunk: np.ndarray) -> float:
        x = _resize_frames(chunk, self.size, self.device, _IMAGENET_MEAN, _IMAGENET_STD)
        with torch.no_grad():
            out = self.model(pixel_values=x)
        return _consistency_score(out.last_hidden_state[:, 0])


class LAIONAesthetic:
    """LAION aesthetic predictor: CLIP ViT-L/14 image embeds -> linear head
    (reference metrics.py:206-219, vbench aesthetic_quality). head_path is
    a torch state dict for the single nn.Linear(emb_dim, 1)."""

    def __init__(self, clip_path: str, head_path: str, device: str | torch.device = "cuda"):
        self.device = resolve_device(device)
        from transformers import CLIPVisionModelWithProjection

        self.model = CLIPVisionModelWithProjection.from_pretrained(
            clip_path).to(self.device).eval()
        self.size = self.model.config.image_size
        emb = self.model.config.projection_dim
        self.head = torch.nn.Linear(emb, 1)
        sd = torch.load(head_path, map_location="cpu", weights_only=True)
        self.head.load_state_dict(sd)
        self.head.to(self.device).eval()

    def __call__(self, chunk: np.ndarray) -> float:
        x = _resize_frames(chunk, self.size, self.device, _CLIP_MEAN, _CLIP_STD)
        with torch.no_grad():
            feats = self.model(pixel_values=x).image_embeds
            feats = torch.nn.functional.normalize(feats, dim=-1, p=2)
            scores = self.head(feats)
        # vbench normalizes the 1-10 LAION score to [0, 1]
        return float(scores.mean()) / 10.0


class RAFTDynamicDegree:
    """dynamic degree via RAFT flow (reference vbench DynamicDegree,
    `LV-Bench/vbench/dynamic_degree.py:27-98`): per frame pair, mean of
    the top-5% flow magnitudes; the video "moves" if enough pairs exceed
    a resolution-scaled threshold. Returns the moving-pair fraction (a
    graded version of the reference's boolean; thresholding at >=
    count_num/len reproduces the boolean)."""

    def __init__(self, weights_path: str, device: str | torch.device = "cuda",
                 iters: int = 20):
        from .raft import load_raft

        self.device = resolve_device(device)
        self.model = load_raft(weights_path, self.device)
        self.iters = iters

    def _pair_score(self, f1, f2) -> float:
        with torch.no_grad():
            _, flow = self.model(f1, f2, iters=self.iters, test_mode=True)
        rad = torch.sqrt(flow[0, 0] ** 2 + flow[0, 1] ** 2)
        flat = rad.flatten()
        k = max(1, int(flat.numel() * 0.05))
        return float(torch.topk(flat, k).values.mean())

    def pair_scores(self, chunk: np.ndarray) -> Tuple[List[float], float]:
        """Each consecutive pair's mean top-5% flow magnitude, and the
        threshold a pair must pass to count as moving."""
        from .raft import pad_to_multiple_of_8

        frames = torch.from_numpy(
            np.ascontiguousarray(chunk)).float().to(self.device).permute(0, 3, 1, 2) * 255.0
        frames = pad_to_multiple_of_8(frames)
        thres = 6.0 * (min(frames.shape[-2:]) / 256.0)
        return [self._pair_score(frames[i:i + 1], frames[i + 1:i + 2])
                for i in range(frames.shape[0] - 1)], thres

    def __call__(self, chunk: np.ndarray) -> float:
        scores, thres = self.pair_scores(chunk)
        return sum(s > thres for s in scores) / max(len(scores), 1)


class MUSIQClarity:
    """clarity via pyiqa MUSIQ (the reference's exact model,
    metrics.py:178-192). Defers to pyiqa and raises ImportError without it;
    `flow_metrics.musiq_style_clarity` is the weight-free default."""

    def __init__(self, weights_path: Optional[str] = None,
                 device: str | torch.device = "cuda"):
        self.device = resolve_device(device)
        try:
            from pyiqa.archs.musiq_arch import MUSIQ
        except ImportError as e:
            raise ImportError(
                "MUSIQ clarity needs pyiqa, which is not installed; "
                "use the musiq_style_clarity proxy or install pyiqa"
            ) from e
        self.model = MUSIQ(pretrained_model_path=weights_path)
        self.model.to(self.device)
        # .eval() recurses into submodules (dropout/batchnorm); setting
        # .training directly would only flip the top-level module
        self.model.eval()

    def __call__(self, chunk: np.ndarray) -> float:
        x = torch.from_numpy(np.ascontiguousarray(chunk)).float()
        x = x.permute(0, 3, 1, 2).to(self.device)
        with torch.no_grad():
            scores = self.model(x)
        return float(scores.mean())


class AMTMotionSmoothness:
    """motion smoothness via AMT-S interpolation (reference
    metrics.py:195-204, vbench MotionSmoothness), served by the port's AMT-S
    (`eval/amt.py`). Loads the official amt-s.pth;
    `flow_metrics.optical_flow_motion_smoothness` is the weight-free
    default."""

    def __init__(self, ckpt: str, device: str | torch.device = "cuda", config: str = ""):
        from .amt import MotionSmoothnessAMT

        # `config` accepted for reference-CLI compatibility (AMT-S.yaml
        # only names the architecture; the in-repo class IS AMT-S)
        self.motion = MotionSmoothnessAMT(ckpt, device=device)

    def __call__(self, chunk: np.ndarray) -> float:
        return float(self.motion(chunk))


REAL_METRIC_BUILDERS: Dict[str, Callable[..., MetricFn]] = {
    "background_consistency": CLIPBackgroundConsistency,
    "subject_consistency": DINOSubjectConsistency,
    "aesthetic": LAIONAesthetic,
    "dynamic": RAFTDynamicDegree,
    "clarity": MUSIQClarity,
    "motion": AMTMotionSmoothness,
}


def register_real_metrics(weights: Dict[str, Dict], device: str | torch.device = "cuda"
                          ) -> Dict[str, MetricFn]:
    """Instantiate real metrics from a {name: builder-kwargs} spec and
    register them into `vde.BUILTIN_METRICS` (replacing the proxies of the
    same name). Returns the instantiated metrics. Example:

        register_real_metrics({
            "background_consistency": {"weights_path": ".../clip-vit-b32"},
            "dynamic": {"weights_path": ".../raft-things.pth"},
        })
    """
    from .vde import BUILTIN_METRICS

    built: Dict[str, MetricFn] = {}
    for name, kwargs in weights.items():
        if name not in REAL_METRIC_BUILDERS:
            raise ValueError(
                f"unknown real metric {name!r}; "
                f"available: {sorted(REAL_METRIC_BUILDERS)}")
        fn = REAL_METRIC_BUILDERS[name](device=device, **kwargs)
        BUILTIN_METRICS[name] = fn
        built[name] = fn
    return built
