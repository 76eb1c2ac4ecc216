"""inferix_tpu_torch — the PyTorch/CUDA port of the semi-AR video engine.

It runs on one NVIDIA H100 (sm_90a). Plain tensor code is PyTorch; every
kernel the JAX package wrote in Pallas for the TPU is a kernel written by hand
for Hopper (`csrc/`, built by `nvcc` at first use, bound with `ctypes`).

The module layout mirrors `inferix_tpu/`, so each counterpart is easy to
find. This package imports neither `jax` nor anything of `inferix_tpu`.
Entry points take `device=` and default to "cuda"; they raise when no card is
present, and only an explicit `device="cpu"` runs on the CPU, where every
kernel wrapper takes its plain PyTorch version.
"""
from __future__ import annotations

# Public API surface, as `inferix_tpu/__init__.py` lists it for the modules
# ported so far (lazy imports keep `import inferix_tpu_torch` light).
_LAZY = {
    "EngineConfig": "inferix_tpu_torch.core.config",
    "ModelConfig": "inferix_tpu_torch.core.config",
    "QuantConfig": "inferix_tpu_torch.core.config",
    "RuntimeConfig": "inferix_tpu_torch.core.config",
    "tiny_test_config": "inferix_tpu_torch.core.config",
    "DecodeMode": "inferix_tpu_torch.core.types",
    "StreamingMode": "inferix_tpu_torch.core.types",
    "MemoryMode": "inferix_tpu_torch.core.types",
    "InteractiveSession": "inferix_tpu_torch.core.interactive",
    "AsyncMemoryManager": "inferix_tpu_torch.core.memory",
    "SelfForcingPipeline": "inferix_tpu_torch.pipeline.self_forcing",
    "CausVidPipeline": "inferix_tpu_torch.pipeline.causvid",
    "CausalDiffusionPipeline": "inferix_tpu_torch.pipeline.self_forcing_cfg",
    "ContinuousBatcher": "inferix_tpu_torch.pipeline.continuous",
    "SemiARGenerator": "inferix_tpu_torch.pipeline.semi_ar",
    "MagiPipeline": "inferix_tpu_torch.pipeline.magi",
    "MagiVideoPipeline": "inferix_tpu_torch.pipeline.magi",
    "KVCacheManager": "inferix_tpu_torch.kvcache.manager",
    "KVCacheRequest": "inferix_tpu_torch.kvcache.manager",
    "CausalVAE": "inferix_tpu_torch.models.wan.vae",
    "WanTextEncoder": "inferix_tpu_torch.models.text.umt5",
    "CLIPImageEncoder": "inferix_tpu_torch.models.text.clip_vision",
    "InferixProfiler": "inferix_tpu_torch.profiling.profiler",
    "ProfilingConfig": "inferix_tpu_torch.profiling.profiler",
    "FlowUniPCMultistep": "inferix_tpu_torch.models.schedulers.fm_solvers",
    "FlowDPMSolverMultistep": "inferix_tpu_torch.models.schedulers.fm_solvers",
    "DiffusionAnalyzer": "inferix_tpu_torch.profiling.diffusion_analyzer",
    "register_flow_metrics": "inferix_tpu_torch.eval.flow_metrics",
    "initialize_multihost": "inferix_tpu_torch.parallel.multihost",
    "make_global_mesh": "inferix_tpu_torch.parallel.multihost",
    "pp_pipeline": "inferix_tpu_torch.parallel.pipeline_parallel",
    "evaluate_video": "inferix_tpu_torch.eval.vde",
    "quality_delta": "inferix_tpu_torch.eval.vde",
}

__all__ = sorted(_LAZY)


def __getattr__(name: str):
    if name in _LAZY:
        import importlib

        return getattr(importlib.import_module(_LAZY[name]), name)
    raise AttributeError(f"module 'inferix_tpu_torch' has no attribute {name!r}")
