"""The port's own copy of the engine configuration.

Mirrors `inferix_tpu/core/config.py` (`ModelConfig`, `ParallelConfig`,
`QuantConfig`, `RuntimeConfig`, `EngineConfig`, `tiny_test_config`) with the
same names and defaults, cut to the fields this port reads. It is a copy,
not an import: the port never imports the JAX package.

`EngineConfig.from_dict` loads what the JAX package's `EngineConfig.to_dict`
writes. The JAX keys that name a TPU grid or an XLA switch the port does
not have (`IGNORED_KEYS`) are taken by name and dropped; keys whose value the
port hard-wires (`FIXED_KEYS`) must hold that value. The `parallel` section
takes data, sequence and tensor parallelism (`dp`, `sp`, `tp` > 1, an
`sp_mode`); `pp` above 1 is refused by name. Any other unknown key raises KeyError, as in
the JAX package.
"""
from __future__ import annotations

import dataclasses
import enum
import json
import pathlib
from typing import Any, Dict, Optional, Tuple

from .types import DecodeMode, MemoryMode, StreamingMode


@dataclasses.dataclass
class ModelConfig:
    """Causal DiT hyperparameters; defaults are Wan2.1-T2V-1.3B."""

    model_type: str = "t2v"
    patch_size: Tuple[int, int, int] = (1, 2, 2)
    text_len: int = 512
    in_dim: int = 16
    dim: int = 1536
    ffn_dim: int = 8960
    freq_dim: int = 256
    text_dim: int = 4096
    out_dim: int = 16
    num_heads: int = 12
    num_layers: int = 30
    local_attn_size: int = -1  # frames; -1 = global window (cache cap applies)
    sink_size: int = 0         # frames pinned at the start of the rolling cache
    cross_attn_norm: bool = True
    eps: float = 1e-6
    rope_max_seq_len: int = 1024
    fuse_qkv: bool = True
    num_frame_per_block: int = 3
    max_attention_frames: int = 21

    @property
    def head_dim(self) -> int:
        assert self.dim % self.num_heads == 0
        return self.dim // self.num_heads

    @property
    def attention_window_frames(self) -> int:
        if self.local_attn_size == -1:
            return self.max_attention_frames
        return self.local_attn_size


SP_MODES = ("ulysses", "ring", "ring_pass_q", "ring_pass_kv", "auto")


@dataclasses.dataclass
class ParallelConfig:
    """The parallel layout; a copy of `inferix_tpu/core/config.py:ParallelConfig`.

    The port runs data, sequence, tensor and pipeline parallelism
    (`parallel/`): dp sp tp pp ranks, one process each, laid out as the JAX
    mesh lays its devices (`parallel.mesh.make_mesh`). `sp_mode` "ulysses",
    "ring" / "ring_pass_q" or "ring_pass_kv" chooses Wan's attention island;
    "auto" (or any mode at sp = 1 and tp = 1) runs none, as in the JAX
    generator."""

    dp: int = 1
    sp: int = 1
    tp: int = 1
    pp: int = 1
    sp_mode: str = "ulysses"

    def __post_init__(self):
        for axis in ("dp", "sp", "tp", "pp"):
            if getattr(self, axis) < 1:
                raise ValueError(f"parallel.{axis} must be >= 1, got {getattr(self, axis)}")
        if self.sp_mode not in SP_MODES:
            raise ValueError(f"parallel.sp_mode must be one of {SP_MODES}, got "
                             f"{self.sp_mode!r}")

    @property
    def world_size(self) -> int:
        return self.dp * self.sp * self.tp * self.pp

    def axis_sizes(self) -> Dict[str, int]:
        return {"dp": self.dp, "sp": self.sp, "tp": self.tp, "pp": self.pp}


@dataclasses.dataclass
class QuantConfig:
    """Quantization recipe; a copy of `inferix_tpu/core/config.py:QuantConfig`
    cut to the fields this port reads.

    int8 per_channel is the W8A8 serving recipe: int8 weights with one scale
    per output channel, activations quantized per token at run time by the
    fused act-quant and LN+modulate+quant passes, the product in the int8
    GEMM kernel. fp8 is weight-only: e4m3 weights with float32 scales,
    widened to bf16 inside the fp8-dequant GEMM kernel; activations stay
    bf16.

    With `enabled` and `quantize_kv_cache`, the self-attention KV cache is
    stored in fewer bits: `kv_cache_dtype` "int8" holds int8 K/V with one
    float32 scale per (token, head), "fp8" holds scale-free e4m3 K/V. Both
    halve the cache's bytes against bf16.
    """

    enabled: bool = False
    dtype: str = "int8"               # "int8" | "fp8" (e4m3 weight-only)
    granularity: str = "per_channel"  # "per_tensor" | "per_channel"
    quantize_kv_cache: bool = False
    kv_cache_dtype: str = "int8"      # "int8" | "fp8" (e4m3)
    # module-path substrings kept in high precision
    exclude: Tuple[str, ...] = ("text_embedding", "head", "patch_embedding", "time_")

    def __post_init__(self):
        if self.dtype not in ("int8", "fp8"):
            raise ValueError(f"quant dtype must be 'int8' or 'fp8', got {self.dtype!r}")


@dataclasses.dataclass
class RuntimeConfig:
    dtype: str = "bfloat16"
    seed: int = 42
    denoising_step_list: Tuple[int, ...] = (1000, 750, 500, 250)
    warp_denoising_step: bool = True
    context_noise: int = 0
    # "rerun": extra forward on the clean x0 at t=context_noise persists the
    # block's KV; "last_step": the final denoise step persists it instead.
    context_mode: str = "rerun"
    timestep_shift: float = 8.0
    guidance_scale: float = 0.0
    decode_mode: DecodeMode = DecodeMode.AFTER_ALL
    streaming_mode: StreamingMode = StreamingMode.AUTO
    memory_mode: MemoryMode = MemoryMode.RELAXED
    vae_chunk_size: int = 2
    free_cache_before_vae: bool = True
    # the VAE's conv impl (`models.wan.vae.CONV_IMPLS`): "xla" (cuDNN),
    # "halo" (the bf16 halo conv kernel), "halo_w8a8" (the W8A8 one, lossy)
    vae_conv_impl: str = "xla"
    # streaming segments
    frames_per_segment: int = 21
    overlap_frames: int = 3
    num_frames: int = 21
    latent_channels: int = 16
    latent_height: int = 60
    latent_width: int = 104
    batch_size: int = 1
    # the cache's layouts (`kvcache/cache.py`): [L, B, H, S, D] storage, and
    # the slots padded to a multiple of 2048 (never written or attended)
    kv_head_major: bool = False
    kv_alloc_pad: bool = False


# JAX keys with no counterpart here, dropped by from_dict: the TPU's span
# grid (span_grid), the rope's MXU formulation (rope_mxu), the unrolled XLA
# layer loop (unroll_layers), the fused act-quant switch (the port always
# takes the fused chain), and first_last_layer_excluded (read by neither
# package).
IGNORED_KEYS = {
    "model": ("unroll_layers",),
    "quant": ("fused_act_quant", "first_last_layer_excluded"),
    "runtime": ("span_grid", "rope_mxu"),
}
# JAX keys whose value the port hard-wires: any other value raises.
FIXED_KEYS = {"model": {"qk_norm": True, "independent_first_frame": False}}
_ENUMS = {"decode_mode": DecodeMode, "streaming_mode": StreamingMode,
          "memory_mode": MemoryMode}


def _build(klass, section: str, sub: Optional[Dict[str, Any]]):
    fields = {f.name for f in dataclasses.fields(klass)}
    kwargs = {}
    for k, v in (sub or {}).items():
        if k in IGNORED_KEYS.get(section, ()):
            continue
        fixed = FIXED_KEYS.get(section, {})
        if k in fixed:
            if v != fixed[k]:
                raise ValueError(f"{section}.{k} = {v!r}: the port implements "
                                 f"{fixed[k]!r} only")
            continue
        if k not in fields:
            raise KeyError(f"Unknown config key {k!r} for {klass.__name__}")
        if isinstance(v, list):
            v = tuple(v)
        if k in _ENUMS:
            v = _ENUMS[k](v)
        kwargs[k] = v
    return klass(**kwargs)


@dataclasses.dataclass
class EngineConfig:
    model: ModelConfig = dataclasses.field(default_factory=ModelConfig)
    runtime: RuntimeConfig = dataclasses.field(default_factory=RuntimeConfig)
    quant: QuantConfig = dataclasses.field(default_factory=QuantConfig)
    parallel: ParallelConfig = dataclasses.field(default_factory=ParallelConfig)
    model_path: Optional[str] = None
    profile: bool = False

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "EngineConfig":
        return cls(
            parallel=_build(ParallelConfig, "parallel", d.get("parallel")),
            model=_build(ModelConfig, "model", d.get("model")),
            quant=_build(QuantConfig, "quant", d.get("quant")),
            runtime=_build(RuntimeConfig, "runtime", d.get("runtime")),
            model_path=d.get("model_path"),
            profile=bool(d.get("profile", False)),
        )

    @classmethod
    def from_json(cls, path: str | pathlib.Path) -> "EngineConfig":
        with open(path) as f:
            return cls.from_dict(json.load(f))

    def to_dict(self) -> Dict[str, Any]:
        def clean(v):
            if isinstance(v, enum.Enum):
                return v.value
            if isinstance(v, dict):
                return {k: clean(x) for k, x in v.items()}
            if isinstance(v, (list, tuple)):
                return [clean(x) for x in v]
            return v

        return clean(dataclasses.asdict(self))


def tiny_test_config() -> EngineConfig:
    """The same small shapes as `inferix_tpu.core.config.tiny_test_config`."""
    cfg = EngineConfig()
    cfg.model = ModelConfig(
        dim=128,
        ffn_dim=256,
        num_heads=4,
        num_layers=2,
        freq_dim=32,
        text_dim=64,
        text_len=16,
        num_frame_per_block=1,
        max_attention_frames=6,
        rope_max_seq_len=64,
    )
    cfg.runtime = RuntimeConfig(
        num_frames=5,
        latent_channels=16,
        latent_height=8,
        latent_width=8,
        denoising_step_list=(1000, 500),
        frames_per_segment=4,
        overlap_frames=1,
    )
    return cfg
