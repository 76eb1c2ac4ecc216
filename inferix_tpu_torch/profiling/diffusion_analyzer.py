"""Diffusion analyzer (port of `inferix_tpu/profiling/diffusion_analyzer.py`):
records per-denoising-step and per-block metrics and model parameter counts
against a base profiler, then aggregates step / block statistics and emits
performance recommendations (get_step_analysis / get_model_analysis /
get_block_analysis / get_performance_recommendations / get_full_analysis).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional

from .profiler import InferixProfiler


class DiffusionAnalyzer:
    """Diffusion-specific metric aggregation over a base profiler."""

    def __init__(self, base_profiler: Optional[InferixProfiler] = None):
        self.base_profiler = base_profiler or InferixProfiler()
        self.diffusion_steps: List[Dict[str, Any]] = []
        self.model_parameters: Dict[str, Dict[str, Any]] = {}
        self.block_computations: List[Dict[str, Any]] = []

    # -- recording -----------------------------------------------------------

    def record_diffusion_step(self, step: int, timestep: float,
                              block_size: int, computation_time_ms: float,
                              guidance_scale: Optional[float] = None) -> None:
        data = {
            "step": step,
            "timestep": timestep,
            "block_size": block_size,
            "computation_time_ms": computation_time_ms,
            "guidance_scale": guidance_scale,
        }
        self.diffusion_steps.append(data)
        self.base_profiler.add_event("diffusion_step", **data)

    def record_model_parameters(self, model_name: str, parameters_count: int,
                                model_type: str) -> None:
        self.model_parameters[model_name] = {
            "parameters_count": parameters_count,
            "model_type": model_type,
        }
        self.base_profiler.add_event(
            "model_parameters", model_name=model_name,
            parameters_count=parameters_count, model_type=model_type)

    def record_block_computation(self, block_index: int, block_size: int,
                                 computation_time_ms: float,
                                 memory_usage_mb: float = 0.0) -> None:
        data = {
            "block_index": block_index,
            "block_size": block_size,
            "computation_time_ms": computation_time_ms,
            "memory_usage_mb": memory_usage_mb,
        }
        self.block_computations.append(data)
        self.base_profiler.record_block_computation(
            block_index, block_size, computation_time_ms)

    # -- aggregation ---------------------------------------------------------

    def get_step_analysis(self) -> Optional[Dict[str, Any]]:
        steps = self.diffusion_steps
        if not steps:
            return None
        times = [s["computation_time_ms"] for s in steps]
        return {
            "total_steps": len(steps),
            "total_time_ms": sum(times),
            "avg_computation_time_ms": sum(times) / len(steps),
            "min_computation_time_ms": min(times),
            "max_computation_time_ms": max(times),
            "avg_timestep": sum(s["timestep"] for s in steps) / len(steps),
            "avg_block_size": sum(s["block_size"] for s in steps) / len(steps),
            "steps_per_second": (
                1000.0 * len(steps) / sum(times) if sum(times) else 0.0),
        }

    def get_model_analysis(self) -> Optional[Dict[str, Any]]:
        if not self.model_parameters:
            return None
        total = sum(m["parameters_count"]
                    for m in self.model_parameters.values())
        return {
            "total_parameters": total,
            "models": dict(self.model_parameters),
            "largest_model": max(
                self.model_parameters,
                key=lambda k: self.model_parameters[k]["parameters_count"]),
        }

    def get_block_analysis(self) -> Optional[Dict[str, Any]]:
        blocks = self.block_computations
        if not blocks:
            return None
        times = [b["computation_time_ms"] for b in blocks]
        sizes = [b["block_size"] for b in blocks]
        mems = [b["memory_usage_mb"] for b in blocks]
        fps = [1000.0 * b["block_size"] / b["computation_time_ms"]
               for b in blocks if b["computation_time_ms"] > 0]
        return {
            "total_blocks": len(blocks),
            "total_time_ms": sum(times),
            "avg_computation_time_ms": sum(times) / len(blocks),
            "min_computation_time_ms": min(times),
            "max_computation_time_ms": max(times),
            "avg_block_size": sum(sizes) / len(blocks),
            "avg_memory_usage_mb": sum(mems) / len(blocks),
            "avg_frames_per_second": sum(fps) / len(fps) if fps else 0.0,
        }

    def get_performance_recommendations(self) -> List[Dict[str, str]]:
        recs: List[Dict[str, str]] = []
        step = self.get_step_analysis()
        if step:
            if step["avg_computation_time_ms"] > 500:
                recs.append({
                    "category": "diffusion_steps",
                    "issue": "slow denoising steps",
                    "recommendation": (
                        "average step exceeds 500 ms — consider quantized "
                        "linears, a smaller attention window, or fewer "
                        "denoising steps"),
                })
            spread = step["max_computation_time_ms"] - \
                step["min_computation_time_ms"]
            if step["avg_computation_time_ms"] and \
                    spread > 2 * step["avg_computation_time_ms"]:
                recs.append({
                    "category": "diffusion_steps",
                    "issue": "high step-time variance",
                    "recommendation": (
                        "step times vary widely — check for recompilation "
                        "(changing shapes) or host-device synchronization "
                        "inside the loop"),
                })
        block = self.get_block_analysis()
        if block:
            if block["avg_frames_per_second"] < 2.0 and block["total_blocks"]:
                recs.append({
                    "category": "block_computation",
                    "issue": "low block throughput",
                    "recommendation": (
                        "below 2 frames/s — profile the attention kernel "
                        "share (full-cache blocks dominate) and enable the "
                        "quantized serving path"),
                })
            if block["avg_memory_usage_mb"] > 12000:
                recs.append({
                    "category": "memory",
                    "issue": "high block memory",
                    "recommendation": (
                        "enable the int8 KV cache (halves cache HBM) or "
                        "free-cache-before-VAE"),
                })
        model = self.get_model_analysis()
        if model and model["total_parameters"] > 5e9:
            recs.append({
                "category": "model",
                "issue": "large parameter footprint",
                "recommendation": (
                    "consider fp8/int8 weight formats or layer offload for "
                    "models above 5B parameters"),
            })
        return recs

    def get_full_analysis(self) -> Dict[str, Any]:
        return {
            "steps": self.get_step_analysis(),
            "blocks": self.get_block_analysis(),
            "models": self.get_model_analysis(),
            "recommendations": self.get_performance_recommendations(),
        }
