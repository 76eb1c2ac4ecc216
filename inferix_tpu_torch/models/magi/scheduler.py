"""MAGI chunk-windowed AR-diffusion scheduler (port of
`inferix_tpu/models/magi/scheduler.py`, host-side numpy, copied: the port
imports nothing of the JAX package).

Parity with the reference `SampleTransport` and helpers
(`inferix/pipeline/magi/video_generate.py:35-769`):
* `generate_sequences` windowed chunk schedule (:166-182)
* t-schedules sd3 / square / piecewise with shortcut-mode step lists (:185-224)
* per-chunk kv-range policies: default full-prefix vs `noise2clean_kvrange`
  shrinking windows + clean_chunk_kvrange (:456-529)
* per-chunk denoise counting and the Euler deltas of a window step.

All schedule math is host-side numpy (static per config); only the window
forward (`models.magi.dit`) runs on the device.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import numpy as np


def generate_sequences(chunk_num: int, window_size: int, chunk_offset: int
                       ) -> Tuple[List[int], List[int], List[int], List[int]]:
    """Windowed chunk schedule (reference video_generate.py:166-182)."""
    start_index = chunk_offset
    end_index = chunk_num + window_size - 1
    clip_start = [max(chunk_offset, i - window_size + 1)
                  for i in range(start_index, end_index)]
    clip_end = [min(chunk_num, i + 1) for i in range(start_index, end_index)]
    t_start = [max(0, i - chunk_num + 1) for i in range(start_index, end_index)]
    t_end = [
        min(window_size, i - chunk_offset + 1)
        if i - chunk_offset < window_size else window_size
        for i in range(start_index, end_index)
    ]
    return clip_start, clip_end, t_start, t_end


def init_t(num_steps: int, t_schedule: str = "sd3", shift: float = 3.0,
           shortcut_mode: str = "") -> np.ndarray:
    """Timestep table [num_steps + 1] in [0, 1], 0=noise (reference init_t,
    video_generate.py:185-224)."""
    if num_steps == 12:
        base_t = np.linspace(0, 1, 5)[: 5] / 4
        accu = np.linspace(0, 1, 5)
        if shortcut_mode == "16,16,8":
            base_t = base_t[:3]
        else:
            base_t = np.concatenate([base_t[:1], base_t[2:4]])
        t = np.concatenate([base_t + a for a in accu])[: num_steps + 1]
    else:
        t = np.linspace(0, 1, num_steps + 1)
    if t_schedule == "sd3":
        t = t**2
        shift_inv = 1.0 / shift
        t = shift_inv * t / (1 + (shift_inv - 1) * t)
    elif t_schedule == "square":
        t = t**2
    elif t_schedule == "piecewise":
        mask = t < 0.875
        t = np.where(mask, t * (0.5 / 0.875), 0.5 + (t - 0.875) * (0.5 / 0.125))
    return t.astype(np.float64)


def init_interval(num_steps: int, shortcut_mode: str = "") -> np.ndarray:
    base = np.ones(num_steps)
    if num_steps % 3 == 0:
        rep = num_steps // 3
        if shortcut_mode == "16,16,8":
            base = np.array([1, 1, 2] * rep)
        else:
            base = np.array([2, 1, 1] * rep)
    return base


@dataclasses.dataclass
class MagiScheduleConfig:
    chunk_num: int
    chunk_width: int = 6
    window_size: int = 4
    num_steps: int = 64
    chunk_offset: int = 0          # prefix-video chunks (I2V/V2V)
    t_schedule: str = "sd3"
    t_shift: float = 3.0
    shortcut_mode: str = ""
    noise2clean_kvrange: Sequence[int] = ()
    clean_chunk_kvrange: int = -1
    clean_t: float = 0.9999


class ChunkSchedule:
    """Host-side schedule state for one stream; the device forward is
    injected by the pipeline."""

    def __init__(self, cfg: MagiScheduleConfig):
        self.cfg = cfg
        assert cfg.num_steps % cfg.window_size == 0
        self.steps_per_stage = cfg.num_steps // cfg.window_size
        self.t_total = init_t(cfg.num_steps, cfg.t_schedule, cfg.t_shift,
                              cfg.shortcut_mode)
        # per-substep distill interval (reference init_interval ->
        # time_interval[denoise_idx], video_generate.py:68-76,651)
        self.interval = init_interval(cfg.num_steps, cfg.shortcut_mode)
        (self.clip_start, self.clip_end,
         self.t_start, self.t_end) = generate_sequences(
            cfg.chunk_num, cfg.window_size, cfg.chunk_offset)
        self.chunk_denoise_count = np.zeros(cfg.chunk_num, np.int64)

    @property
    def total_forward_steps(self) -> int:
        return self.steps_per_stage * (
            self.cfg.chunk_num + self.cfg.window_size - 1 - self.cfg.chunk_offset
        )

    def stage_of(self, step: int) -> Tuple[int, int]:
        return step // self.steps_per_stage, step % self.steps_per_stage

    def window(self, step: int) -> Tuple[int, int, int, int]:
        """(chunk_start, chunk_end, t_start, t_end) for a denoise step."""
        stage, _ = self.stage_of(step)
        return (self.clip_start[stage], self.clip_end[stage],
                self.t_start[stage], self.t_end[stage])

    def timesteps(self, step: int, offset: int = 0) -> np.ndarray:
        """Per-window-chunk t values at denoise substep `step` (+offset for
        the post-integration time). Chunk j of the window (j indexes t_end-1
        .. t_start stages) has completed a different number of substeps —
        reference get_timestep."""
        stage, idx = self.stage_of(step)
        c_start, c_end, t_s, t_e = self.window(step)
        ts = []
        # window chunk i (i=0 oldest) is at stage (t_e - 1 - i) within its own
        # denoising; its global step index:
        for i in range(c_end - c_start):
            stage_of_chunk = t_e - 1 - i
            global_idx = stage_of_chunk * self.steps_per_stage + idx + offset
            global_idx = min(global_idx, self.cfg.num_steps)
            ts.append(self.t_total[global_idx])
        return np.asarray(ts)

    def fwd_extra_1st_chunk(self, step: int) -> bool:
        c_start, _, _, _ = self.window(step)
        _, idx = self.stage_of(step)
        return c_start > self.cfg.chunk_offset and idx == 0

    def kv_ranges(self, step: int, include_clean: bool) -> np.ndarray:
        """[n_chunks, 2] chunk-granular [start, end) ranges (reference
        generate_kvrange_for_denoising_video :456-529). Default: full prefix
        [0, chunk_idx+1). noise2clean: chunk at denoise-stage s attends back
        noise2clean_kvrange[s] chunks; clean chunks use clean_chunk_kvrange."""
        cfg = self.cfg
        c_start, c_end, t_s, t_e = self.window(step)
        ranges = []
        if include_clean:
            # the prepended clean chunk (index c_start - 1)
            idx = c_start - 1
            if cfg.clean_chunk_kvrange > 0:
                lo = max(0, idx + 1 - cfg.clean_chunk_kvrange)
            else:
                lo = 0
            ranges.append((lo, idx + 1))
        for i, chunk_idx in enumerate(range(c_start, c_end)):
            stage_of_chunk = t_e - 1 - i
            if len(cfg.noise2clean_kvrange) > 0:
                s = min(stage_of_chunk, len(cfg.noise2clean_kvrange) - 1)
                span = cfg.noise2clean_kvrange[s]
                lo = max(0, chunk_idx + 1 - span)
            else:
                lo = 0
            ranges.append((lo, chunk_idx + 1))
        return np.asarray(ranges, np.int32)

    def integrate_deltas(self, step: int) -> np.ndarray:
        """Euler delta_t per window chunk (t_after - t_before)."""
        before = self.timesteps(step)
        after = self.timesteps(step, offset=1)
        return after - before

    def mark_integrated(self, step: int) -> Optional[int]:
        """Update denoise counts; returns the chunk index that just became
        clean (completed num_steps), else None."""
        c_start, c_end, _, _ = self.window(step)
        for ci in range(c_start, c_end):
            self.chunk_denoise_count[ci] += 1
        if self.chunk_denoise_count[c_start] == self.cfg.num_steps:
            return c_start
        return None
