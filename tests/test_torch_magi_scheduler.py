"""The port's MAGI chunk scheduler (`inferix_tpu_torch.models.magi.scheduler`)
against the JAX package's, on the host.

Both are numpy on the host, so every value is held equal exactly: the
window sequences, the t tables, the distill intervals, and over a whole
walk each step's window, timesteps, Euler deltas, kv ranges (with and
without the clean chunk), the clean-chunk re-forward flag and the chunk
that becomes clean. The reference examples are the ones
tests/test_magi.py holds the JAX scheduler to.
"""
import numpy as np
import pytest

from inferix_tpu.models.magi import scheduler as jsched
from inferix_tpu_torch.models.magi import scheduler as tsched


def test_generate_sequences_reference_examples():
    """The reference's docstring examples (video_generate.py:140-163)."""
    cs, ce, ts, te = tsched.generate_sequences(8, 4, 0)
    assert cs == [0, 0, 0, 0, 1, 2, 3, 4, 5, 6, 7]
    assert ce == [1, 2, 3, 4, 5, 6, 7, 8, 8, 8, 8]
    assert ts == [0, 0, 0, 0, 0, 0, 0, 0, 1, 2, 3]
    assert te == [1, 2, 3, 4, 4, 4, 4, 4, 4, 4, 4]
    cs, ce, ts, te = tsched.generate_sequences(8, 4, 2)
    assert cs == [2, 2, 2, 2, 3, 4, 5, 6, 7]
    assert ce == [3, 4, 5, 6, 7, 8, 8, 8, 8]
    assert ts == [0, 0, 0, 0, 0, 0, 1, 2, 3]
    assert te == [1, 2, 3, 4, 4, 4, 4, 4, 4]
    cs, ce, ts, te = tsched.generate_sequences(8, 1, 0)
    assert cs == list(range(8)) and ce == [i + 1 for i in range(8)] and te == [1] * 8


@pytest.mark.parametrize("args", [(8, 4, 0), (8, 4, 2), (5, 3, 1), (1, 1, 0), (4, 4, 0)])
def test_generate_sequences_matches_jax(args):
    assert tsched.generate_sequences(*args) == jsched.generate_sequences(*args)


@pytest.mark.parametrize("num_steps", [4, 12, 64])
@pytest.mark.parametrize("t_schedule", ["sd3", "square", "piecewise", "linear"])
@pytest.mark.parametrize("shortcut_mode", ["", "16,16,8"])
def test_init_t_and_interval_match_jax(num_steps, t_schedule, shortcut_mode):
    got = tsched.init_t(num_steps, t_schedule, 3.0, shortcut_mode)
    want = jsched.init_t(num_steps, t_schedule, 3.0, shortcut_mode)
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(tsched.init_interval(num_steps, shortcut_mode),
                                  jsched.init_interval(num_steps, shortcut_mode))


def test_init_t_sd3():
    t = tsched.init_t(64, "sd3", shift=3.0)
    assert t.shape == (65,) and t[0] == 0.0 and abs(t[-1] - 1.0) < 1e-9
    assert np.all(np.diff(t) >= 0) and t[32] < 0.5


WALKS = {
    "4p5b": dict(chunk_num=4, window_size=4, num_steps=4, chunk_width=6,
                 noise2clean_kvrange=[5, 4, 3, 2], clean_chunk_kvrange=1),
    "default": dict(chunk_num=6, window_size=3, num_steps=6, chunk_width=2),
    "offset": dict(chunk_num=7, window_size=2, num_steps=4, chunk_offset=2,
                   noise2clean_kvrange=[3, 1], clean_chunk_kvrange=2),
    "shortcut": dict(chunk_num=3, window_size=3, num_steps=12, shortcut_mode="16,16,8",
                     t_schedule="piecewise"),
}


@pytest.mark.parametrize("name", sorted(WALKS))
def test_chunk_schedule_walk_matches_jax(name):
    """Every step of a walk: window, timesteps, deltas, kv ranges, the
    clean-chunk flag and the chunk that becomes clean, all equal."""
    got = tsched.ChunkSchedule(tsched.MagiScheduleConfig(**WALKS[name]))
    want = jsched.ChunkSchedule(jsched.MagiScheduleConfig(**WALKS[name]))
    assert got.total_forward_steps == want.total_forward_steps
    assert got.steps_per_stage == want.steps_per_stage
    np.testing.assert_array_equal(got.t_total, want.t_total)
    np.testing.assert_array_equal(got.interval, want.interval)
    for step in range(got.total_forward_steps):
        assert got.stage_of(step) == want.stage_of(step)
        assert got.window(step) == want.window(step)
        assert got.fwd_extra_1st_chunk(step) == want.fwd_extra_1st_chunk(step)
        for offset in (0, 1):
            np.testing.assert_array_equal(got.timesteps(step, offset),
                                          want.timesteps(step, offset))
        np.testing.assert_array_equal(got.integrate_deltas(step), want.integrate_deltas(step))
        for clean in (False, True):
            a, b = got.kv_ranges(step, clean), want.kv_ranges(step, clean)
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)
        assert got.mark_integrated(step) == want.mark_integrated(step)
    np.testing.assert_array_equal(got.chunk_denoise_count, want.chunk_denoise_count)


def test_schedule_denoise_accounting():
    sched = tsched.ChunkSchedule(tsched.MagiScheduleConfig(
        chunk_num=4, window_size=2, num_steps=4, chunk_width=2))
    clean = [c for c in (sched.mark_integrated(s) for s in range(sched.total_forward_steps))
             if c is not None]
    assert clean == [0, 1, 2, 3] and (sched.chunk_denoise_count == 4).all()


def test_kv_ranges_policies():
    sched = tsched.ChunkSchedule(tsched.MagiScheduleConfig(
        chunk_num=6, window_size=3, num_steps=6, chunk_width=2,
        noise2clean_kvrange=[3, 2, 1], clean_chunk_kvrange=1))
    step = 2 * sched.steps_per_stage
    c_start, c_end, _, _ = sched.window(step)
    ranges = sched.kv_ranges(step, include_clean=False)
    assert ranges.shape == (c_end - c_start, 2)
    for i, (lo, hi) in enumerate(ranges):
        assert hi == c_start + i + 1 and 0 <= lo < hi
    full = tsched.ChunkSchedule(tsched.MagiScheduleConfig(
        chunk_num=6, window_size=3, num_steps=6, chunk_width=2))
    assert (full.kv_ranges(step, include_clean=False)[:, 0] == 0).all()


def test_4p5b_walk_shape():
    """The walk chip_smoke.py drives at MAGI-4.5B: 7 window forwards of
    1, 2, 3, 4, 4, 3, 2 chunks (the last three with the clean chunk in
    front), no span past 5 chunks."""
    sched = tsched.ChunkSchedule(tsched.MagiScheduleConfig(**WALKS["4p5b"]))
    sizes = []
    for step in range(sched.total_forward_steps):
        c_start, c_end, _, _ = sched.window(step)
        extra = sched.fwd_extra_1st_chunk(step)
        r = sched.kv_ranges(step, extra)
        assert (r[:, 1] - r[:, 0]).max() <= 5
        sizes.append(c_end - c_start + extra)
    assert sizes == [1, 2, 3, 4, 4, 3, 2]
