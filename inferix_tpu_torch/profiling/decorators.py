"""Profiling decorators (port of `inferix_tpu/profiling/decorators.py`):
@profile_method / @profile_session / @profile_stage / @profile_block /
@add_profiling_event. Each looks up a profiler on the bound object
(`self.profiler` / `self._profiler`) or takes an explicit one; no-ops when
profiling is disabled or absent. @profile_block waits for the profiler's
device before it reads the clock, so a block's time is the card's."""
from __future__ import annotations

import functools
import time
from typing import Any, Callable, Optional

from .profiler import InferixProfiler


def _find_profiler(args, explicit: Optional[InferixProfiler]):
    if explicit is not None:
        return explicit
    if args:
        obj = args[0]
        for attr in ("profiler", "_profiler"):
            p = getattr(obj, attr, None)
            if isinstance(p, InferixProfiler):
                return p
    return None


def profile_stage(name: Optional[str] = None,
                  profiler: Optional[InferixProfiler] = None):
    def deco(fn: Callable) -> Callable:
        stage_name = name or fn.__name__

        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            p = _find_profiler(args, profiler)
            if p is None:
                return fn(*args, **kwargs)
            with p.stage(stage_name):
                return fn(*args, **kwargs)

        return wrapper

    return deco


profile_method = profile_stage  # alias matching the reference naming


def profile_session(name: Optional[str] = None,
                    profiler: Optional[InferixProfiler] = None):
    def deco(fn: Callable) -> Callable:
        session_name = name or fn.__name__

        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            p = _find_profiler(args, profiler)
            if p is None:
                return fn(*args, **kwargs)
            p.start_session(session_name)
            try:
                return fn(*args, **kwargs)
            finally:
                p.end_session()

        return wrapper

    return deco


def profile_block(profiler: Optional[InferixProfiler] = None):
    """Record each call as a block computation (frames inferred from the
    result's second axis when present)."""

    def deco(fn: Callable) -> Callable:
        counter = {"i": 0}

        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            p = _find_profiler(args, profiler)
            if p is not None:
                p.sync()
            t0 = time.perf_counter()
            out = fn(*args, **kwargs)
            if p is not None:
                p.sync()
                # frames from the first array-like result's second axis;
                # tuples (latents, cache) unwrap, 1-D/scalar outputs and
                # non-arrays record 1 instead of crashing the pipeline
                probe = out[0] if isinstance(out, tuple) and out else out
                shape = getattr(probe, "shape", None)
                frames = shape[1] if shape is not None and len(shape) > 1 \
                    else 1
                p.record_block_computation(
                    counter["i"], frames, (time.perf_counter() - t0) * 1e3
                )
                counter["i"] += 1
            return out

        return wrapper

    return deco


def add_profiling_event(name: str, **data):
    def deco(fn: Callable) -> Callable:
        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            p = _find_profiler(args, None)
            if p is not None:
                p.add_event(name, **data)
            return fn(*args, **kwargs)

        return wrapper

    return deco
