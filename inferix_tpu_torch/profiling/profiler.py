"""Profiling sessions: stages, events, block / diffusion-step / streaming
records, memory samples, time to the first block, JSON and HTML reports
(port of `inferix_tpu/profiling/profiler.py`).

The summary keys and report files are the JAX package's, so the readers in
this package (`extract_metrics`, `diffusion_analyzer`) and dashboards built on
the JAX reports read both. Three things differ, each for the card:
- `sample_memory` reads `torch.cuda.memory_stats(device)` (allocated bytes,
  current and peak) under the JAX keys `bytes_in_use` and
  `peak_bytes_in_use`; without a CUDA device it records zeros, as the JAX
  package does where its device reports no memory stats;
- `capture_jax_trace` keeps its name, so config dicts carry across, and
  captures a `torch.profiler` trace (host and, on the card, CUDA activity)
  into `jax_trace_dir` as a Chrome trace;
- the clock: a CUDA stream runs behind the host, so the pipelines record a
  block's and a step's time from spans (below) and the profiler reads their
  card times when the session or the walk ends (`record_block_spans`,
  `record_step_spans`, `resolve`): one wait then, and one synchronize for
  the spans' origin where none is fresh; none a block or a step. The JAX
  package reads the host clock without a sync.

Spans: `span(name, **attrs)` marks a named, nested interval of the program
(`semi_ar.block`, `dit.forward`, `dit.text`, `vae.decode` on the Wan path),
and `spans()` reads them back. A span holds its id, its parent's (the
innermost span open), its attrs, its host start and end
(`time.perf_counter_ns`) and, where CUDA is in use, two CUDA events recorded
on the current stream. Their device times are placed on the host's
perf_counter scale by one origin event, recorded just after a
`torch.cuda.synchronize()` by the first span of a trace, and are resolved
only when `spans()` is read; without CUDA they are the host times. Spans
record while a `torch.profiler` session runs or an enabled
`InferixProfiler` session is open. Otherwise `span()` reads two flags and
returns a shared no-op context: no torch call, no event, no synchronize.
They carry no `record_function`, so no profiler annotation of theirs lands
among a trace's device events.
"""
from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import time
from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch
import torch.autograd.profiler as _torch_profiler

# the store keeps this many spans and counts the ones past it as dropped
MAX_SPANS = 100_000
# cudaEventElapsedTime is float32 milliseconds: a minute from its origin
# it resolves ~8 us, so a span opened later than this takes a new origin
ORIGIN_MAX_S = 60.0


class Span:
    """One span. host: (start, end) in time.perf_counter seconds; device:
    the same of its CUDA events (of its host times without CUDA), set when
    the store resolves it."""

    __slots__ = ("id", "parent", "name", "attrs", "start_ns", "end_ns", "device",
                 "_events", "_origin")

    def __init__(self, name: str, attrs: Dict[str, Any]):
        self.name, self.attrs = name, attrs
        self.id = self.parent = self.start_ns = self.end_ns = None
        self.device: Optional[Tuple[float, float]] = None
        self._events = self._origin = None

    @property
    def host(self) -> Tuple[float, float]:
        return self.start_ns / 1e9, self.end_ns / 1e9

    def __enter__(self) -> "Span":
        STORE.enter(self)
        return self

    def __exit__(self, *exc) -> bool:
        STORE.exit(self)
        self.end_ns = time.perf_counter_ns()
        return False


# the shared context `span()` returns while recording is off
_NOOP = contextlib.nullcontext()


class SpanStore:
    """The process's spans, in the order they opened, at most `limit`."""

    def __init__(self, limit: int = MAX_SPANS):
        self.limit = limit
        # enabled InferixProfiler sessions open: recording is on while > 0
        self.sessions = 0
        self.reset()

    def reset(self) -> None:
        self.spans: List[Span] = []
        self.dropped = 0
        self._next_id = 0
        self._open: List[Span] = []   # the spans open, innermost last
        self._unresolved: List[Span] = []
        self._last: Dict[str, Span] = {}
        self._origins: Dict[int, Tuple[Any, float]] = {}

    def origin(self, device: int) -> Tuple[Any, float]:
        """(CUDA event, its perf_counter time) of `device`'s origin: a new
        one, after a synchronize, where there is none or it is old."""
        o = self._origins.get(device)
        if o is None or time.perf_counter() - o[1] > ORIGIN_MAX_S:
            torch.cuda.synchronize(device)
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            o = self._origins[device] = (ev, time.perf_counter())
        return o

    def enter(self, sp: Span) -> None:
        sp.id, sp.parent = self._next_id, self._open[-1].id if self._open else None
        self._next_id += 1
        self._open.append(sp)
        if len(self.spans) < self.limit:
            self.spans.append(sp)
            self._unresolved.append(sp)
        else:
            self.dropped += 1
        if torch.cuda.is_initialized():
            sp._origin = self.origin(torch.cuda.current_device())
            sp.start_ns = time.perf_counter_ns()
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            sp._events = (ev, None)
        else:
            sp.start_ns = time.perf_counter_ns()

    def exit(self, sp: Span) -> None:
        if sp._events is not None:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            sp._events = (sp._events[0], ev)
        if sp in self._open:  # and any span left open inside it
            del self._open[len(self._open) - 1 - self._open[::-1].index(sp):]
        self._last[sp.name] = sp

    def last(self, name: str) -> Optional[Span]:
        """The span named `name` that closed last, or None."""
        return self._last.get(name)

    def resolve(self, spans: Optional[Sequence[Span]] = None) -> None:
        """Device times of the closed spans given (default: every stored
        span not yet resolved), waiting for the device where their events
        have not passed; their events go."""
        keep = []
        for sp in self._unresolved if spans is None else spans:
            if sp.device is not None:
                continue
            if sp.end_ns is None:
                keep.append(sp)
            elif sp._events is None:
                sp.device = sp.host
            else:
                (ev0, ev1), (origin, t0) = sp._events, sp._origin
                ev1.synchronize()
                sp.device = (t0 + origin.elapsed_time(ev0) / 1e3,
                             t0 + origin.elapsed_time(ev1) / 1e3)
                sp._events = sp._origin = None
        if spans is None:
            self._unresolved = keep


STORE = SpanStore()


def span(name: str, **attrs: Any):
    """A span of the program (a context manager whose `as` target is the
    `Span`), recorded while tracing is on; else the shared no-op, whose
    target is None."""
    if _torch_profiler._is_profiler_enabled or STORE.sessions:
        return Span(name, attrs)
    return _NOOP


def spans(since: Optional[float] = None, until: Optional[float] = None) -> List[Span]:
    """The stored spans that have closed, in the order they opened, whose
    host start lies in [since, until] (perf_counter seconds), their device
    times resolved."""
    STORE.resolve()
    lo = None if since is None else int(since * 1e9)
    hi = None if until is None else int(until * 1e9)
    return [sp for sp in STORE.spans if sp.end_ns is not None
            and (lo is None or sp.start_ns >= lo) and (hi is None or sp.start_ns <= hi)]


@dataclasses.dataclass
class ProfilingConfig:
    enabled: bool = True
    output_dir: str = "profiling_reports"
    report_format: str = "both"  # "json" | "html" | "both"
    capture_jax_trace: bool = False
    jax_trace_dir: Optional[str] = None
    max_data_points: int = 10000

    def __post_init__(self):
        if self.report_format not in ("json", "html", "both"):
            raise ValueError(f"bad report_format {self.report_format!r}")


@dataclasses.dataclass
class StageRecord:
    name: str
    start: float
    end: float = 0.0

    @property
    def duration_ms(self) -> float:
        return (self.end - self.start) * 1e3


class InferixProfiler:
    """Session-scoped profiler threaded through pipelines by injection
    (reference pattern: `base_pipeline.py:43-53`)."""

    def __init__(self, config: Optional[ProfilingConfig] = None,
                 device: Optional[str | torch.device] = None):
        self.config = config or ProfilingConfig()
        # the device whose memory `sample_memory` reads (a pipeline sets its
        # own); None or a CPU device: no device
        self.device = None if device is None else torch.device(device)
        # whether this profiler holds the span store on (an open session)
        self._holds_store = False
        self.reset()

    def reset(self) -> None:
        self.session_name: Optional[str] = None
        self.session_tags: Dict[str, Any] = {}
        self.session_start: float = 0.0
        self.session_end: float = 0.0
        self.stages: List[StageRecord] = []
        self.events: List[Dict[str, Any]] = []
        self.diffusion_steps: List[Dict[str, Any]] = []
        self.blocks: List[Dict[str, Any]] = []
        self.streaming: List[Dict[str, Any]] = []
        self.memory_samples: List[Dict[str, Any]] = []
        self._first_block_time: Optional[float] = None
        # records whose time_ms their spans give: (record, first, last)
        self._pending: List[Tuple[Dict[str, Any], Span, Span]] = []
        self._first_block_span: Optional[Span] = None
        self._trace_ctx = None
        self._trace_dir: Optional[str] = None

    # -- session ------------------------------------------------------------

    def start_session(self, name: str, **tags: Any) -> None:
        if not self.config.enabled:
            return
        if self._trace_ctx is not None:
            # a previous session never ended (exception skipped
            # end_session, or back-to-back sessions): finalize its trace
            # before reset() drops the handle: a leaked live trace makes the
            # next torch.profiler session raise and loses the first file
            try:
                self._stop_trace()
            except Exception:
                pass
        self.reset()
        if not self._holds_store:
            STORE.sessions += 1
            self._holds_store = True
        self.session_name = name
        self.session_tags = tags
        self.session_start = time.perf_counter()
        if self.config.capture_jax_trace:
            trace_dir = self.config.jax_trace_dir or os.path.join(
                self.config.output_dir, "jax_trace"
            )
            os.makedirs(trace_dir, exist_ok=True)
            activities = [torch.profiler.ProfilerActivity.CPU]
            if self._cuda():
                activities.append(torch.profiler.ProfilerActivity.CUDA)
            self._trace_dir = trace_dir
            self._trace_ctx = torch.profiler.profile(activities=activities)
            self._trace_ctx.__enter__()

    def end_session(self) -> Optional[Dict[str, Any]]:
        if not self.config.enabled or self.session_name is None:
            return None
        self.session_end = time.perf_counter()
        if self._holds_store:
            STORE.sessions -= 1
            self._holds_store = False
        if self._trace_ctx is not None:
            self._stop_trace()
        # the session's spans read once, their CUDA events released
        STORE.resolve()
        return self.summary()

    def _stop_trace(self) -> None:
        ctx, self._trace_ctx = self._trace_ctx, None
        ctx.__exit__(None, None, None)
        ctx.export_chrome_trace(os.path.join(
            self._trace_dir, f"{self.session_name}.trace.json"))

    def _cuda(self) -> bool:
        return self.device is not None and self.device.type == "cuda"

    # -- recording ----------------------------------------------------------

    def span(self, name: str, **attrs: Any):
        """A span of the store while profiling is enabled, session or not
        (`span` otherwise); its `as` target is what `record_block_spans`
        and `record_step_spans` take."""
        return Span(name, attrs) if self.config.enabled else span(name, **attrs)

    @contextlib.contextmanager
    def stage(self, name: str):
        if not self.config.enabled:
            yield
            return
        rec = StageRecord(name=name, start=time.perf_counter())
        try:
            yield
        finally:
            rec.end = time.perf_counter()
            self.stages.append(rec)

    def add_event(self, name: str, **data: Any) -> None:
        if self.config.enabled and len(self.events) < self.config.max_data_points:
            self.events.append(
                {"name": name, "t": time.perf_counter(), **data}
            )

    def record_diffusion_step(self, step: int, timestep: float,
                              block_size: int, computation_time_ms: float,
                              guidance_scale: Optional[float] = None) -> None:
        if self.config.enabled:
            self.diffusion_steps.append({
                "step": step, "timestep": timestep, "block_size": block_size,
                "time_ms": computation_time_ms, "guidance": guidance_scale,
            })

    def record_block_computation(self, block_index: int, block_size: int,
                                 computation_time_ms: float,
                                 memory_usage_mb: float = 0.0) -> None:
        if not self.config.enabled:
            return
        self.blocks.append({
            "block": block_index, "frames": block_size,
            "time_ms": computation_time_ms, "memory_mb": memory_usage_mb,
        })
        if self._first_block_time is None:
            self._first_block_time = time.perf_counter() - self.session_start

    def record_step_spans(self, step: int, timestep: float, block_size: int,
                          first: Optional[Span], last: Optional[Span] = None,
                          guidance_scale: Optional[float] = None) -> None:
        """`record_diffusion_step` whose time is the card's, from the start
        of span `first` to the end of `last` (default: `first`), filled in
        by `resolve`."""
        if self.config.enabled and first is not None:
            rec = {"step": step, "timestep": timestep, "block_size": block_size,
                   "time_ms": None, "guidance": guidance_scale}
            self.diffusion_steps.append(rec)
            self._pending.append((rec, first, last or first))

    def record_block_spans(self, block_index: int, block_size: int,
                           first: Optional[Span], last: Optional[Span] = None,
                           memory_usage_mb: float = 0.0) -> None:
        """`record_block_computation` whose time is the card's, as
        `record_step_spans`; the time to the first block runs from the
        session's start to the end of its `last` on the card."""
        if not self.config.enabled or first is None:
            return
        rec = {"block": block_index, "frames": block_size, "time_ms": None,
               "memory_mb": memory_usage_mb}
        self.blocks.append(rec)
        self._pending.append((rec, first, last or first))
        if self._first_block_time is None and self._first_block_span is None:
            self._first_block_span = last or first

    def resolve(self) -> None:
        """The time_ms of the records made from spans: waits once for the
        device where their spans' events have not passed."""
        if not self._pending:
            return
        STORE.resolve([sp for _, a, b in self._pending for sp in (a, b)])
        for rec, a, b in self._pending:
            rec["time_ms"] = (b.device[1] - a.device[0]) * 1e3
        self._pending = []
        if self._first_block_span is not None:
            self._first_block_time = self._first_block_span.device[1] - self.session_start
            self._first_block_span = None

    def record_streaming(self, frames: int, latency_ms: float) -> None:
        if self.config.enabled:
            self.streaming.append({"frames": frames, "latency_ms": latency_ms})

    def sample_memory(self) -> None:
        if not self.config.enabled:
            return
        stats = torch.cuda.memory_stats(self.device) if self._cuda() else {}
        self.memory_samples.append({
            "t": time.perf_counter() - self.session_start,
            "bytes_in_use": stats.get("allocated_bytes.all.current", 0),
            "peak_bytes_in_use": stats.get("allocated_bytes.all.peak", 0),
        })

    # -- reporting ----------------------------------------------------------

    @property
    def time_to_first_block_s(self) -> Optional[float]:
        self.resolve()
        return self._first_block_time

    def summary(self) -> Dict[str, Any]:
        self.resolve()
        total_s = (self.session_end or time.perf_counter()) - self.session_start
        block_times = [b["time_ms"] for b in self.blocks]
        frames = sum(b["frames"] for b in self.blocks)
        stage_totals: Dict[str, float] = {}
        for s in self.stages:
            stage_totals[s.name] = stage_totals.get(s.name, 0.0) + s.duration_ms
        summary = {
            "session": self.session_name,
            "tags": self.session_tags,
            "total_s": total_s,
            "stages_ms": stage_totals,
            "num_blocks": len(self.blocks),
            "frames": frames,
            "avg_block_ms": (sum(block_times) / len(block_times))
            if block_times else None,
            "p50_block_ms": sorted(block_times)[len(block_times) // 2]
            if block_times else None,
            "frames_per_s": frames / total_s if total_s > 0 and frames else None,
            "time_to_first_block_s": self._first_block_time,
            "avg_step_ms": (
                sum(d["time_ms"] for d in self.diffusion_steps)
                / len(self.diffusion_steps)
            ) if self.diffusion_steps else None,
            "peak_memory_bytes": max(
                (m["peak_bytes_in_use"] for m in self.memory_samples),
                default=None,
            ),
            "recommendations": self._recommend(),
        }
        return summary

    def _recommend(self) -> List[str]:
        recs = []
        if self.blocks:
            times = [b["time_ms"] for b in self.blocks]
            if max(times) > 2.5 * min(times):
                recs.append(
                    "block latency varies >2.5x — early blocks are cheaper "
                    "(partial KV cache); consider reporting steady-state only"
                )
        if self._first_block_time and self._first_block_time > 5.0:
            recs.append(
                "time-to-first-block > 5s — check compilation caching / "
                "prefill cost"
            )
        return recs

    def save_report(self, rank: int = 0) -> List[str]:
        if not self.config.enabled or self.session_name is None:
            return []
        os.makedirs(self.config.output_dir, exist_ok=True)
        base = os.path.join(
            self.config.output_dir, f"{self.session_name}_rank{rank}"
        )
        paths = []
        data = {
            "summary": self.summary(),
            "stages": [dataclasses.asdict(s) for s in self.stages],
            "blocks": self.blocks,
            "diffusion_steps": self.diffusion_steps,
            "streaming": self.streaming,
            "memory": self.memory_samples,
            "events": self.events,
        }
        if self.config.report_format in ("json", "both"):
            p = base + ".json"
            with open(p, "w") as f:
                json.dump(data, f, indent=2)
            paths.append(p)
        if self.config.report_format in ("html", "both"):
            p = base + ".html"
            with open(p, "w") as f:
                f.write(_render_html(data))
            paths.append(p)
        return paths


def aggregate_reports(paths: List[str]) -> Dict[str, Any]:
    """Merge per-host JSON reports (reference `aggregate_reports.py`)."""
    reports = []
    for p in paths:
        with open(p) as f:
            reports.append(json.load(f))
    if not reports:
        return {}
    keys = ("total_s", "avg_block_ms", "frames_per_s", "time_to_first_block_s")
    agg: Dict[str, Any] = {"num_ranks": len(reports)}
    for k in keys:
        vals = [r["summary"].get(k) for r in reports
                if r["summary"].get(k) is not None]
        if vals:
            agg[k] = {"min": min(vals), "max": max(vals),
                      "avg": sum(vals) / len(vals)}
    return agg


def _fmt(v: Any) -> str:
    if v is None:
        return "—"
    if isinstance(v, float):
        return f"{v:,.3g}" if abs(v) < 1000 else f"{v:,.0f}"
    return str(v)


def _svg_line(points: List[float], xs: Optional[List[float]] = None,
              width: int = 640, height: int = 120, unit: str = "",
              labels: Optional[List[str]] = None) -> str:
    """Single-series line: 2px stroke, >=8px hover targets with native
    <title> tooltips, recessive grid, text in ink tokens (no legend — the
    section heading names the one series)."""
    if len(points) < 2:
        return ""
    xs = xs if xs is not None else list(range(len(points)))
    lo, hi = min(points), max(points)
    span = (hi - lo) or 1.0
    x0, x1 = min(xs), max(xs)
    xspan = (x1 - x0) or 1.0
    pad, ph = 6, height - 12
    px = [pad + (x - x0) / xspan * (width - 2 * pad) for x in xs]
    py = [6 + (1 - (p - lo) / span) * (ph - 12) for p in points]
    path = " ".join(f"{'M' if i == 0 else 'L'}{x:.1f},{y:.1f}"
                    for i, (x, y) in enumerate(zip(px, py)))
    dots = "".join(
        f'<circle cx="{x:.1f}" cy="{y:.1f}" r="8" fill="transparent">'
        f"<title>{labels[i] if labels else ''}"
        f"{points[i]:,.1f}{unit}</title></circle>"
        f'<circle cx="{x:.1f}" cy="{y:.1f}" r="2.5" class="mk"/>'
        for i, (x, y) in enumerate(zip(px, py)))
    grid = "".join(
        f'<line x1="{pad}" y1="{6 + f * (ph - 12):.1f}" x2="{width - pad}"'
        f' y2="{6 + f * (ph - 12):.1f}" class="grid"/>'
        for f in (0.0, 0.5, 1.0))
    return (f'<svg viewBox="0 0 {width} {height}" role="img">{grid}'
            f'<path d="{path}" class="ln" fill="none"/>{dots}'
            f'<text x="{pad}" y="{height - 1}" class="ax">{_fmt(lo)}{unit}'
            f' – {_fmt(hi)}{unit}</text></svg>')


def _bar_list(items: List[tuple], unit: str = "ms") -> str:
    """Horizontal single-hue magnitude bars with direct labels (text ink),
    4px rounded data ends, 2px row gap."""
    if not items:
        return ""
    top = max(v for _, v in items) or 1.0
    rows = []
    for name, v in sorted(items, key=lambda kv: -kv[1]):
        w = max(0.5, v / top * 100)
        rows.append(
            f'<div class="br"><span class="bn">{name}</span>'
            f'<span class="bt"><span class="bf" style="width:{w:.1f}%">'
            f"</span></span>"
            f'<span class="bv">{v:,.1f} {unit}</span></div>')
    return '<div class="bars">' + "".join(rows) + "</div>"


def _render_html(data: Dict[str, Any]) -> str:
    """Full HTML report (reference `profiling/reporter.py:11-1268` feature
    set: summary tiles, stage timing with share-of-total bars, block/
    diffusion/streaming/memory analyses, recommendations, first-block
    delay). Self-contained — inline CSS/SVG, no external assets; light and
    dark render from the same single-hue palette."""
    s = data["summary"]
    total_ms = (s.get("total_s") or 0) * 1000

    tiles = "".join(
        f'<div class="tile"><div class="tv">{_fmt(v)}</div>'
        f'<div class="tl">{label}</div></div>'
        for label, v in (
            ("frames / s", s.get("frames_per_s")),
            ("time to first block (s)", s.get("time_to_first_block_s")),
            ("avg block (ms)", s.get("avg_block_ms")),
            ("p50 block (ms)", s.get("p50_block_ms")),
            ("avg step (ms)", s.get("avg_step_ms")),
            ("frames", s.get("frames")),
            ("total (s)", s.get("total_s")),
            ("peak mem (GiB)",
             (s.get("peak_memory_bytes") or 0) / 2**30 or None),
        ))

    stage_items = list((s.get("stages_ms") or {}).items())
    stage_rows = "".join(
        f"<tr><td>{k}</td><td>{v:,.1f}</td>"
        f"<td>{(v / total_ms * 100) if total_ms else 0:,.1f}%</td></tr>"
        for k, v in sorted(stage_items, key=lambda kv: -kv[1]))

    blocks = data.get("blocks", [])
    block_rows = "".join(
        f"<tr><td>{b['block']}</td><td>{b['frames']}</td>"
        f"<td>{b['time_ms']:,.1f}</td></tr>" for b in blocks)
    block_chart = _svg_line(
        [b["time_ms"] for b in blocks], unit=" ms",
        labels=[f"block {b['block']}: " for b in blocks]) if blocks else ""

    steps = data.get("diffusion_steps", [])
    step_rows = "".join(
        f"<tr><td>{d['step']}</td><td>{d['timestep']:,.4g}</td>"
        f"<td>{d['time_ms']:,.1f}</td></tr>" for d in steps[:200])
    mem = data.get("memory", [])
    mem_chart = _svg_line(
        [m["bytes_in_use"] / 2**30 for m in mem],
        xs=[m["t"] for m in mem], unit=" GiB",
        labels=[f"t={m['t']:,.1f}s: " for m in mem]) if len(mem) > 1 else ""
    stream_rows = "".join(
        f"<tr><td>{st['frames']}</td><td>{st['latency_ms']:,.1f}</td></tr>"
        for st in data.get("streaming", []))
    recs = "".join(f"<li>{r}</li>" for r in s.get("recommendations", []))
    events = "".join(
        f"<tr><td>{e.get('name')}</td><td>{json.dumps({k: v for k, v in e.items() if k != 'name'})}</td></tr>"
        for e in data.get("events", [])[:100])
    tags = json.dumps(s.get("tags") or {})

    def section(title, body):
        return f"<h2>{title}</h2>{body}" if body else ""

    return f"""<!doctype html><html><head><meta charset="utf-8">
<title>inferix_tpu_torch profile: {s.get('session')}</title>
<style>
:root {{ --surface:#fcfcfb; --ink:#0b0b0b; --ink2:#52514e; --hue:#2a78d6;
         --grid:#e5e4e0; --track:#efeeea; }}
@media (prefers-color-scheme: dark) {{
  :root {{ --surface:#1a1a19; --ink:#ffffff; --ink2:#c3c2b7; --hue:#3987e5;
           --grid:#34332f; --track:#262522; }} }}
body {{ font: 14px/1.5 system-ui, sans-serif; margin: 2em auto;
        max-width: 760px; background: var(--surface); color: var(--ink); }}
h1 {{ font-size: 1.3em }} h2 {{ font-size: 1.05em; margin-top: 1.6em }}
table {{ border-collapse: collapse; width: 100% }}
td, th {{ border-bottom: 1px solid var(--grid); padding: 4px 10px;
          text-align: left; font-variant-numeric: tabular-nums }}
th {{ color: var(--ink2); font-weight: 600 }}
.tiles {{ display: flex; flex-wrap: wrap; gap: 10px }}
.tile {{ min-width: 130px; padding: 10px 14px; border: 1px solid var(--grid);
         border-radius: 8px }}
.tv {{ font-size: 1.4em; font-weight: 650; font-variant-numeric: tabular-nums }}
.tl {{ color: var(--ink2); font-size: .85em }}
.bars {{ display: grid; gap: 2px }}
.br {{ display: grid; grid-template-columns: 180px 1fr 90px; gap: 8px;
       align-items: center }}
.bn {{ color: var(--ink2); overflow: hidden; text-overflow: ellipsis;
       white-space: nowrap }}
.bt {{ background: var(--track); border-radius: 4px; height: 14px }}
.bf {{ background: var(--hue); border-radius: 4px; height: 14px;
       display: block }}
.bv {{ text-align: right; font-variant-numeric: tabular-nums }}
svg {{ width: 100%; height: auto; margin-top: 6px }}
.ln {{ stroke: var(--hue); stroke-width: 2 }}
.mk {{ fill: var(--hue) }}
.grid {{ stroke: var(--grid); stroke-width: 1 }}
.ax {{ fill: var(--ink2); font-size: 11px }}
.muted {{ color: var(--ink2) }}
</style></head><body>
<h1>Profile: {s.get('session')}</h1>
<p class="muted">tags: {tags}</p>
<div class="tiles">{tiles}</div>
{section("Recommendations", f"<ul>{recs}</ul>" if recs else "")}
{section("Stage timing", _bar_list(stage_items) +
         f"<table><tr><th>stage</th><th>ms</th><th>share</th></tr>{stage_rows}</table>" if stage_items else "")}
{section("Block latency", block_chart +
         f"<table><tr><th>block</th><th>frames</th><th>ms</th></tr>{block_rows}</table>" if blocks else "")}
{section("Diffusion steps", f"<table><tr><th>step</th><th>t</th><th>ms</th></tr>{step_rows}</table>" if steps else "")}
{section("Device memory (bytes in use)", mem_chart)}
{section("Streaming", f"<table><tr><th>frames</th><th>latency ms</th></tr>{stream_rows}</table>" if stream_rows else "")}
{section("Events", f"<table><tr><th>event</th><th>data</th></tr>{events}</table>" if events else "")}
</body></html>"""
