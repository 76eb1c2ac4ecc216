"""The benchmark's general part: finds a cell's files by name, runs its
driver through set-up, the measured window and the correctness check,
reads the metrics and prints the result.

Everything that belongs to one configuration, traffic mix, driver or
metric is a file of its own, found by the name that `BENCHMARK.json` and
the cell's file give:

    workloads/<cell>.json     config, traffic, driver, the check's limits, why
    configs/<config>.json     the configuration as it is run
    traffic/<traffic>.json    the traffic mix's parameters
    drivers/<driver>.py       `Cell(ctx)`: setup(), window(seconds, rec), release(), check()
    metrics/<metric>.py       `read(rec)` -> a number, or None where there is nothing to read
    metrics/<metric>.patterns.json   kernel-name groups, for a metric that reads kernels

A run's record (`Record`) holds what the window did: its steps with their
host-clock spans and the work each drove (`counts/`), and in a traced run
the device's kernel intervals from `torch.profiler`.
"""
from __future__ import annotations

import bisect
import dataclasses
import hashlib
import importlib.util
import json
import os
import re
import subprocess
import sys
import time
from pathlib import Path
from typing import Any, Dict, List, Optional, Tuple

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "inferix_tpu")
CACHE_DIR = ROOT / ".bench_cache"
# A traced run's window: at most this many seconds (whole steps, as any
# window). The profiler's events of a 42 s window (~1.2e6) took 270-380 s
# to read back, past the 360 s a run may take.
TRACE_SECONDS = 10.0


class MetricError(RuntimeError):
    """A metric that should have read something found nothing."""


def load_json(path: Path) -> Any:
    with open(path) as f:
        return json.load(f)


def derive_seed(seed: int, *keys) -> int:
    """A 63-bit seed for one purpose (weights, a clip's inputs, a sample),
    from the run's --seed: the same seed and keys give the same number."""
    text = ":".join(str(k) for k in (seed, *keys))
    return int.from_bytes(hashlib.sha256(text.encode()).digest()[:8], "little") >> 1


def load_module(kind: str, name: str):
    """benchmark/<kind>/<name>.py as a module."""
    path = BENCH / kind / f"{name}.py"
    if not path.is_file():
        raise FileNotFoundError(f"no {kind} file {path.relative_to(ROOT)}")
    mod_name = f"benchmark_{kind}_{re.sub(r'[^0-9A-Za-z_]', '_', name)}"
    spec = importlib.util.spec_from_file_location(mod_name, path)
    module = importlib.util.module_from_spec(spec)
    sys.modules[mod_name] = module
    spec.loader.exec_module(module)
    return module


@dataclasses.dataclass
class CellFiles:
    workload: Dict
    config: Dict
    traffic: Dict


def load_cell(name: str) -> CellFiles:
    workload = load_json(BENCH / "workloads" / f"{name}.json")
    config = load_json(BENCH / "configs" / f"{workload['config']}.json")
    traffic = load_json(BENCH / "traffic" / f"{workload['traffic']}.json")
    return CellFiles(workload, config, traffic)


def merge(base: Dict, patch: Dict) -> Dict:
    """base with patch's keys set, nested dicts merged."""
    out = dict(base)
    for k, v in patch.items():
        out[k] = merge(out[k], v) if isinstance(v, dict) and isinstance(out.get(k), dict) else v
    return out


def benchmark_metrics(cell: str, trace: bool) -> List[Dict]:
    """The metrics of BENCHMARK.json that `cell` reports: with trace, its
    per-layer metrics, else its end-to-end ones (an entry with a
    "workloads" key is the listed cells')."""
    spec = load_json(ROOT / "BENCHMARK.json")
    metrics = spec["per_layer"] if trace else spec["end_to_end"]
    return [m for m in metrics if "workloads" not in m or cell in m["workloads"]]


# -- the window's record -----------------------------------------------------


@dataclasses.dataclass
class Step:
    """One step of the window: the pixel frames it delivered, its spans
    (name -> (start, end), perf_counter seconds), the work it drove
    (`counts.Work` items, with the span each ran in)."""

    frames: float
    spans: Dict[str, Tuple[float, float]]
    work: List[Tuple[str, Any]]
    gap: Optional[float] = None  # time since the stream's previous delivery


class Record:
    def __init__(self, peaks: Dict):
        self.peaks = peaks
        self.steps: List[Step] = []
        self.t0 = self.t1 = 0.0
        self.t0_ns = 0          # time.time_ns() at t0: the profiler's clock
        self.setup_s = 0.0
        self.memory_peak_bytes = 0
        self.window_peak_bytes = 0
        self.kernels: List[Tuple[str, int, int]] = []  # (name, start_ns, end_ns)

    def start(self) -> None:
        self.t0 = time.perf_counter()
        self.t0_ns = time.time_ns()

    def stop(self, end: Optional[float] = None) -> None:
        self.t1 = end if end is not None else time.perf_counter()

    def add(self, step: Step) -> None:
        self.steps.append(step)

    @property
    def window_s(self) -> float:
        return self.t1 - self.t0

    def to_ns(self, t: float) -> int:
        """A perf_counter time on the profiler's clock."""
        return self.t0_ns + int(round((t - self.t0) * 1e9))

    # -- readers' helpers --------------------------------------------------

    def work(self, categories=None, span: Optional[str] = None):
        """Every Work item of the window (of `categories`, run in `span`)."""
        out = []
        for st in self.steps:
            for sp, w in st.work:
                if ((categories is None or w.category in categories)
                        and (span is None or sp == span)):
                    out.append(w)
        return out

    def span_windows(self, span: str) -> List[Tuple[int, int]]:
        """[start_ns, end_ns) of every step's `span`, in order."""
        return [(self.to_ns(s), self.to_ns(e)) for st in self.steps
                for name, (s, e) in st.spans.items() if name == span]

    def busy_ns(self, intervals=None) -> int:
        """Length of the union of the device intervals, clipped to the window."""
        lo, hi = self.to_ns(self.t0), self.to_ns(self.t1)
        return sum(e - s for s, e in union(intervals if intervals is not None else
                                           [(s, e) for _, s, e in self.kernels], lo, hi))

    def kernel_seconds(self, patterns_path: Path) -> float:
        """Device seconds of the kernels the pattern file counts (in its
        "span" only, when it names one). Raises MetricError where its
        patterns match no kernel: a roofline of nothing is not 0."""
        pat = load_json(patterns_path)
        labels = group_labels(self.kernels, compile_groups(pat["groups"]))
        counted = set(pat["count"])
        windows = self.span_windows(pat["span"]) if pat.get("span") else None
        starts = [w[0] for w in windows] if windows else None
        total, matched = 0, 0
        for name, s, e in self.kernels:
            if labels[name] not in counted:
                continue
            if windows is not None:
                i = bisect.bisect_right(starts, s) - 1
                if i < 0 or s >= windows[i][1]:
                    continue
            total += e - s
            matched += 1
        if not matched:
            raise MetricError(f"{patterns_path.name}: its patterns match no kernel of the "
                              f"traced window ({len(self.kernels)} device events)")
        return total / 1e9


class Marks:
    """Points on the device's timeline, read late, so that the host need not
    wait for the device to time a step. `mark()` records a CUDA event on the
    current stream (on the CPU, where an operation has finished when it
    returns, the host clock); `time(m)`, once the point has passed, gives it
    on the window's perf_counter scale: the origin event, recorded by
    `start(t0)` on an idle device, is placed at t0."""

    def __init__(self, device):
        self.cuda = device.type == "cuda"
        self.t0 = 0.0
        self.origin = None

    def start(self, t0: float) -> None:
        self.t0 = t0
        self.origin = self.mark()

    def mark(self):
        if not self.cuda:
            return time.perf_counter()
        import torch

        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        return ev

    def wait(self, m) -> None:
        """Until the device has passed m."""
        if self.cuda:
            m.synchronize()

    def time(self, m) -> float:
        if not self.cuda:
            return m
        return self.t0 + self.origin.elapsed_time(m) / 1e3


def union(intervals, lo: Optional[int] = None, hi: Optional[int] = None):
    """The union of [start, end) intervals as sorted disjoint intervals,
    clipped to [lo, hi)."""
    out: List[List[int]] = []
    for s, e in sorted(intervals):
        if lo is not None:
            s, e = max(s, lo), min(e, hi)
            if e <= s:
                continue
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [tuple(x) for x in out]


def compile_groups(groups) -> List[Tuple[str, "re.Pattern"]]:
    return [(label, re.compile(rx, re.I if "i" in flags else 0)) for label, rx, flags in groups]


def group_of(name: str, groups) -> str:
    for label, pat in groups:
        if pat.search(name):
            return label
    return "other"


def group_labels(kernels, groups) -> Dict[str, str]:
    """Each distinct kernel name's group (a window has ~1e6 events of a few
    hundred names)."""
    return {name: group_of(name, groups) for name in {k[0] for k in kernels}}


def percentile(values: List[float], q: float) -> float:
    """The q-th percentile with linear interpolation between order
    statistics (numpy's default)."""
    xs = sorted(values)
    if not xs:
        raise ValueError("no values")
    pos = (len(xs) - 1) * q / 100.0
    lo = int(pos)
    hi = min(lo + 1, len(xs) - 1)
    return xs[lo] + (xs[hi] - xs[lo]) * (pos - lo)


# -- the trace ---------------------------------------------------------------


def device_events(prof) -> List[Tuple[str, int, int]]:
    """(name, start_ns, end_ns) of every device event (kernels, copies,
    memsets) the profiler recorded."""
    from torch.autograd import DeviceType

    out = []
    for ev in prof.profiler.kineto_results.events():
        if ev.device_type() == DeviceType.CUDA:
            s = ev.start_ns()
            out.append((ev.name(), s, s + ev.duration_ns()))
    return out


def breakdown(rec: Record) -> Dict:
    """The device's seconds by kernel group (the ten largest), and the idle
    seconds by what the host was doing (the step span it was in)."""
    labels = group_labels(rec.kernels, compile_groups(
        load_json(BENCH / "metrics" / "groups.json")["groups"]))
    by_group: Dict[str, int] = {}
    for name, s, e in rec.kernels:
        by_group[labels[name]] = by_group.get(labels[name], 0) + (e - s)
    ops = sorted(by_group.items(), key=lambda kv: -kv[1])[:10]
    lo, hi = rec.to_ns(rec.t0), rec.to_ns(rec.t1)
    busy = union([(s, e) for _, s, e in rec.kernels], lo, hi)
    gaps, prev = [], lo
    for s, e in busy:
        if s > prev:
            gaps.append((prev, s))
        prev = e
    if hi > prev:
        gaps.append((prev, hi))
    spans = sorted((rec.to_ns(s), rec.to_ns(e), name) for st in rec.steps
                   for name, (s, e) in st.spans.items())
    starts = [s for s, _, _ in spans]
    idle: Dict[str, int] = {}
    for s, e in gaps:
        mid = (s + e) // 2
        i = bisect.bisect_right(starts, mid) - 1
        label = spans[i][2] if i >= 0 and mid < spans[i][1] else "between steps"
        idle[label] = idle.get(label, 0) + (e - s)
    return {"device_ops": [[k, v / 1e9] for k, v in ops],
            "idle_gaps": [[k, v / 1e9]
                          for k, v in sorted(idle.items(), key=lambda kv: -kv[1])[:10]]}


def log_kernels(rec: Record, log) -> None:
    """The traced window's largest kernels by name with their group, and
    where the first and last device event fall against the window's host
    clock (the two clocks' alignment)."""
    if not rec.kernels:
        log("the profiler recorded no device event")
        return
    groups = compile_groups(load_json(BENCH / "metrics" / "groups.json")["groups"])
    by_name: Dict[str, int] = {}
    for name, s, e in rec.kernels:
        by_name[name] = by_name.get(name, 0) + (e - s)
    for name, ns in sorted(by_name.items(), key=lambda kv: -kv[1])[:20]:
        log(f"  {ns / 1e9:10.4f} s  [{group_of(name, groups)}]  {name[:150]}")
    first = min(s for _, s, _ in rec.kernels) - rec.to_ns(rec.t0)
    last = max(e for _, _, e in rec.kernels) - rec.to_ns(rec.t1)
    log(f"first device event {first / 1e6:.3f} ms after the window's start, last "
        f"{last / 1e6:.3f} ms after its end")


# -- running a cell ----------------------------------------------------------


@dataclasses.dataclass
class Context:
    """What a driver is handed: the cell's files (the configuration with the
    control's patch applied in a control run), the run's seed, its device."""

    cell: CellFiles
    seed: int
    device: Any


@dataclasses.dataclass
class Check:
    """One number compared: the run is correct where value <= limit."""

    name: str
    value: float
    limit: float

    @property
    def ok(self) -> bool:
        return self.value == self.value and self.value <= self.limit


def forbidden_modules() -> List[str]:
    """Top-level names of loaded modules that the benchmark's process must
    not hold (the JAX stack and the JAX package), compared whole."""
    return sorted({name.split(".")[0] for name in list(sys.modules)} & set(FORBIDDEN))


def card_info() -> str:
    """The card's name and power limit, as nvidia-smi reads them."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=60)
        return out.stdout.strip() or out.stderr.strip()
    except (OSError, subprocess.SubprocessError) as exc:
        return f"nvidia-smi unavailable ({exc})"


# host threads of the benchmark's process: the window launches kernels from
# one thread, and idle CPU thread pools only contend with it for the cores
HOST_THREADS = 1


def set_environment() -> None:
    """Before torch is imported: build and kernel caches at fixed paths
    inside the checkout, no JAX through a library, few host threads."""
    os.environ.setdefault("TORCH_EXTENSIONS_DIR", str(CACHE_DIR / "torch_extensions"))
    os.environ.setdefault("TRITON_CACHE_DIR", str(CACHE_DIR / "triton"))
    os.environ.setdefault("USE_FLAX", "0")
    os.environ.setdefault("USE_JAX", "0")
    for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS"):
        os.environ.setdefault(var, str(HOST_THREADS))


def run_cell(name: str, seed: int, seconds: float, trace: bool, device=None,
             control: bool = False, patch: Optional[Dict] = None,
             metrics: Optional[List[Dict]] = None, t_start: Optional[float] = None,
             log=None) -> Dict:
    """One run of cell `name`; returns the result's fields and the checks.
    device None: the card (cuda:0). patch: keys set on the cell's files
    ({"config": ..., "traffic": ..., "workload": ...}: a test's smaller
    sizes). metrics: the metric entries to read (default: BENCHMARK.json's
    for this cell)."""
    import torch

    log = log or (lambda msg: print(msg, file=sys.stderr, flush=True))
    t_start = t_start if t_start is not None else time.perf_counter()
    cell = load_cell(name)
    if control:
        cell.config = merge(cell.config, cell.workload["check"]["control"]["patch"])
    for part, keys in (patch or {}).items():
        setattr(cell, part, merge(getattr(cell, part), keys))
    device = torch.device(device if device is not None else "cuda:0")
    on_card = device.type == "cuda"
    peaks = load_json(BENCH / "peaks.json")
    rec = Record(peaks)
    driver = load_module("drivers", cell.workload["driver"])
    sut = driver.Cell(Context(cell, seed, device))

    sut.setup()
    if on_card:
        torch.cuda.synchronize(device)
    rec.setup_s = time.perf_counter() - t_start
    log(f"set-up {rec.setup_s:.3f} s")
    if on_card:
        setup_peak = torch.cuda.max_memory_allocated(device)
        torch.cuda.reset_peak_memory_stats(device)
    prof = None
    if trace and on_card:
        from torch.profiler import ProfilerActivity, profile
        prof = profile(activities=[ProfilerActivity.CUDA])
        prof.start()
    sut.window(min(seconds, TRACE_SECONDS) if trace else seconds, rec)
    if prof is not None:
        t_read = time.perf_counter()
        prof.stop()
        rec.kernels = device_events(prof)
        del prof
        log(f"trace read back in {time.perf_counter() - t_read:.3f} s")
        log_kernels(rec, log)
    if on_card:
        rec.window_peak_bytes = torch.cuda.max_memory_allocated(device)
        rec.memory_peak_bytes = max(setup_peak, rec.window_peak_bytes)
    log(f"window {rec.window_s:.3f} s, {len(rec.steps)} steps, "
        f"{len(rec.kernels)} device events")

    sut.release()
    t_check = time.perf_counter()
    checks: List[Check] = sut.check()
    log(f"check {time.perf_counter() - t_check:.3f} s")

    wanted = metrics if metrics is not None else benchmark_metrics(name, trace)
    values: Dict[str, Dict] = {}
    t_read = time.perf_counter()
    for m in wanted:
        value = load_module("metrics", m["name"]).read(rec)
        if value is not None:
            values[m["name"]] = {"value": value, "unit": m["unit"]}
    log(f"metrics read in {time.perf_counter() - t_read:.3f} s")
    result = {
        "correct": bool(checks) and all(c.ok for c in checks),
        "attempted": len(rec.steps),
        "failed": sum(not c.ok for c in checks),
        "metrics": values,
        "device": {
            "platform": "gpu" if on_card else device.type,
            "kind": torch.cuda.get_device_name(device) if on_card else device.type,
            "count": cell.workload["chips"],
            "memory_peak_bytes": rec.memory_peak_bytes,
        },
    }
    if trace:
        busy = rec.busy_ns() / 1e9
        result["device"].update(busy_s=busy, window_s=rec.window_s)
        if rec.kernels:
            result["breakdown"] = breakdown(rec)
    result["checks"] = {c.name: {"value": c.value, "limit": c.limit} for c in checks}
    return result
