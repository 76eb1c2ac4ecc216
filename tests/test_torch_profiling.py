"""The port's profiling package (`inferix_tpu_torch/profiling/`) against the
JAX package's (`inferix_tpu/profiling/`) on the CPU: the same calls on both,
with the recorded times passed in, so every field that does not read a
clock must agree; the port's reports read by the JAX readers and the other
way round."""
import json
import os

import pytest
import torch

from inferix_tpu.profiling import decorators as jdeco
from inferix_tpu.profiling import diffusion_analyzer as jda
from inferix_tpu.profiling import extract_metrics as jem
from inferix_tpu.profiling import monitors as jmon
from inferix_tpu.profiling import profiler as jprof
from inferix_tpu_torch.profiling import decorators as tdeco
from inferix_tpu_torch.profiling import diffusion_analyzer as tda
from inferix_tpu_torch.profiling import extract_metrics as tem
from inferix_tpu_torch.profiling import monitors as tmon
from inferix_tpu_torch.profiling import profiler as tprof

PACKAGES = {"jax": (jprof, jdeco, jda, jem, jmon), "port": (tprof, tdeco, tda, tem, tmon)}
# fields of the summary that read the clock
CLOCK_KEYS = ("total_s", "frames_per_s", "time_to_first_block_s")


def _session(prof_mod, out_dir, block_ms=(120.0, 40.0, 41.0), name="t2v", fmt="both"):
    p = prof_mod.InferixProfiler(prof_mod.ProfilingConfig(
        output_dir=str(out_dir), report_format=fmt))
    p.start_session(name, prompts=2, mode="test")
    with p.stage("initialization"):
        p.add_event("encoded", tokens=512)
    with p.stage("diffusion_generation"):
        for i, ms in enumerate(block_ms):
            p.record_diffusion_step(i, 1000.0 - 250 * i, 3, ms / 4, guidance_scale=None)
            p.record_block_computation(i, 3, ms, memory_usage_mb=10.0 * i)
    p.record_streaming(9, 33.5)
    p.sample_memory()
    with p.stage("vae_decoding"):
        pass
    summary = p.end_session()
    return p, summary


def _deterministic(summary):
    return {k: v for k, v in summary.items() if k not in CLOCK_KEYS and k != "stages_ms"}


def test_profiler_summary_matches_the_jax_profiler(tmp_path):
    (jp, js), (tp, ts) = (_session(m, tmp_path / n) for n, (m, *_) in PACKAGES.items())
    assert ts.keys() == js.keys()
    assert _deterministic(ts) == _deterministic(js)
    assert ts["num_blocks"] == 3 and ts["avg_block_ms"] == pytest.approx(67.0)
    assert ts["recommendations"] and ts["recommendations"] == js["recommendations"]
    assert set(ts["stages_ms"]) == set(js["stages_ms"]) == {
        "initialization", "diffusion_generation", "vae_decoding"}
    assert ts["time_to_first_block_s"] is not None
    # no card: the memory sample records zeros
    assert tp.memory_samples[-1]["bytes_in_use"] == 0
    assert ts["peak_memory_bytes"] == 0
    assert [e["name"] for e in tp.events] == [e["name"] for e in jp.events]


@pytest.mark.parametrize("fmt", ["json", "html", "both"])
def test_save_report_files(tmp_path, fmt):
    """The same files (names, JSON sections and summary keys, an HTML page)
    from both profilers; each package's aggregate_reports and
    extract_metrics read the other's JSON alike."""
    paths = {}
    for n, (m, *_) in PACKAGES.items():
        p, _ = _session(m, tmp_path / n, fmt=fmt)
        paths[n] = p.save_report(rank=0)
    names = {n: sorted(os.path.basename(x) for x in ps) for n, ps in paths.items()}
    want = {"json": ["t2v_rank0.json"], "html": ["t2v_rank0.html"],
            "both": ["t2v_rank0.html", "t2v_rank0.json"]}[fmt]
    assert names["port"] == names["jax"] == want
    for x in paths["port"]:
        if x.endswith(".html"):
            assert open(x).read().startswith("<!doctype html>")
    if fmt == "html":
        return
    jfile, tfile = (next(x for x in paths[n] if x.endswith(".json")) for n in ("jax", "port"))
    jdata, tdata = json.load(open(jfile)), json.load(open(tfile))
    assert tdata.keys() == jdata.keys()
    assert tdata["summary"].keys() == jdata["summary"].keys()
    assert tdata["blocks"] == jdata["blocks"]
    assert tdata["diffusion_steps"] == jdata["diffusion_steps"]
    for f in (jfile, tfile):
        got, want_m = tem.extract_metrics(f), jem.extract_metrics(f)
        assert got == want_m
        assert got["num_blocks"] == 3 and got["total_frames"] == 9
    assert tem.aggregate_metrics([jfile, tfile]) == jem.aggregate_metrics([jfile, tfile])
    assert tprof.aggregate_reports([jfile, tfile]) == jprof.aggregate_reports([jfile, tfile])
    assert tprof.aggregate_reports([]) == {}


def test_extract_metrics_main_prints_json(tmp_path, capsys):
    p, _ = _session(tprof, tmp_path, fmt="json")
    (path,) = p.save_report(rank=3)
    tem.main([path])
    assert json.loads(capsys.readouterr().out)["num_blocks"] == 3
    tem.main([path, path])
    assert json.loads(capsys.readouterr().out)["ranks"] == 2


def test_disabled_profiler_records_nothing(tmp_path):
    for m in (jprof, tprof):
        p = m.InferixProfiler(m.ProfilingConfig(enabled=False, output_dir=str(tmp_path)))
        p.start_session("off")
        with p.stage("s"):
            p.record_block_computation(0, 3, 1.0)
        assert p.end_session() is None and p.save_report() == [] and p.blocks == []
    with pytest.raises(ValueError):
        tprof.ProfilingConfig(report_format="xml")


def test_trace_capture_writes_a_torch_profiler_trace(tmp_path):
    """capture_jax_trace keeps its name and captures a torch.profiler trace
    of the session (a Chrome trace in jax_trace_dir)."""
    p = tprof.InferixProfiler(tprof.ProfilingConfig(
        output_dir=str(tmp_path), capture_jax_trace=True,
        jax_trace_dir=str(tmp_path / "trace")))
    p.start_session("traced")
    torch.ones(64, 64) @ torch.ones(64, 64)
    p.end_session()
    trace = tmp_path / "trace" / "traced.trace.json"
    assert trace.exists() and "traceEvents" in json.load(open(trace))


def _analyzer_run(da_mod, prof_mod):
    a = da_mod.DiffusionAnalyzer(prof_mod.InferixProfiler())
    a.base_profiler.start_session("analysis")
    assert a.get_full_analysis()["steps"] is None
    for i, ms in enumerate((900.0, 800.0, 50.0)):
        a.record_diffusion_step(i, 1000.0 - 250 * i, 3, ms, guidance_scale=5.0)
    a.record_block_computation(0, 3, 4000.0, memory_usage_mb=13000.0)
    a.record_block_computation(1, 3, 1000.0, memory_usage_mb=12000.0)
    a.record_model_parameters("dit", 6_000_000_000, "transformer")
    a.record_model_parameters("vae", 120_000_000, "vae")
    return a


def test_diffusion_analyzer_matches_the_jax_analyzer():
    ja, ta = _analyzer_run(jda, jprof), _analyzer_run(tda, tprof)
    got, want = ta.get_full_analysis(), ja.get_full_analysis()
    assert got == want
    assert got["models"]["largest_model"] == "dit"
    assert {r["category"] for r in got["recommendations"]} == {
        "diffusion_steps", "block_computation", "memory", "model"}
    assert [e["name"] for e in ta.base_profiler.events] == \
        [e["name"] for e in ja.base_profiler.events]
    assert len(ta.base_profiler.blocks) == 2


def _decorated(deco_mod, prof_mod):
    class Worker:
        def __init__(self):
            self.profiler = prof_mod.InferixProfiler()

        @deco_mod.profile_session("run")
        def run(self, n):
            return [self.block(i) for i in range(n)]

        @deco_mod.profile_block()
        def block(self, i):
            self.step()
            return torch.zeros(1, 3 + i, 2) if i else (torch.zeros(1, 3, 2), None)

        @deco_mod.profile_stage("step")
        @deco_mod.add_profiling_event("stepped", k=1)
        def step(self):
            return 1

        @deco_mod.profile_method()
        def scalar(self):
            return 2.0

    w = Worker()
    w.run(3)
    w.scalar()
    p = w.profiler
    return ([(b["block"], b["frames"]) for b in p.blocks], [s.name for s in p.stages],
            [(e["name"], e["k"]) for e in p.events])


def test_decorators_record_as_the_jax_decorators():
    want = _decorated(jdeco, jprof)
    assert _decorated(tdeco, tprof) == want
    assert want[0] == [(0, 3), (1, 4), (2, 5)]
    # no profiler on the object: the wrapped function runs untouched
    assert tdeco.profile_block()(lambda x: x + 1)(1) == 2


@pytest.mark.parametrize("pkg", ["jax", "port"])
def test_monitors(pkg):
    mon = PACKAGES[pkg][4]
    host = mon.HostMonitor(interval_s=0.01, max_samples=3)
    host.start()
    host.start()  # idempotent
    import time
    time.sleep(0.1)
    host.stop()
    assert 1 <= len(host.samples) <= 3
    assert "ram_used_gb" in host.summary()
    assert mon.BaseMonitor().summary() == {}
    if pkg == "port":
        dev = mon.DeviceMonitor(device="cpu")
        assert dev.sample() == {"hbm_in_use_gb": 0.0, "hbm_peak_gb": 0.0,
                                "hbm_limit_gb": 0.0}
