"""Tests of the benchmark (`python -m pytest benchmark/ -q`), on the CPU at
small sizes; the one that needs a card is marked `card` and skips here.

They hold: every file BENCHMARK.json names loads by name; a new cell and a
new metric are found from their files alone; the operation and byte counts
against hand counts at the kernel table's shapes; the float32 references
against the port's own float32 path; the harness's readers on synthetic
traces; a run of the cell at a small size; its control and the faults of
its timed path coming out not correct; no module of the benchmark loading
the JAX stack or the JAX package.
"""
from __future__ import annotations

import json
import re
import shutil
import subprocess
import sys

import pytest
import torch

from benchmark import harness, weights
from benchmark.counts import Work, attention, least_time, linear, ops_time
from benchmark.counts import wan as wan_counts

ROOT = harness.ROOT
SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())
CELL = "wan13b-live1-clip81"
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")

# the cell at a size a CPU test holds: every width cut, the structure kept
SMALL = {"config": {"engine": {"model": {"dim": 256, "ffn_dim": 1024, "num_heads": 4,
                                         "num_layers": 4, "text_len": 16, "text_dim": 64,
                                         "freq_dim": 32, "max_attention_frames": 9,
                                         "rope_max_seq_len": 64},
                               "runtime": {"latent_height": 8, "latent_width": 8}},
                    "vae": {"dim": 8}},
         "traffic": {"clip_latent_frames": 9}}


def quiet(_msg):
    pass


def small_run(seed=20251018, control=False, patch=None, seconds=0.05):
    return harness.run_cell(CELL, seed, seconds, False, device="cpu", control=control,
                            patch=harness.merge(SMALL, patch or {}), metrics=[], log=quiet)


# -- the files ---------------------------------------------------------------


def test_benchmark_json_follows_the_contract():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs", "workloads",
                         "end_to_end", "per_layer"}
    assert SPEC["paths"] == ["benchmark"] and SPEC["command"][1] == "benchmark/run.py"
    assert 1 <= SPEC["run_seconds"] <= 51
    names = [c["name"] for c in SPEC["configs"]] + [w["name"] for w in SPEC["workloads"]] \
        + [m["name"] for m in SPEC["end_to_end"] + SPEC["per_layer"]]
    assert all(NAME.match(n) for n in names) and len(set(names)) == len(names)
    e2e = {m["name"] for m in SPEC["end_to_end"]}
    assert "setup_s" in e2e
    for m in SPEC["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    for m in SPEC["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert m["moves"] in e2e and "\n" not in m["layer"]
    for w in SPEC["workloads"]:
        assert w["chips"] == 1 and len(w["why"]) <= 200
        assert w["config"] in {c["name"] for c in SPEC["configs"]}
    for c in SPEC["configs"]:
        assert c["file"].startswith("benchmark/") and (ROOT / c["file"]).is_file()
        assert c["reduced"] == [] and len(c["why"]) <= 200


def test_every_named_file_loads_by_name():
    for w in SPEC["workloads"]:
        cell = harness.load_cell(w["name"])
        assert cell.workload["config"] == w["config"]
        assert cell.workload["traffic"] == w["traffic"]
        assert hasattr(harness.load_module("drivers", cell.workload["driver"]), "Cell")
        assert json.loads((ROOT / next(c["file"] for c in SPEC["configs"]
                                       if c["name"] == w["config"])).read_text()) == cell.config
    for m in SPEC["end_to_end"] + SPEC["per_layer"]:
        assert callable(harness.load_module("metrics", m["name"]).read)


def test_a_new_cell_and_metric_are_found_from_their_files_alone(tmp_path, monkeypatch):
    bench = tmp_path / "benchmark"
    shutil.copytree(harness.BENCH, bench, ignore=shutil.ignore_patterns("__pycache__"))
    (bench / "configs" / "toy-config.json").write_text(json.dumps({"rows": 3}))
    (bench / "traffic" / "toy-traffic.json").write_text(json.dumps({"steps": 4}))
    (bench / "workloads" / "toy-cell.json").write_text(json.dumps({
        "name": "toy-cell", "config": "toy-config", "traffic": "toy-traffic",
        "driver": "toy_driver", "chips": 1, "why": "a test's cell",
        "check": {"limits": {"err": 0.5}}}))
    (bench / "drivers" / "toy_driver.py").write_text(
        "from benchmark import harness\n"
        "class Cell:\n"
        "    def __init__(self, ctx): self.ctx = ctx\n"
        "    def setup(self): pass\n"
        "    def window(self, seconds, rec):\n"
        "        rec.start()\n"
        "        for i in range(self.ctx.cell.traffic['steps']):\n"
        "            rec.add(harness.Step(self.ctx.cell.config['rows'], {}, [], gap=0.1))\n"
        "        rec.stop(rec.t0 + 1.0)\n"
        "    def release(self): pass\n"
        "    def check(self):\n"
        "        limit = self.ctx.cell.workload['check']['limits']['err']\n"
        "        return [harness.Check('err', 0.25, limit)]\n")
    (bench / "metrics" / "toy_rows.py").write_text(
        "def read(rec):\n    return float(sum(st.frames for st in rec.steps))\n")
    monkeypatch.setattr(harness, "BENCH", bench)
    res = harness.run_cell("toy-cell", 1, 1.0, False, device="cpu", log=quiet,
                           metrics=[{"name": "toy_rows", "unit": "rows"},
                                    {"name": "frames_per_s", "unit": "frames/s"}])
    assert res["correct"] and res["attempted"] == 4
    assert res["metrics"]["toy_rows"]["value"] == 12.0
    assert res["metrics"]["frames_per_s"]["value"] == pytest.approx(12.0)
    assert list(res)[-1] == "checks" and res["checks"]["err"] == {"value": 0.25, "limit": 0.5}


# -- the counts --------------------------------------------------------------


def test_attention_counts_match_the_kernel_table():
    peaks = harness.load_json(harness.BENCH / "peaks.json")
    full = attention("self_attention", 4680, 32760, 12, 128)
    assert full.ops == 4 * 4680 * 32760 * 128 * 12
    assert full.bytes == 2 * 4680 * 1536 * 2 + 2 * 32760 * 1536 * 2
    assert least_time(full, peaks) * 1e3 == pytest.approx(0.9525, abs=5e-5)  # PERF.md row 1
    short = attention("self_attention", 4680, 4680, 12, 128)
    assert least_time(short, peaks) == pytest.approx(short.ops / 989e12)
    int8 = attention("self_attention", 12150, 60750, 24, 128, kv_itemsize=1, kv_scale_bytes=4)
    assert int8.bytes == 2 * 12150 * 24 * 128 * 2 + 2 * 60750 * 24 * (128 + 4)


def test_dit_forward_counts_by_hand():
    m = harness.load_cell(CELL).config["engine"]["model"]
    work = wan_counts.forward_work(m, 4680, 9360, 3)
    lin = sum(w.ops for w in work if w.category == "linear" and w.precision == "bf16")
    per_layer = 2 * 4680 * (1536 * 4608 + 3 * 1536 * 1536 + 2 * 1536 * 8960)
    assert lin == 30 * per_layer + 2 * 4680 * 64 * 1536 * 2
    fp32 = sum(w.ops for w in work if w.precision == "fp32")
    assert fp32 == 2 * 3 * (256 * 1536 + 1536 * 1536 + 1536 * 9216)
    sa = [w for w in work if w.category == "self_attention"]
    assert len(sa) == 1 and sa[0].ops == 30 * 4 * 4680 * 9360 * 128 * 12
    xa = [w for w in work if w.category == "cross_attention"]
    assert xa[0].ops == 30 * 4 * 4680 * 512 * 128 * 12
    rerun = wan_counts.forward_work(m, 4680, 9360, 3, need_output=False)
    assert sum(w.ops for w in work) - sum(w.ops for w in rerun) == 2 * 4680 * 1536 * 64
    text = wan_counts.text_work(m)
    assert sum(w.ops for w in text) == 2 * 512 * (4096 * 1536 + 1536 * 1536 + 60 * 1536 * 1536)


def _meta_tree(spec):
    if isinstance(spec, weights.Leaf):
        return torch.empty(spec.shape, dtype=torch.float32, device="meta")
    if isinstance(spec, dict):
        return {k: _meta_tree(v) for k, v in spec.items()}
    return [_meta_tree(v) for v in spec]


@pytest.mark.parametrize("first", [True, False])
def test_vae_decode_counts_match_the_reference_decoder(first, monkeypatch):
    """The shape walk of counts/wan.py against the convolutions the float32
    reference decoder runs, traced on the meta device at 480x832."""
    from benchmark.reference import wan_vae

    v = harness.load_cell(CELL).config["vae"]
    seen = []
    conv3d = torch.nn.functional.conv3d

    def counting(x, w, *a, **k):
        y = conv3d(x, w, *a, **k)
        seen.append((tuple(w.shape[2:]),
                     2.0 * y.numel() * w.shape[1] * w.shape[2] * w.shape[3] * w.shape[4]))
        return y

    monkeypatch.setattr(wan_vae.F, "conv3d", counting)
    ref = wan_vae.WanVAEDecoderReference(_meta_tree(weights.wan_vae_decoder_spec(v)), "meta")
    if not first:
        ref.decode(torch.empty(3, 60, 104, 16, device="meta"))
        seen.clear()
    out = ref.decode(torch.empty(3, 60, 104, 16, device="meta"))
    work = wan_counts.vae_decode_work(v, 3, 60, 104, first=first)
    assert out.shape == (wan_counts.decoded_frames(3, first), 480, 832, 3)
    convs = [w for w in work if w.category == "vae_conv"]
    assert sum(w.ops for w in convs) == pytest.approx(sum(ops for _, ops in seen))
    assert len(convs) == len(seen)
    halo = [ops for k, ops in seen if k == (3, 3, 3)]
    assert len(halo) == 30  # PERF.md row 10: B6, 30 launches a decode chunk
    if not first:
        # and their bound: 37.1583 ms at the bf16 peak for a later chunk
        assert sum(halo) / 989e12 * 1e3 == pytest.approx(37.1583, abs=5e-5)
    assert ops_time(Work("x", "bf16", 989e12, 0.0), {"ops_per_s": {"bf16": 989e12}}) == 1.0


# -- the references against the port's float32 path --------------------------


def _small_model():
    cell = harness.load_cell(CELL)
    return harness.merge(cell.config, SMALL["config"])


def test_dit_reference_matches_the_port_in_float32():
    from inferix_tpu_torch.core.config import EngineConfig
    from inferix_tpu_torch.pipeline.semi_ar import SemiARGenerator
    from benchmark.reference.wan_dit import WanReference, fp32_tree

    conf = _small_model()
    m = conf["engine"]["model"]
    g = torch.Generator().manual_seed(3)
    tree = weights.materialize(weights.wan_dit_spec(m, 1.0), g, torch.device("cpu"))
    x = torch.randn(2, 1, 3, 8, 8, 16, generator=g)
    text = torch.randn(1, 16, 64, generator=g)
    ref = WanReference(m, tree, "cpu", 3, (8, 8), 9 * 16)
    tkv = ref.text(text[0])
    gen = SemiARGenerator(EngineConfig.from_dict(conf["engine"]), fp32_tree(tree),
                          dtype=torch.float32, device="cpu")
    xattn = gen.encode_text_context(text)
    cache = gen.init_cache()
    for start, xb, need in ((0, x[0], False), (3, x[1], True)):
        want = ref.forward(xb[0], 727.0, tkv, start, need_output=need)
        got, _ = gen._forward(xb, 727.0, xattn, cache, start * 16, need_output=need)
        if need:
            assert ((got[0] - want).norm() / want.norm()).item() < 1e-5
    assert ((cache.k[:, 0, :96].reshape(4, 96, -1) - torch.stack(ref.k)[:, :96].reshape(4, 96, -1))
            .norm() / torch.stack(ref.k)[:, :96].norm()).item() < 1e-5


def test_vae_reference_matches_the_port_in_float32():
    from inferix_tpu_torch.models.wan.vae import CausalVAE, VAEConfig
    from benchmark.reference.wan_vae import WanVAEDecoderReference

    v = dict(harness.load_cell(CELL).config["vae"], dim=8)
    g = torch.Generator().manual_seed(4)
    tree = weights.materialize(weights.wan_vae_decoder_spec(v, torch.float32), g,
                               torch.device("cpu"))
    vae = CausalVAE(VAEConfig(dim=8), params=tree, dtype=torch.float32, device="cpu",
                    conv_impl="xla")
    ref = WanVAEDecoderReference(tree, "cpu")
    z = torch.randn(1, 6, 8, 8, 16, generator=g)
    cache = None
    for i in (0, 3):
        got, cache = vae.decode_chunk(z[:, i:i + 3], cache, first=i == 0)
        want = ref.decode(z[0, i:i + 3])
        assert got.shape[1:] == want.shape
        assert ((got[0] - want).norm() / want.norm()).item() < 1e-5


# -- the harness's readers ---------------------------------------------------


def _record(kernels, steps):
    rec = harness.Record(harness.load_json(harness.BENCH / "peaks.json"))
    rec.t0, rec.t0_ns, rec.t1 = 100.0, 10**18, 101.0
    rec.kernels = kernels
    rec.steps = steps
    return rec


def test_union_percentile_and_idle():
    assert harness.union([(5, 9), (0, 2), (1, 3), (8, 12)], 0, 10) == [(0, 3), (5, 10)]
    assert harness.percentile([1, 2, 3, 4], 50) == 2.5
    assert harness.percentile(list(range(11)), 90) == 9
    t0 = 10**18
    rec = _record([("a", t0, t0 + 250_000_000), ("b", t0 + 200_000_000, t0 + 500_000_000)], [])
    assert harness.load_module("metrics", "device_idle_pct").read(rec) == pytest.approx(50.0)
    bd = harness.breakdown(rec)
    assert bd["idle_gaps"] == [["between steps", 0.5]]
    assert [k for k, _ in bd["device_ops"]] == ["other"]


def test_rooflines_read_only_their_kernels_in_their_span():
    t0 = 10**18
    w = attention("self_attention", 4680, 32760, 12, 128)
    lin = linear("linear", 4680, 1536, 1536)
    step = harness.Step(12, {"dit": (100.0, 100.4), "decode": (100.4, 100.5)},
                        [("dit", w), ("dit", lin)], gap=0.5)
    flash = "void flash_sm90_kernel<0, 128>(Params)"
    gemm = "sm90_xmma_gemm_bf16bf16_bf16f32_f32_tn_n"
    conv = "sm90_xmma_fprop_implicit_gemm_bf16"
    kernels = [(flash, t0 + 1000, t0 + 1000 + 2_000_000),           # 2 ms in the DiT span
               (gemm, t0 + 3_000_000, t0 + 3_000_000 + 50_000),     # 50 us in the DiT span
               (gemm, t0 + 450_000_000, t0 + 460_000_000),          # in the decode span
               (conv, t0 + 410_000_000, t0 + 420_000_000)]
    rec = _record(kernels, [step])
    attn = harness.load_module("metrics", "attn_roofline_pct").read(rec)
    assert attn == pytest.approx(100 * least_time(w, rec.peaks) / 2e-3)
    lr = harness.load_module("metrics", "linear_roofline_pct").read(rec)
    assert lr == pytest.approx(100 * least_time(lin, rec.peaks) / 50e-6)
    rec.kernels = [(conv, t0 + 1000, t0 + 2000)]
    with pytest.raises(harness.MetricError):
        harness.load_module("metrics", "attn_roofline_pct").read(rec)


def test_host_clock_metrics():
    steps = [harness.Step(12 if i else 9,
                          {"dit": (100.0 + i, 100.8 + i), "decode": (100.8 + i, 101.0 + i)},
                          [], gap=1.0 + i / 10) for i in range(3)]
    rec = _record([], steps)
    rec.t1 = 103.0
    read = {n: harness.load_module("metrics", n).read(rec) for n in
            ("frames_per_s", "block_gap_p90_s", "dit_s_per_step", "vae_decode_ms_per_frame")}
    assert read["frames_per_s"] == pytest.approx(33 / 3)
    assert read["block_gap_p90_s"] == pytest.approx(1.18)
    assert read["dit_s_per_step"] == pytest.approx(0.8)
    assert read["vae_decode_ms_per_frame"] == pytest.approx(600 / 33)
    assert harness.load_module("metrics", "step_mfu_pct").read(rec) is None


# -- runs of the cell on the CPU ---------------------------------------------


def test_the_window_marks_each_delivery_and_closes_after_them():
    """Deliveries are timed from their marks: the steps tile the window from
    its start, each gap from the previous delivery, all before its close."""
    cell = harness.load_cell(CELL)
    for part, keys in SMALL.items():
        setattr(cell, part, harness.merge(getattr(cell, part), keys))
    sut = harness.load_module("drivers", "wan_stream").Cell(
        harness.Context(cell, 5, torch.device("cpu")))
    sut.setup()
    rec = harness.Record({})
    sut.window(0.0, rec)
    assert sut.completed == [0] and len(rec.steps) == 3
    last = rec.t0
    for st in rec.steps:
        (s, e), (s2, e2) = st.spans["dit"], st.spans["decode"]
        assert s == last < e == s2 < e2 and st.gap == pytest.approx(e2 - last)
        last = e2
    assert last <= rec.t1


def test_the_cell_runs_and_is_correct_at_a_small_size():
    res = small_run()
    assert res["correct"], res["checks"]
    assert res["attempted"] == 3 and set(res["checks"]) == {"x0_rel", "pixels_rel"}


def test_the_control_is_not_correct():
    """The program's fp8-weight DiT and W8A8 VAE, one precision below bf16,
    fails the limits that bf16 passes."""
    good, ctl = small_run(seed=7), small_run(seed=7, control=True)
    assert good["correct"] and not ctl["correct"], (good["checks"], ctl["checks"])


def _fault_patches():
    from inferix_tpu_torch.models.wan.vae import CausalVAE
    from inferix_tpu_torch.pipeline.semi_ar import SemiARGenerator

    denoise, fwd, decode = SemiARGenerator.denoise_block, SemiARGenerator._forward, \
        CausalVAE.decode_chunk

    def unchanged(self, cache, xattn, noisy, start, generator=None, renoise=None):
        return noisy.to(self.device), cache                 # a step returning its state

    def no_rerun(self, x, t_val, xattn, cache, start, need_output=True):
        if not need_output:                                 # the cache write left out
            return None, None
        return fwd(self, x, t_val, xattn, cache, start, need_output)

    def altered_latents(self, *a, **k):
        x0, cache = denoise(self, *a, **k)
        return x0.flip(1), cache                            # an answer altered where made

    def altered_pixels(self, z, cache, first):
        px, cache = decode(self, z, cache, first)
        return px.flip(2), cache

    return {"state_unchanged": (SemiARGenerator, "denoise_block", unchanged),
            "rerun_left_out": (SemiARGenerator, "_forward", no_rerun),
            "latents_altered": (SemiARGenerator, "denoise_block", altered_latents),
            "pixels_altered": (CausalVAE, "decode_chunk", altered_pixels)}


@pytest.mark.parametrize("fault", ["state_unchanged", "rerun_left_out", "latents_altered",
                                   "pixels_altered"])
def test_a_fault_of_the_timed_path_is_not_correct(fault, monkeypatch):
    owner, name, fn = _fault_patches()[fault]
    monkeypatch.setattr(owner, name, fn)
    res = small_run(seed=11)
    assert not res["correct"], res["checks"]


# -- the process --------------------------------------------------------------


def test_no_benchmark_module_loads_the_jax_stack():
    code = (
        "import sys, torch; sys.path.insert(0, %r)\n"
        "from benchmark import harness, run, calibrate, weights\n"
        "import benchmark.counts.wan, benchmark.reference.wan_dit, benchmark.reference.wan_vae\n"
        "for kind in ('drivers', 'metrics'):\n"
        "    for p in sorted((harness.BENCH / kind).glob('*.py')):\n"
        "        harness.load_module(kind, p.stem)\n"
        "print(harness.forbidden_modules())\n" % str(ROOT))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         cwd=ROOT, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_forbidden_modules_compare_whole_top_level_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "inferix_tpu_torch_lookalike", object())
    assert "inferix_tpu" not in harness.forbidden_modules()
    monkeypatch.setitem(sys.modules, "inferix_tpu.fake", object())
    assert "inferix_tpu" in harness.forbidden_modules()


def test_run_exits_without_a_card_and_prints_nothing():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    out = subprocess.run([sys.executable, "benchmark/run.py", "--workload", CELL, "--seed",
                          "4294967311", "--seconds", "1", "--trace", "0"],
                         capture_output=True, text=True, cwd=ROOT, timeout=300)
    assert out.returncode != 0 and out.stdout == ""


@pytest.mark.card
def test_a_short_run_on_the_card_is_correct():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    out = subprocess.run([sys.executable, "benchmark/run.py", "--workload", CELL, "--seed",
                          "4294967311", "--seconds", "1", "--trace", "0"],
                         capture_output=True, text=True, cwd=ROOT, timeout=1200)
    assert out.returncode == 0, out.stderr[-4000:]
    assert json.loads(out.stdout.strip().splitlines()[-1])["correct"]
