"""The benchmark harness on the CPU: its generators, metric arithmetic,
loading by name, import hygiene, whole tiny runs of both cells, the runs
with the timed path broken underneath (each must come out not correct),
and the controls."""
import ast
import json
import math
import re
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
for p in (str(ROOT / "src"), str(ROOT)):
    if p not in sys.path:
        sys.path.insert(0, p)

from cardbench import control, generator, graphdata, profiled, run  # noqa: E402

BENCH = run.load_json("BENCHMARK.json")
CELLS = [w["name"] for w in BENCH["workloads"]]
MATCH, ANALYTICS = "graph3.match_serve", "graph500-s20.graphalytics"
TINY = {"graph3": {"edges": 3000, "vertex_pool": 1500}, "graph500-s20": {"scale": 9}}
FEW = {"labels": {"count": 4, "prefix": "l", "coverage": 1.0},
       "relationships": {"count": 4, "prefix": "r", "coverage": 1.0}}


def tiny_plan(cell: str) -> dict:
    """The cell's plan at a size the CPU runs in a second: few vertices,
    four labels and relationships (so that answers are not empty), four
    clients."""
    plan = run.cell_plan(BENCH, cell)
    plan["cfg"].update(TINY[plan["cell"]["config"]], **FEW)
    mix = plan["mix"]
    mix["warm_s"] = 0.2
    if "clients" in mix:
        mix["clients"] = 4
        for p in mix["params"]:
            if p["match"] in ("L[0-9]+", "R[0-9]+"):
                p["range"] = [0, 4]
    return plan


# ------------------------------------------------------------- generators
def test_pattern_streams_repeat_per_seed():
    mix = run.load_json("cardbench/traffic/match_serve.json")

    def draws(seed, client):
        s = generator.PatternStream(mix, seed, generator.WINDOW_STREAM, client,
                                    {k: list(range(40)) for k in mix["anchors"]["fields"]})
        return [s.next() for _ in range(24)]

    big = 2**31 + 12345
    assert draws(big, 3) == draws(big, 3)
    assert draws(big, 3) != draws(big, 4) and draws(big, 3) != draws(big + 1, 3)
    kinds = [k for k, _ in draws(big, 0)]
    assert all(kinds.count(t["kind"]) == 4 for t in mix["templates"])  # equal shares


def test_pattern_streams_repeat_across_processes():
    # placeholders are drawn in one fixed order, whatever the process's hash seed
    import subprocess

    code = ("import json, sys; sys.path[:0] = [sys.argv[1]]; from cardbench import generator, run; "
            "mix = run.load_json('cardbench/traffic/match_serve.json'); "
            "s = generator.PatternStream(mix, 2**31 + 77, generator.WINDOW_STREAM, 1, "
            "{k: [7] for k in mix['anchors']['fields']}); "
            "print(json.dumps([s.next() for _ in range(12)]))")
    outs = {subprocess.run([sys.executable, "-c", code, str(ROOT)], cwd=ROOT, check=True,
                           capture_output=True, text=True,
                           env={"PYTHONHASHSEED": str(h), "PATH": "/usr/bin:/bin"}).stdout
            for h in (1, 2, 3)}
    assert len(outs) == 1


def _anchored_case(seed=2**31 + 21):
    plan = tiny_plan(MATCH)
    data = graphdata.make(plan["cfg"], seed, "cpu")
    anchored = generator.anchors(plan["mix"], data, seed)
    return plan, data, anchored


def test_anchored_predicates_hold_their_anchor_edge():
    from cardbench.reference import patterns

    plan, data, anchored = _anchored_case()
    mix = dict(plan["mix"], templates=[t for t in plan["mix"]["templates"] if t.get("anchored")])
    g = patterns.Graph(data, plan["cfg"], "cpu")
    low = patterns.Graph(data, plan["cfg"], "cpu", prop_dtype=torch.bfloat16)
    stream = generator.PatternStream(mix, 5, generator.WINDOW_STREAM, 0, anchored)
    for _ in range(8):
        _, text = stream.next()
        want, lower = patterns.match(g, text), patterns.match(low, text)
        assert bool(want["edge_mask"].any()), text  # the anchor edge matches
        assert patterns.mismatched_bits(lower, want) > 0, text  # a bfloat16 column drops it
    # the same seed draws the same anchors
    assert generator.anchors(plan["mix"], data, 2**31 + 21) == anchored


def test_undirected_data_is_simple_and_symmetric():
    cfg = dict(run.load_json("cardbench/configs/graph500-s20.json"), **TINY["graph500-s20"])
    d = graphdata.make(cfg, 2**31 + 8, "cpu")
    n, key = d["n"], d["esrc"] * d["n"] + d["edst"]
    twin = torch.searchsorted(key, d["edst"] * n + d["esrc"])
    assert torch.equal(key[twin], d["edst"] * n + d["esrc"])  # both directions stored
    assert bool((d["esrc"] != d["edst"]).all())  # no self-loops
    assert torch.equal(d["eprops"]["w"], d["eprops"]["w"][twin])  # one w per edge
    half = len(d["rel_ent"]) // 2
    assert torch.equal(twin[d["rel_ent"][:half]], d["rel_ent"][half:])  # one relationship
    assert torch.equal(d["rel_id"][:half], d["rel_id"][half:])


@pytest.mark.parametrize("config", ["graph3", "graph500-s20"])
def test_graph_data_repeats_per_seed(config):
    cfg = dict(run.load_json(f"cardbench/configs/{config}.json"), **TINY[config])
    a, b = graphdata.make(cfg, 2**31 + 9, "cpu"), graphdata.make(cfg, 2**31 + 9, "cpu")
    c = graphdata.make(cfg, 2**31 + 10, "cpu")
    for key in ("src", "dst", "esrc", "edst", "label_ent", "label_id", "rel_ent", "rel_id"):
        assert torch.equal(a[key], b[key])
    assert not torch.equal(a["src"], c["src"])
    assert torch.equal(a["eprops"]["w"], b["eprops"]["w"])
    # the harness's numbering: sorted distinct ids, distinct (src, dst) pairs in order
    key = a["esrc"] * a["n"] + a["edst"]
    assert bool((key[1:] > key[:-1]).all()) and a["m"] == len(key)


# -------------------------------------------------------- metric arithmetic
def _records(times_ms, ok=None):
    ok = ok or [True] * len(times_ms)
    return [{"kind": "k", "t0": 0.0, "t1": t / 1e3, "ok": o, "error": None if o else "x"}
            for t, o in zip(times_ms, ok)]


def test_p95_is_over_every_request_and_counts_failures():
    p95 = run.load_module("e2e", "match_p95_ms")
    times = list(range(1, 101))  # 1..100 ms
    assert p95.read({"records": _records(times)}) == pytest.approx(95.0)
    # five failed requests push the 95th percentile past every answered one
    failed = _records(times, ok=[True] * 94 + [False] * 6)
    assert p95.read({"records": failed}) == math.inf


def test_rates_are_window_totals():
    qps = run.load_module("e2e", "match_qps")
    ms = run.load_module("e2e", "analytics_ms")
    recs = _records([5.0] * 30, ok=[True] * 29 + [False])
    assert qps.read({"records": recs, "window": (10.0, 12.0)}) == pytest.approx(29 / 2.0)
    assert ms.read({"records": recs, "window": (10.0, 12.0)}) == pytest.approx(2000 / 29)


def test_profile_reduction():
    ev = [{"ph": "X", "cat": "kernel", "name": "k1", "ts": 0, "dur": 10},
          {"ph": "X", "cat": "kernel", "name": "k2", "ts": 5, "dur": 10},
          {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy DtoH", "ts": 40, "dur": 5},
          {"ph": "X", "cat": "cpu_op", "name": "aten::item", "ts": 14, "dur": 30}]
    s = profiled.reduce(ev, window_s=1e-4)
    assert s["busy_s"] == pytest.approx(20e-6)  # [0, 15] ∪ [40, 45]
    assert s["idle_gaps"] == [["aten::item", pytest.approx(25e-6)]]
    assert profiled.device_launches(s, "Memcpy") == 1
    assert s["device_ops"][0][0] in ("k1", "k2")
    idle = run.load_module("metrics", "idle_share.analytics")
    assert idle.read({"slice": dict(s, calls=2, complete=True)}) == pytest.approx(0.8)
    assert idle.read({"slice": dict(s, calls=2, complete=False)}) is None


# ------------------------------------------------------- loading by name
def test_every_named_piece_loads_by_file_name():
    for cell in CELLS:
        plan = run.cell_plan(BENCH, cell)
        assert plan["end_to_end"] and plan["per_layer"]
        assert (ROOT / "cardbench/drivers" / f"{plan['mix']['driver']}.py").is_file()
    for m in BENCH["end_to_end"]:
        if m["name"] != "setup_s":
            assert callable(run.load_module("e2e", m["name"]).read)
    for m in BENCH["per_layer"]:
        assert callable(run.load_module("metrics", m["name"]).read)
    with pytest.raises(FileNotFoundError):
        run.load_module("metrics", "no_such_metric")


def test_benchmark_file_keeps_its_contract():
    name = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e and 1 <= BENCH["run_seconds"] <= 51
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e and name.match(m["name"])
    for c in BENCH["configs"]:
        assert (ROOT / c["file"]).is_file() and c["file"].startswith("cardbench/")
        assert json.loads((ROOT / c["file"]).read_text())["reduced"] == c["reduced"]
    for w in BENCH["workloads"]:
        assert name.match(w["name"]) and w["chips"] == 1 and len(w["why"]) <= 200
    assert len(json.dumps(BENCH)) < 64 * 1024


BANNED = {"jax", "jaxlib", "flax", "repro", "benchmarks", "chip_smoke"}


def _imports(path: Path) -> set:
    tree = ast.parse(path.read_text())
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            out.add(node.module.split(".")[0])
    return out


def test_imports_no_reference_package_and_reference_no_program():
    files = list((ROOT / "cardbench").rglob("*.py"))
    assert len(files) > 20
    for f in files:
        assert not (_imports(f) & BANNED), f  # whole top-level names: repro_torch is fine
    for f in (ROOT / "cardbench/reference").glob("*.py"):
        assert "repro_torch" not in _imports(f), f
    assert run.banned_modules(["repro_torch.core", "torch", "jaxtyping"]) == []
    assert run.banned_modules(["repro.core.di", "jax.numpy", "flax"]) == ["flax", "jax", "repro"]


# ---------------------------------------------------------- whole runs
@pytest.mark.parametrize("cell", [MATCH, ANALYTICS])
def test_tiny_run_is_correct(cell):
    res = run.run_cell(tiny_plan(cell), 2**31 + 3, 0.5, False, device="cpu")
    assert res["correct"], res["checks"]
    assert res["attempted"] > 0 and res["failed"] == 0
    want = {m["name"] for m in run.cell_plan(BENCH, cell)["end_to_end"]}
    assert set(res["metrics"]) == want
    assert list(res)[-1] == "checks"
    assert res["checks"]["answers_compared"]["value"] > 0


def _flip_first(t):
    t = t.clone()
    t[0] = ~t[0] if t.dtype == torch.bool else t[0] + 1
    return t


FAULTS = {
    # an answer altered where it is produced
    "match_answer_altered": (MATCH, "repro_torch.query.executor", "_propagate",
                             lambda f: lambda *a, **k: (lambda r: (_flip_first(r[0]),) + r[1:])(
                                 f(*a, **k))),
    # half of each coalesced mask batch left out
    "match_half_batch_dropped": (MATCH, "repro_torch.kernels.bitmap_query.ops",
                                 "bitmap_query_batched_packed",
                                 lambda f: lambda plane, masks: torch.cat(
                                     [f(plane, masks)[:(masks.shape[0] + 1) // 2],
                                      torch.zeros_like(f(plane, masks)[(masks.shape[0] + 1) // 2:])])
                                 if masks.shape[0] > 1 else torch.zeros_like(f(plane, masks))),
    # a relax step that returns its state unchanged
    "analytics_step_unchanged": (ANALYTICS, "repro_torch.traverse.analytics", "_relax",
                                 lambda f: lambda tail, head, n, x, *a, **k: torch.full_like(
                                     x, False if x.dtype == torch.bool else
                                     (0 if not x.is_floating_point() else float("inf")))),
    # an answer altered where it is produced
    "analytics_answer_altered": (ANALYTICS, "repro_torch.traverse", "label_propagation_masked",
                                 lambda f: lambda *a, **k: _flip_first(f(*a, **k))),
}


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_broken_timed_path_is_not_correct(fault, monkeypatch):
    import importlib

    cell, module, attr, wrap = FAULTS[fault]
    mod = importlib.import_module(module)
    monkeypatch.setattr(mod, attr, wrap(getattr(mod, attr)))
    res = run.run_cell(tiny_plan(cell), 2**31 + 4, 0.4, False, device="cpu")
    assert not res["correct"], res["checks"]


@pytest.mark.parametrize("cell", [MATCH, ANALYTICS])
def test_control_fails_a_compared_number(cell):
    plan = tiny_plan(cell)
    if cell == MATCH:  # long enough chains for an unrolled closure to miss walks
        plan["cfg"].update(edges=2000, vertex_pool=800,
                           relationships={"count": 2, "prefix": "r", "coverage": 1.0})
        for p in plan["mix"]["params"]:
            if p["match"] == "R[0-9]+":
                p["range"] = [0, 2]
    out = control.judged(plan, 2**31 + 6, "cpu")
    assert set(out) == ({"bfloat16_columns", "unrolled_closure"} if cell == MATCH
                        else {"bfloat16"})
    for name, verdict in out.items():
        assert not verdict["correct"], (name, verdict)  # the cell's own comparison refuses it


@pytest.mark.cuda
@pytest.mark.parametrize("cell", [MATCH, ANALYTICS])
def test_control_fails_at_the_cells_own_size_on_the_card(cell):
    if not torch.cuda.is_available():
        pytest.skip("the cell's own size needs an NVIDIA card")
    plan = run.cell_plan(BENCH, cell)
    for seed in (2**31 + 101, 2**31 + 102, 2**31 + 103):
        for name, verdict in control.judged(plan, seed, "cuda").items():
            assert not verdict["correct"], (cell, seed, name, verdict)
