"""Run one benchmark cell once and print its result line.

    python3 cardbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

The cell, its configuration and its traffic mix are found by name:
``BENCHMARK.json`` names the cell's configuration file and traffic mix,
``cardbench/traffic/<mix>.json`` names its driver
(``cardbench/drivers/<driver>.py``), and every metric is a reader in
``cardbench/e2e/<name>.py`` (end to end) or ``cardbench/metrics/<name>.py``
(per layer).  Adding a cell adds files and entries; nothing here changes.

A run makes the configuration's graph from the seed, ingests it through the
port's normal path on the card, warms the mix's request kinds, measures for
``--seconds`` and then, with the program's state freed, compares the
answers it kept with the plain reference.  With ``--trace 1`` one early
slice of the window runs under ``torch.profiler`` and the per-layer metrics
are reported instead of the end-to-end ones.  The last line of standard
output is the result; the numbers compared, each with its limit, are the
last lines of standard error and the result's last key.
"""
from __future__ import annotations

import os
import time

# the clock is system-wide, so a re-executed run keeps its first start
T_START = float(os.environ.pop("CARDBENCH_T_START", time.perf_counter()))
HASH_SEED = "0"

import argparse  # noqa: E402
import gc  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
HERE = ROOT / "cardbench"
BANNED = ("jax", "jaxlib", "flax", "repro", "benchmarks")  # whole top-level names


def _paths():
    """The checkout's root and ``src`` first; this file's own directory (a
    script's ``sys.path[0]``) out, so that its modules shadow no others."""
    sys.path[:] = [p for p in sys.path if p and Path(p).resolve() != HERE]
    for p in (str(ROOT / "src"), str(ROOT)):
        if p not in sys.path:
            sys.path.insert(0, p)


def cache_dirs() -> None:
    """Fixed cache directories inside the checkout, so that only a
    checkout's first run builds and compiles."""
    build = ROOT / "build"
    os.environ["TRITON_CACHE_DIR"] = str(build / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(build / "torch_extensions")
    os.environ["CUDA_CACHE_PATH"] = str(build / "nv")


def load_json(rel: str) -> dict:
    with open(ROOT / rel) as f:
        return json.load(f)


def load_module(kind: str, name: str):
    """``cardbench/<kind>/<name>.py`` as a module (names may hold dots)."""
    path = HERE / kind / f"{name}.py"
    if not path.is_file():
        raise FileNotFoundError(f"no {kind} file for {name!r}: {path}")
    spec = importlib.util.spec_from_file_location(f"cardbench_{kind}_{name.replace('.', '_')}",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def cell_plan(bench: dict, workload: str) -> dict:
    """The cell's configuration, traffic mix and metric entries."""
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise KeyError(f"unknown workload {workload!r}; known: {sorted(cells)}")
    cell = cells[workload]
    cfg_entry = {c["name"]: c for c in bench["configs"]}[cell["config"]]

    def applies(metric):
        return workload in metric.get("workloads", [workload])

    e2e = [m for m in bench["end_to_end"] if applies(m)]
    names = {m["name"] for m in e2e}
    layer = [m for m in bench["per_layer"]
             if applies(m) and ("workloads" in m or m["moves"] in names)]
    return {"cell": cell, "cfg": load_json(cfg_entry["file"]),
            "mix": load_json(f"cardbench/traffic/{cell['traffic']}.json"),
            "end_to_end": e2e, "per_layer": layer}


def banned_modules(names=None) -> list:
    """The banned top-level names among ``names`` (default: the loaded
    modules), compared whole: ``repro_torch`` is not ``repro``."""
    names = list(sys.modules) if names is None else names
    return sorted({name.split(".")[0] for name in names} & set(BANNED))


def judge(checks: dict, limits: dict) -> tuple:
    """(correct, {name: {value, limit}}) — every limited number within its
    limit; a number without a limit is reported alone."""
    out, ok = {}, True
    for name, value in checks.items():
        entry = {"value": value if math.isfinite(value) else sys.float_info.max}
        if name in limits:
            entry["limit"] = limits[name]
            ok = ok and value <= limits[name]
        out[name] = entry
    return ok, out


def run_cell(plan: dict, seed: int, seconds: float, trace: bool, device: str = "cuda",
             t_start: float = T_START) -> dict:
    """One run of a cell on ``device``; returns the result line's object."""
    import torch

    from cardbench import graphdata

    cfg, mix = plan["cfg"], plan["mix"]
    split = {}
    if trace:
        from cardbench import profiled

        t = time.perf_counter()
        profiled.warm_up()
        split["profiler_s"] = time.perf_counter() - t
    t = time.perf_counter()
    data = graphdata.make(cfg, seed, device)
    graphdata.sync(device)
    split["data_s"] = time.perf_counter() - t
    t = time.perf_counter()
    pg, steps = graphdata.ingest(cfg, data, device)
    split["ingest_s"] = time.perf_counter() - t
    split["ingest_steps_s"] = steps
    driver = load_module("drivers", mix["driver"]).Driver(cfg, mix, data, pg, seed, device)
    del pg
    t = time.perf_counter()
    driver.warm(mix["warm_s"])
    graphdata.sync(device)
    split["warm_s"] = time.perf_counter() - t
    setup_s = time.perf_counter() - t_start
    split["setup_s"] = setup_s
    print(json.dumps({"setup_split": split}), flush=True)

    cuda = torch.device(device).type == "cuda"
    measured = driver.run(seconds, mix["profile"] if trace else None)
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    driver.close()
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()

    records = measured["records"]
    print(json.dumps({"diagnostics": diagnostics(measured)}), file=sys.stderr)
    failed = sum(not r["ok"] for r in records)
    checks = driver.check()
    checks["failed"] = failed
    checks["kinds_missing"] = len(mix_kinds(mix)) - checks.pop("kinds_compared")
    correct, numbers = judge(checks, dict(mix["limits"], failed=0, kinds_missing=0))
    correct = correct and checks["answers_compared"] > 0

    metrics = {}
    for m in plan["per_layer"] if trace else plan["end_to_end"]:
        value = (setup_s if m["name"] == "setup_s" else
                 load_module("metrics" if trace else "e2e", m["name"]).read(measured))
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    dev = {"platform": "gpu" if cuda else "cpu",
           "kind": torch.cuda.get_device_name(0) if cuda else "cpu",
           "count": int(plan["cell"].get("chips", 1)), "memory_peak_bytes": peak}
    result = {"correct": bool(correct), "attempted": len(records), "failed": failed,
              "metrics": metrics, "device": dev}
    if trace and "slice" in measured:
        s = measured["slice"]
        dev["busy_s"], dev["window_s"] = s["busy_s"], s["window_s"]
        result["breakdown"] = {"device_ops": s["device_ops"], "idle_gaps": s["idle_gaps"]}
        result["profile_complete"] = s["complete"]
        print(json.dumps({"profile_categories": s["categories"],
                          "launches_by_name": dict(sorted(s["launches_by_name"].items(),
                                                          key=lambda kv: -kv[1])[:12])}),
              file=sys.stderr)
    errors = sorted({r["error"] for r in records if r["error"]})[:5]
    if errors:
        result["errors"] = errors
    result["checks"] = numbers
    return result


def diagnostics(measured: dict) -> dict:
    """Per kind the count and median ms, and the completions in each fifth
    of the window: what a reader of one run needs to see a stall."""
    t0, t1 = measured["window"]
    by_kind: dict = {}
    for r in measured["records"]:
        by_kind.setdefault(r["kind"], []).append((r["t1"] - r["t0"]) * 1e3)
    fifths = [0] * 5
    for r in measured["records"]:
        fifths[min(4, int(5 * (r["t1"] - t0) / max(t1 - t0, 1e-9)))] += 1
    out = {"by_kind": {k: [len(v), sorted(v)[len(v) // 2]] for k, v in by_kind.items()},
           "completions_by_fifth": fifths}
    out.update(measured.get("extra", {}))
    return out


def mix_kinds(mix: dict) -> set:
    return {t["kind"] for t in mix.get("templates", mix.get("calls", ()))}


def fixed_hash_seed(argv) -> None:
    """Run under one fixed ``PYTHONHASHSEED``: re-execute this process
    (the same process, no child) once with it set.  The order in which
    the program and the harness walk sets of strings then is the same in
    every run, not drawn anew by each process."""
    if os.environ.get("PYTHONHASHSEED") == HASH_SEED:
        return
    sys.stdout.flush()
    env = dict(os.environ, PYTHONHASHSEED=HASH_SEED, CARDBENCH_T_START=repr(T_START))
    os.execve(sys.executable, [sys.executable, str(Path(__file__).resolve()), *argv], env)


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else list(argv)
    fixed_hash_seed(argv)
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    cache_dirs()
    _paths()
    import torch

    plan = cell_plan(load_json("BENCHMARK.json"), args.workload)
    chips = int(plan["cell"].get("chips", 1))
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"cardbench: the cell needs {chips} CUDA device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 3
    try:
        import repro_torch  # noqa: F401  (the program under test, from the checkout's src)
    except ImportError as e:
        print(f"cardbench: the program is not in this checkout: {e}", file=sys.stderr)
        return 5
    result = run_cell(plan, args.seed, args.seconds, bool(args.trace))
    found = banned_modules()
    if found:
        print(f"cardbench: the run loaded {found}, which the port must not use",
              file=sys.stderr)
        return 4
    for name, entry in result["checks"].items():
        print(f"check {name} = {entry['value']}"
              + (f" (limit {entry['limit']})" if "limit" in entry else ""), file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
