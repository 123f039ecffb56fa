"""Run the service's CLI gate many times and count how often it fails.

    python tools/pgserve_gate_repeats.py --src PATH [--src PATH ...] [--runs 20]
                                         [--cold-every-report] [--device cuda]

Runs ``python -m repro_torch.launch.pgserve --smoke --device DEVICE`` with
each ``--src`` directory's ``repro_torch`` first on ``PYTHONPATH``, in
turns (the checkouts alternate run by run, so a slow stretch of the host
falls on all of them), ``--runs`` times each.  ``--cold-every-report``
runs each checkout's gate from a temporary copy of its ``src`` whose
``launch/pgserve.py`` empties the CUDA allocator's cache before every
EXPLAIN ANALYZE report, so that every report, the warm ones too, pays the
first call's allocations: the case the gate's ``compile_ms`` comparison is
there to tell apart (the copy is made by editing the text; a checkout whose
text lacks the line it edits is refused).  Prints one JSON line: the card's
name and power limit, and per checkout the failures, the runs, each run's
seconds and the last lines of the failing runs' output.
"""
from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path

# every ``pg.explain_analyze(`` call of the gate becomes one made cold
REPORT = "pg.explain_analyze(pool[0])"
COLD = "(torch.cuda.empty_cache(), pg.explain_analyze(pool[0]))[1]"


def cold_copy(src: Path, into: Path) -> Path:
    """A copy of ``src`` whose gate empties the allocator's cache before
    every EXPLAIN ANALYZE report."""
    out = into / "src"
    shutil.copytree(src, out, ignore=shutil.ignore_patterns("__pycache__"))
    path = out / "repro_torch" / "launch" / "pgserve.py"
    text = path.read_text()
    if text.count(REPORT) < 2:
        raise SystemExit(f"{path}: fewer than two '{REPORT}' to make cold")
    path.write_text(text.replace(REPORT, COLD))
    return out


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--src", action="append", required=True, help="a checkout's src directory")
    ap.add_argument("--runs", type=int, default=20)
    ap.add_argument("--cold-every-report", action="store_true")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--timeout", type=float, default=300.0, help="seconds a run may take")
    args = ap.parse_args()

    smi = (subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True)
           .stdout.strip().splitlines() if shutil.which("nvidia-smi") else [])
    tmp = Path(tempfile.mkdtemp(prefix="pgserve_gate_"))
    try:
        srcs = {}
        for i, s in enumerate(args.src):
            src = Path(s).resolve()
            srcs[s] = cold_copy(src, tmp / str(i)) if args.cold_every_report else src
        result = {s: {"failures": 0, "runs": 0, "seconds": [], "failed_tails": []}
                  for s in args.src}
        for _ in range(args.runs):
            for s, src in srcs.items():
                env = {**os.environ, "PYTHONPATH": str(src)}
                t0 = time.perf_counter()
                try:
                    proc = subprocess.run([sys.executable, "-m", "repro_torch.launch.pgserve",
                                           "--smoke", "--device", args.device], env=env,
                                          capture_output=True, text=True, timeout=args.timeout,
                                          cwd=tmp)
                    ok, tail = proc.returncode == 0, (proc.stdout + proc.stderr)[-600:]
                except subprocess.TimeoutExpired:
                    ok, tail = False, f"timed out after {args.timeout} s"
                r = result[s]
                r["runs"] += 1
                r["seconds"].append(round(time.perf_counter() - t0, 2))
                if not ok:
                    r["failures"] += 1
                    r["failed_tails"].append(tail)
        print(json.dumps({"device": smi[0] if smi else None, "device_arg": args.device,
                          "cold_every_report": args.cold_every_report, "checkouts": result}))
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


if __name__ == "__main__":
    main()
