"""Dry run: every (arch × shape) cell's step traced at its full published
shape on fake tensors, and its cost counted.

    python -m repro_torch.launch.dryrun --all [--device cpu] [--out PATH] [--jobs N]
    python -m repro_torch.launch.dryrun --arch gemma2-9b [--shape train_4k]

The port of ``src/repro/launch/dryrun.py``, with its flags (``--arch``,
``--shape``, ``--all``, ``--multi-pod``, ``--both-meshes``, ``--out``) and
``--device``: the CUDA card unless ``--device cpu``.  Per cell,
``launch/steps.build_cell`` on the production mesh gives the step and its
abstract arguments; the arguments become fake tensors on the device
(``FakeTensorMode``: shapes and dtypes, no memory), and the step runs once
under ``launch/hlo_analysis.CostCounter``, whole on that one device.  The
hand kernels' launches are charged by formula (``kernels/_cost.py``); no
kernel and no plain version runs.

Each record (one per cell, written to ``--out``, default
``artifacts/dryrun_torch.json``) holds the whole step's ``flops`` (matmul
class only, as the reference counts ``dot``), ``flops_bf16``,
``flops_by_dtype``, ``bytes`` (the reference's write-side proxy over eager
operations, not comparable with XLA's fused figure), ``kernel_flops``,
``kernel_bytes`` and ``kernels`` (each kernel's calls, FLOPs, bytes and
whether its rows were charged from shapes), ``peak_bytes`` (live bytes on
the one device), ``argument_bytes`` and ``argument_bytes_per_dev`` (under
the spec rules on the production mesh), ``coll_bytes`` (None: the whole
step runs on one device; ``coll_bytes_reason`` says where the traffic is)
and ``trace_s``.

Each cell is traced a second time as the reference compiles it: as one
device's program on the production mesh.  ``launch/mesh.fake_device_mesh``
makes the mesh a ``DeviceMesh`` over a fake process group (256 ranks, 512
with ``--multi-pod``), the arguments become this rank's fake shards
(``sharding.tree_named``) and the step runs over DTensors
(``steps.run_partitioned``) under the counter, which books the
collectives DTensor issues.  The record gains rank 0's ``flops_per_dev``,
``flops_bf16_per_dev``, ``kernel_flops_per_dev``, ``kernels_per_dev``,
``peak_bytes_per_dev``, ``coll_bytes_per_dev``,
``coll_by_kind`` and ``coll_count`` (the reference's keys and ring model)
and ``partition_trace_s``: the LMs through their sharding hints
(``models/transformer.py``, ``nn/moe.py``), the GNNs through the sharded
gather and scatter (``graph/segment_ops.py``; GCN's B5 on the rank's own
edges, GraphCast's ``_constrain``), DLRM through B4 on the rank's row
window of the tables and a per-rank top-k (``models/dlrm.py``).  A
skipped cell's record says so.  It prints
the reference's ``[ok]``, ``[skip]`` and ``[cached]`` lines and exits 1
if any cell failed.

Fake tensors cost the host ~0.1–0.5 ms an operation, and DTensor adds its
sharding propagation to each, so ``--all`` takes minutes on one core;
``--jobs N`` traces the cells in N worker processes (the LM training cells
first; a cell's whole step and its per-device program in two), each
with its own process group.
"""
from __future__ import annotations

import argparse
import json
import multiprocessing
import os
import time
import traceback
from concurrent.futures import ProcessPoolExecutor
from typing import Dict, Optional

import torch

from repro_torch.core.device import resolve_device
from repro_torch.launch.hlo_analysis import CostCounter
from repro_torch.launch.mesh import fake_device_mesh, make_production_mesh
from repro_torch.launch.sharding import tree_named
from repro_torch.launch.steps import (argument_bytes_per_dev, build_cell, map_tensors,
                                      run_partitioned)

__all__ = ["run_cell", "partitioned_record", "trace_step", "trace_partitioned", "fake_args",
           "main"]

COLL_BYTES_REASON = ("the whole step runs on one device; one device's collectives on the "
                     "production mesh are coll_bytes_per_dev")

_MOE_FIELDS = ("moe_groups", "moe_virtual_split", "moe_expert_axis", "moe_tp_axis")


def fake_args(args, device):
    """The abstract arguments as fake tensors on ``device``; call inside a
    ``FakeTensorMode``."""
    return map_tensors(lambda t: torch.empty(t.shape, dtype=t.dtype, device=device), args)


def trace_step(step_fn, args, device):
    """``step_fn`` run once on fake tensors made from ``args`` on
    ``device``, under a ``CostCounter``: its totals."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    with FakeTensorMode():
        fake = fake_args(args, device)
        with CostCounter(arguments=fake) as counter:
            step_fn(*fake)
        del fake
    return counter.totals()


def trace_partitioned(step_fn, args, in_specs, mesh, device):
    """``step_fn`` run once as rank 0's program on ``mesh`` (an
    ``AbstractMesh``) over a fake process group, its arguments fake shards
    on ``device`` placed by ``in_specs``, under a ``CostCounter``: its
    totals, one device's."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    device = torch.device(device)
    with fake_device_mesh(mesh, device.type) as dmesh, FakeTensorMode():
        dargs = tree_named(dmesh, in_specs, args)
        with CostCounter(arguments=dargs) as counter:
            run_partitioned(step_fn, dargs)
        del dargs
    return counter.totals()


def partitioned_fields(tot, trace_s: float) -> Dict:
    """A record's per-device fields from ``trace_partitioned``'s totals."""
    return {"flops_per_dev": tot["flops"], "flops_bf16_per_dev": tot["flops_bf16"],
            "kernel_flops_per_dev": tot["kernel_flops"], "kernels_per_dev": tot["kernels"],
            "peak_bytes_per_dev": tot["peak_bytes"],
            "coll_bytes_per_dev": tot["coll_bytes"] or 0.0,
            "coll_by_kind": tot["coll_by_kind"], "coll_count": tot["coll_count"],
            "partition_trace_s": trace_s}


def partitioned_record(arch: str, shape: str, *, multi_pod: bool = False, device=None,
                       verbose: bool = True) -> Dict:
    """A cell's per-device fields: its step traced as rank 0's program on
    the production mesh (``trace_partitioned``)."""
    device = resolve_device(device)
    mesh = make_production_mesh(multi_pod=multi_pod)
    _, step_fn, args, in_specs, _, _ = build_cell(arch, shape, mesh)
    t0 = time.perf_counter()
    tot = trace_partitioned(step_fn, args, in_specs, mesh, device)
    rec = {**partitioned_fields(tot, time.perf_counter() - t0),
           "coll_bytes_reason": COLL_BYTES_REASON}
    if verbose:
        print(f"[ok] {arch} × {shape} per device ({'2-pod' if multi_pod else '1-pod'}, "
              f"{device.type}): trace {rec['partition_trace_s']:.1f}s "
              f"flops={rec['flops_per_dev']:.3e} peak={rec['peak_bytes_per_dev'] / 2**30:.2f}GiB "
              f"coll={rec['coll_bytes_per_dev']:.3e}B {rec['coll_by_kind']}", flush=True)
    return rec


def run_cell(arch: str, shape: str, *, multi_pod: bool = False, device=None,
             verbose: bool = True, partitioned: bool = True) -> Optional[Dict]:
    """One cell's record; its per-device fields too unless ``partitioned``
    is False (``main --jobs`` traces them in another worker)."""
    device = resolve_device(device)
    mesh = make_production_mesh(multi_pod=multi_pod)
    built = build_cell(arch, shape, mesh)
    if built is None:
        from repro_torch.configs.registry import SKIPPED_CELLS

        if verbose:
            print(f"[skip] {arch} × {shape}: {SKIPPED_CELLS[(arch, shape)]}", flush=True)
        return {"arch": arch, "shape": shape, "multi_pod": multi_pod, "device": device.type,
                "skipped": True}
    kind, step_fn, args, in_specs, _, cfg = built
    t0 = time.perf_counter()
    tot = trace_step(step_fn, args, device)
    trace_s = time.perf_counter() - t0
    rec = {
        "arch": arch, "shape": shape, "kind": kind, "multi_pod": multi_pod,
        "device": device.type, "mesh": mesh.shape, "n_devices": mesh.size,
        # the whole step's work, run on one device (the reference's are per device)
        "flops": tot["flops"], "flops_bf16": tot["flops_bf16"],
        "flops_by_dtype": tot["flops_by_dtype"], "bytes": tot["bytes"],
        "kernel_flops": tot["kernel_flops"], "kernel_bytes": tot["kernel_bytes"],
        "kernels": tot["kernels"], "peak_bytes": tot["peak_bytes"],
        "argument_bytes": tot["argument_bytes"],
        "argument_bytes_per_dev": argument_bytes_per_dev(args, in_specs, mesh),
        "coll_bytes": None, "coll_bytes_reason": COLL_BYTES_REASON,
        "trace_s": trace_s, "skipped": False,
    }
    if getattr(cfg, "n_experts", None):
        rec["moe"] = {k: getattr(cfg, k) for k in _MOE_FIELDS}
    if verbose:
        charges = {k: v["calls"] for k, v in rec["kernels"].items()}
        print(f"[ok] {arch} × {shape} ({kind}, {'2-pod' if multi_pod else '1-pod'}, "
              f"{device.type}): trace {trace_s:.1f}s | flops={rec['flops']:.3e} "
              f"kernel_flops={rec['kernel_flops']:.3e} kernel_bytes={rec['kernel_bytes']:.3e} "
              f"charges={charges} | peak={rec['peak_bytes'] / 2**30:.2f}GiB "
              f"args/dev={rec['argument_bytes_per_dev'] / 2**30:.3f}GiB", flush=True)
    if partitioned:
        rec.update(partitioned_record(arch, shape, multi_pod=multi_pod, device=device,
                                      verbose=verbose))
    return rec


def _family(arch: str) -> Optional[str]:
    """The arch's family; None for an unknown arch (its cell fails where it runs)."""
    from repro_torch.configs.registry import ARCHS

    return ARCHS[arch].FAMILY if arch in ARCHS else None


def _lm_training(arch: str, shape: str) -> bool:
    from repro_torch.configs.common import LM_SHAPES

    return _family(arch) == "lm" and LM_SHAPES[shape]["kind"] == "train"


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description="dry run of every (arch × shape) cell on fake "
                                             "tensors")
    ap.add_argument("--arch", type=str, default=None)
    ap.add_argument("--shape", type=str, default=None)
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--out", type=str, default="artifacts/dryrun_torch.json")
    ap.add_argument("--device", type=str, default=None,
                    help="where the fake tensors live: the CUDA card unless 'cpu'")
    ap.add_argument("--jobs", type=int, default=1, help="worker processes tracing cells")
    args = ap.parse_args(argv)

    from repro_torch.configs.registry import SKIPPED_CELLS, arch_shapes, list_cells

    if args.all:
        cells = [(a, s) for a, s, _ in list_cells()]
    elif args.arch and args.shape:
        cells = [(args.arch, args.shape)]
    elif args.arch:
        cells = [(args.arch, s) for s in arch_shapes(args.arch)]
    else:
        ap.error("--all or --arch [--shape] required")

    device = resolve_device(args.device)
    meshes = [False, True] if args.both_meshes else [args.multi_pod]
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    records = []
    if os.path.exists(args.out):
        with open(args.out) as f:
            records = json.load(f)
    done = {(r["arch"], r["shape"], r["multi_pod"], r.get("device")) for r in records}

    todo = []
    for mp in meshes:
        for a, s in cells:
            if (a, s, mp, device.type) in done:
                print(f"[cached] {a} × {s} multi_pod={mp}", flush=True)
            else:
                todo.append((a, s, mp))
    failures = []
    t0 = time.perf_counter()

    def finish(cell, result):
        try:
            records.append(result())
            with open(args.out, "w") as f:
                json.dump(records, f, indent=1)
        except Exception as e:  # noqa: BLE001  (every cell is tried; the exit code tells)
            traceback.print_exc()
            failures.append((*cell, str(e)[:200]))

    if args.jobs > 1:  # a cell's whole-step and per-device traces in two workers
        todo.sort(key=lambda c: not _lm_training(c[0], c[1]))  # the longest traces first
        with ProcessPoolExecutor(args.jobs, mp_context=multiprocessing.get_context("spawn")) \
                as pool:
            futures = []
            for a, s, mp in todo:
                kw = dict(multi_pod=mp, device=device.type)
                whole = pool.submit(run_cell, a, s, partitioned=False, **kw)
                part = (pool.submit(partitioned_record, a, s, **kw)
                        if (a, s) not in SKIPPED_CELLS else None)
                futures.append(((a, s, mp), whole, part))
            for cell, whole, part in futures:
                finish(cell, lambda: {**whole.result(), **(part.result() if part else {})})
    else:
        for a, s, mp in todo:
            finish((a, s, mp), lambda: run_cell(a, s, multi_pod=mp, device=device))
    if failures:
        print("\nFAILURES:")
        for f in failures:
            print(" ", f)
        raise SystemExit(1)
    print(f"\nall {len(cells)}×{len(meshes)} cells ok in {time.perf_counter() - t0:.1f}s "
          f"→ {args.out}", flush=True)


if __name__ == "__main__":
    main()
