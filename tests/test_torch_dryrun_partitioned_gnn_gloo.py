"""The partitioned GNN and DLRM programs give the reference's partitioned
answers: eight CPU ranks over gloo on a (2, 4) ("data", "model") mesh
(``torch.multiprocessing``, spawned) against the reference's step jitted
with its specs on a (2, 4) mesh of eight host devices (GSPMD, in a
subprocess of its own), the smoke configs in f32 at reduced shapes (the
shape tables overridden alike on both sides).  Each argument leaf is drawn
from a numpy generator seeded by its case and its path in the argument
tree, within the bounds its name gives (ids below the node, edge, species,
class or vocabulary count; MACE's and DimeNet's edges without self loops,
as C.25's tests draw them), so both sides draw the same values; the port's
are placed by the cell's specs (``sharding.tree_named``) and run as every
rank's program (``steps.run_partitioned``).

Cases: GCN (``spmm_di`` on each rank's edges, both layers), MACE,
DimeNet and GraphCast (its hints and split MLPs) training; DLRM training
(an id in [-V, -1]), serving (an id in [-V, -1] and one >= V: B4's plain
version on each rank's row window) and retrieval (the per-rank top-k).  The
loss, the gradient norm, every updated parameter and moment, the logits,
and the retrieval scores agree with the reference's within 1e-5 (NaN where
the reference's is NaN), the retrieval ids bit for bit, and the same with
the single-process port's step on the same arguments.  The reference's
one-device answer of each DLRM case is held too: where GSPMD's differs
from it (ROADMAP §C), the port is held to the one-device answer.
"""
import os
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

ROOT = Path(__file__).resolve().parents[1]
TOL = 1e-5

_COMMON = r'''
import dataclasses, json, sys, zlib
import numpy as np

CASES = [
    ("gcn-cora train", "gcn-cora", "full_graph_sm"),
    ("mace train", "mace", "molecule"),
    ("dimenet train", "dimenet", "molecule"),
    ("graphcast train", "graphcast", "full_graph_sm"),
    ("dlrm-rm2 train", "dlrm-rm2", "train_batch"),
    ("dlrm-rm2 serve", "dlrm-rm2", "serve_p99"),
    ("dlrm-rm2 retrieval", "dlrm-rm2", "retrieval_cand"),
]
GNN = {"full_graph_sm": {"n_nodes": 500, "n_edges": 2000, "d_feat": 32},
       "molecule": {"n_nodes": 6, "n_edges": 16, "batch": 16}}
REC = {"train_batch": {"batch": 64}, "serve_p99": {"batch": 16},
       "retrieval_cand": {"n_candidates": 1000}}


def configure(common, registry, f32):
    """The reduced shapes and smoke configs (in ``f32``, the package's
    float32) in one package's shape tables and registry."""
    for table, over in ((common.GNN_SHAPES, GNN), (common.RECSYS_SHAPES, REC)):
        for name, o in over.items():
            table[name] = {**table[name], **o}
    for arch in ("gcn-cora", "mace", "dimenet", "graphcast", "dlrm-rm2"):
        mod = registry.get_arch(arch)
        smoke = mod.smoke_config
        if arch == "gcn-cora":
            mod.full_config = lambda d_feat=None, n_classes=None, s=smoke: dataclasses.replace(
                s(), d_in=d_feat, n_classes=n_classes)
        elif arch == "dlrm-rm2":  # three top layers, as the production specs list them
            mod.full_config = lambda s=smoke: dataclasses.replace(s(), top_mlp=(32, 16, 8, 1))
        elif arch == "graphcast":
            mod.full_config = lambda s=smoke: dataclasses.replace(s(), dtype=f32)
        else:
            mod.full_config = smoke


def bounds(arch, cfg, n):
    """{leaf name: exclusive upper bound} of the integer leaves."""
    if arch == "graphcast":
        return {"g2m_src": n["n_grid"], "g2m_dst": n["n_mesh"], "mesh_src": n["n_mesh"],
                "mesh_dst": n["n_mesh"], "m2g_src": n["n_mesh"], "m2g_dst": n["n_grid"]}
    if arch == "dlrm-rm2":
        return {"sparse": cfg.vocab_size, "labels": 2}
    out = {"edge_src": n["n_nodes"], "edge_dst": n["n_nodes"], "graph_ids": n["n_graphs"],
           "species": getattr(cfg, "n_species", 1), "edge_attr": n["n_edges"]}
    if arch == "gcn-cora":
        out["labels"] = cfg.n_classes
    return out


def draw(case, arch, path, shape, kind, bound, counts):
    """The value of the argument leaf at ``path``: floats normal · 0.1 (a
    second moment's absolute value), booleans mostly True, integers uniform
    below ``bound`` (no self loops for MACE and DimeNet; DimeNet's triplet
    mask in {0, 1}; DLRM's special ids, module docstring), scalars 0."""
    rng = np.random.default_rng([case, zlib.crc32(path.encode())])
    name = path.rsplit("/", 1)[-1]
    if kind == "float":
        x = rng.standard_normal(tuple(shape), dtype=np.float32) * np.float32(0.1)
        return np.abs(x) if path.startswith("/1/v/") else x
    if kind == "bool":
        return rng.random(tuple(shape)) < 0.9
    if not shape:
        return np.zeros((), np.int64)
    if name == "edge_dst" and arch in ("mace", "dimenet"):  # src + a nonzero step
        src = draw(case, arch, path[:-3] + "src", shape, kind, bound, counts)
        return (src + rng.integers(1, bound, tuple(shape))) % bound
    x = rng.integers(0, bound, tuple(shape))
    if name == "edge_attr":
        x[:, 2] = rng.integers(0, 2, shape[0])
    if name == "sparse":
        v = counts["vocab"]
        x.reshape(-1)[3] = -7  # wraps to V - 7
        if counts["kind"] == "serve":
            x.reshape(-1)[40] = v + 5  # its bag NaN
    return x


def map_paths(fn, tree, prefix=""):
    """``tree`` with each leaf replaced by ``fn(path, leaf)``; a path joins
    dict keys, list or tuple positions and dataclass fields with "/"."""
    if isinstance(tree, dict):
        return {k: map_paths(fn, v, f"{prefix}/{k}") for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(map_paths(fn, v, f"{prefix}/{i}") for i, v in enumerate(tree))
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return dataclasses.replace(tree, **{f.name: map_paths(fn, getattr(tree, f.name),
                                                              f"{prefix}/{f.name}")
                                            for f in dataclasses.fields(tree) if f.init})
    return fn(prefix, tree)


def leaves(tree, prefix=""):
    """(path, leaf) pairs of ``tree``, the paths as ``map_paths`` writes them."""
    out = []
    map_paths(lambda p, x: out.append((p, x)), tree, prefix)
    return out


def sizes(batch):
    """The batch's integer fields by name (node, edge and graph counts)."""
    if isinstance(batch, dict):
        return {}
    return {f.name: getattr(batch, f.name) for f in dataclasses.fields(batch)
            if isinstance(getattr(batch, f.name), int)}
'''

_WORKER = _COMMON + r'''
import torch
import torch.distributed as dist
import torch.multiprocessing as mp


def run(rank, port, out_dir):
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import DTensor

    from repro_torch.configs import common, registry
    from repro_torch.launch.mesh import AbstractMesh
    from repro_torch.launch.sharding import tree_named
    from repro_torch.launch.steps import build_cell, map_tensors, run_partitioned

    torch.set_num_threads(1)
    configure(common, registry, torch.float32)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}", rank=rank,
                            world_size=8)
    dmesh = init_device_mesh("cpu", (2, 4), mesh_dim_names=("data", "model"))
    mesh = AbstractMesh((2, 4), ("data", "model"))
    single, partitioned = {}, {}
    for case, (name, arch, shape) in enumerate(CASES):
        kind, step, abstract, in_specs, _, cfg = build_cell(arch, shape, mesh)
        batch = abstract[-1]
        n = sizes(batch)
        below = bounds(arch, cfg, n)
        counts = {"vocab": getattr(cfg, "vocab_size", 0), "kind": kind}

        def leaf(path, t):
            if not torch.is_tensor(t):
                return t
            k = "float" if t.is_floating_point() else "bool" if t.dtype == torch.bool else "int"
            v = torch.from_numpy(np.asarray(draw(case, arch, path, t.shape, k,
                                                 below.get(path.rsplit("/", 1)[-1], 1),
                                                 counts)))
            return v if k == "float" else v.to(t.dtype)

        args = map_paths(leaf, abstract)
        copy = lambda a: map_tensors(torch.clone, a)  # noqa: E731  (a step writes in place)
        want = step(*copy(args))
        got = run_partitioned(step, tree_named(dmesh, in_specs, copy(args)))
        for path, g in leaves(got):
            g = g.full_tensor() if isinstance(g, DTensor) else g
            partitioned[f"{case}{path}"] = g.numpy() if torch.is_tensor(g) else np.asarray(g)
        for path, w in leaves(want):
            single[f"{case}{path}"] = w.numpy() if torch.is_tensor(w) else np.asarray(w)
    if rank == 0:
        np.savez(f"{out_dir}/partitioned.npz", **partitioned)
        np.savez(f"{out_dir}/single.npz", **single)
    dist.destroy_process_group()


if __name__ == "__main__":
    port, out_dir = int(sys.argv[1]), sys.argv[2]
    mp.start_processes(run, args=(port, out_dir), nprocs=8, start_method="spawn")
'''

_REFERENCE = _COMMON + r'''
import jax
import jax.numpy as jnp
from jax.sharding import Mesh

from repro.configs import common, registry
from repro.launch import steps
from repro.launch.sharding import tree_named

out_dir = sys.argv[1]
configure(common, registry, jnp.float32)
mesh = Mesh(np.array(jax.devices()[:8]).reshape(2, 4), ("data", "model"))
out, one = {}, {}
for case, (name, arch, shape) in enumerate(CASES):
    kind, step, abstract, in_specs, out_specs, cfg = steps.build_cell(arch, shape, mesh)
    batch = abstract[-1]
    n = sizes(batch)
    below = bounds(arch, cfg, n)
    counts = {"vocab": getattr(cfg, "vocab_size", 0), "kind": kind}

    def leaf(path, sds):
        if not hasattr(sds, "dtype"):
            return sds
        k = ("float" if jnp.issubdtype(sds.dtype, jnp.floating)
             else "bool" if sds.dtype == jnp.bool_ else "int")
        v = np.asarray(draw(case, arch, path, sds.shape, k,
                            below.get(path.rsplit("/", 1)[-1], 1), counts))
        return v if k == "float" else v.astype(sds.dtype)

    args = map_paths(leaf, abstract)
    with mesh:
        jitted = jax.jit(step, in_shardings=tree_named(mesh, in_specs),
                         out_shardings=None if out_specs is None else tree_named(mesh, out_specs))
        result = jitted(*args)
    for path, x in leaves(result):
        out[f"{case}{path}"] = np.asarray(x)
    if arch == "dlrm-rm2":  # the reference's one-device answer
        for path, x in leaves(jax.jit(step)(*args)):
            one[f"{case}{path}"] = np.asarray(x)
np.savez(f"{out_dir}/reference.npz", **out)
np.savez(f"{out_dir}/one_device.npz", **one)
'''


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def outputs(tmp_path_factory):
    """{"partitioned", "single", "reference", "one_device"}: {case index:
    {path: array}} of the gloo ranks' partitioned steps, the single-process
    port's, the reference's partitioned program and its one-device step of
    the DLRM cases (both runs at once)."""
    out = tmp_path_factory.mktemp("partitioned_gnn")
    (out / "worker.py").write_text(_WORKER)
    (out / "reference.py").write_text(_REFERENCE)
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src"), "OMP_NUM_THREADS": "1"}
    ref_env = {**env, "XLA_FLAGS": "--xla_force_host_platform_device_count=8",
               "JAX_PLATFORMS": "cpu"}
    procs = [subprocess.Popen([sys.executable, "worker.py", str(_free_port()), str(out)],
                              env=env, cwd=out, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True),
             subprocess.Popen([sys.executable, "reference.py", str(out)], env=ref_env, cwd=out,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)]
    try:
        for proc in procs:
            _, err = proc.communicate(timeout=600)
            assert proc.returncode == 0, err[-6000:]
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    result = {}
    for name in ("partitioned", "single", "reference", "one_device"):
        with np.load(out / f"{name}.npz") as f:
            by_case = {}
            for key in f.files:
                case, _, path = key.partition("/")
                by_case.setdefault(int(case), {})["/" + path] = f[key]
            result[name] = by_case
    return result


RETRIEVAL = 6  # the retrieval case: (scores, ids)


def gaps(got: dict, want: dict) -> dict:
    """{(case, path): largest |got - want| over the finite entries of
    ``want``, inf where the NaNs (or the shapes, or the paths) differ}."""
    out = {}
    for case, w in want.items():
        g = got[case]
        assert set(g) == set(w), (case, set(g) ^ set(w))
        for path in w:
            a, b = np.asarray(g[path], np.float64), np.asarray(w[path], np.float64)
            if a.shape != b.shape or not np.array_equal(np.isnan(a), np.isnan(b)):
                out[(case, path)] = float("inf")
                continue
            ok = ~np.isnan(b)
            out[(case, path)] = float(np.abs(a[ok] - b[ok]).max()) if ok.any() else 0.0
    return out


def _held(got: dict, want: dict) -> None:
    for (case, path), gap in gaps(got, want).items():
        assert gap <= TOL, (case, path, gap)
    assert np.array_equal(got[RETRIEVAL]["/1"], want[RETRIEVAL]["/1"])  # ids bit for bit


def test_partitioned_gnn_and_dlrm_steps_on_eight_gloo_ranks_give_the_references_answers(
        outputs):
    ref, one = outputs["reference"], outputs["one_device"]
    assert sorted(ref) == list(range(7)) and sorted(one) == [4, 5, 6]
    # where GSPMD's answer and the reference's one device's differ, the one device's holds
    apart = {c for c in one if max(gaps({c: ref[c]}, {c: one[c]}).values()) > TOL}
    _held(outputs["partitioned"], {c: one[c] if c in apart else ref[c] for c in ref})
    assert {"/2/loss", "/2/grad_norm"} <= set(ref[0])  # the metrics, beside every parameter
    assert np.isnan(one[5]["/"]).sum() == 1  # the row whose id lies beyond V
    assert np.isfinite(one[4]["/2/loss"])  # the wrapped id trains


def test_partitioned_gnn_and_dlrm_steps_on_eight_gloo_ranks_give_the_single_process_answers(
        outputs):
    assert sorted(outputs["single"]) == list(range(7))
    _held(outputs["partitioned"], outputs["single"])


def test_gspmd_and_one_device_dlrm_answers(outputs):
    """The reference's partitioned DLRM answers against its one-device
    ones: equal within 1e-5 (ROADMAP §C logs none apart)."""
    for (case, path), gap in gaps(outputs["reference"], outputs["one_device"]).items():
        assert gap <= TOL, (case, path, gap)


if __name__ == "__main__":
    pytest.main([__file__, "-q"])
