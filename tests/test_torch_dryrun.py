"""The port's dry run (``launch/steps.py``, ``launch/dryrun.py``, the cell
registry, the production meshes and the spec rules) against the
reference's on the CPU.

* Every one of the 40 (arch × shape) cells on both production meshes, as
  ``jax.sharding.AbstractMesh`` (16, 16) and (2, 16, 16): the same skips
  and kinds; the port's abstract arguments have the reference's leaf paths,
  shapes and dtypes (the decode cache's ``cur``, a () int32 there, is the
  port's Python int); every spec tuple equals ``tuple(PartitionSpec)``; and
  each leaf's per-device shape equals jax's ``shard_shape`` where every
  dimension divides (the port rounds up where one does not, as GSPMD pads).
* The whole step's FLOPs at full published shapes on a one-device mesh,
  one cell of each (family, kind): the port's ``flops`` on fake CPU tensors
  within 2% of ``analyze_hlo`` of the reference's compiled step.  For the
  LMs' training and prefill, attention is taken out on both sides: the
  port charges it to B6 (``kernels``), and the reference's ``attention``
  is replaced by a dot-free stand-in that keeps q, k and v in the graph,
  so every projection and its gradient stays; decode attends in plain
  operations on both sides and is compared whole.  Two cells run work the
  reference's compiled step does not, logged in ROADMAP §C: MACE's l = 1, 2
  mixers, which never reach the energy (C.28), and the products of each
  DimeNet block that torch's checkpoint recomputes and JAX's remat does not
  (C.29); their FLOPs, from the configs, are taken from the port's count.
* ``python -m repro_torch.launch.dryrun`` on the CPU: one cell and its
  record, a skip, the cache, and a failing cell's exit code.
"""
import dataclasses
import json
import math
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh as JaxAbstractMesh
from jax.sharding import Mesh, NamedSharding, PartitionSpec

from repro.configs import registry as ref_registry
from repro.launch import sharding as ref_sharding
from repro.launch import steps as ref_steps
from repro.launch.hlo_analysis import analyze_hlo
from repro_torch.configs import registry
from repro_torch.configs.common import TRIPLET_CAP_FACTOR, _gnn_sizes
from repro_torch.launch import dryrun, sharding
from repro_torch.launch.dryrun import trace_step
from repro_torch.launch.mesh import AbstractMesh, dp_axes, make_production_mesh
from repro_torch.launch.steps import argument_bytes_per_dev, build_cell

ROOT = Path(__file__).resolve().parents[1]
CELLS = [(a, s) for a, s, _ in registry.list_cells()]
MESHES = {"1-pod": ((16, 16), ("data", "model")), "2-pod": ((2, 16, 16), ("pod", "data", "model"))}


def _jax_path(path) -> tuple:
    out = []
    for k in path:
        for attr in ("key", "idx", "name"):
            if hasattr(k, attr):
                out.append(str(getattr(k, attr)))
                break
    return tuple(out)


def _ref_leaves(args, specs):
    """{path: (shape, dtype name, spec tuple)} of the reference's cell."""
    leaves = jax.tree_util.tree_flatten_with_path(args)[0]
    spec_leaves = jax.tree_util.tree_flatten_with_path(
        specs, is_leaf=lambda x: isinstance(x, PartitionSpec))[0]
    spec_of = {_jax_path(p): tuple(s) for p, s in spec_leaves}
    return {_jax_path(p): (tuple(x.shape), jnp.dtype(x.dtype).name, spec_of[_jax_path(p)])
            for p, x in leaves}


def _port_leaves(args, specs, path=()):
    """{path: (shape, dtype name, spec tuple)} of the port's cell; the
    Python-int ``cur`` under ``"cur"``."""
    if torch.is_tensor(args):
        return {path: (tuple(args.shape), str(args.dtype).replace("torch.", ""), specs)}
    if isinstance(args, int):
        return {path: ("int", specs)}
    out = {}
    if isinstance(args, dict):
        items = [(str(k), v, specs[k]) for k, v in args.items()]
    elif isinstance(args, (list, tuple)):
        items = [(str(i), v, s) for i, (v, s) in enumerate(zip(args, specs))]
    elif dataclasses.is_dataclass(args):
        items = [(f.name, getattr(args, f.name), getattr(specs, f.name))
                 for f in dataclasses.fields(args) if f.name not in
                 ("n_nodes", "n_edges", "n_graphs", "n_grid", "n_mesh", "n_g2m", "n_mesh_e",
                  "n_m2g")]
    else:
        assert args is None, type(args)
        return {}
    for k, v, s in items:
        out.update(_port_leaves(v, s, path + (k,)))
    return out


@pytest.mark.parametrize("mesh_name", sorted(MESHES))
@pytest.mark.parametrize("arch,shape", CELLS)
def test_cell_args_and_specs_equal_the_reference(arch, shape, mesh_name, monkeypatch):
    sizes, names = MESHES[mesh_name]
    ref = ref_steps.build_cell(arch, shape, JaxAbstractMesh(sizes, names))
    mesh = AbstractMesh(sizes, names)
    got = build_cell(arch, shape, mesh)
    assert (ref is None) == (got is None) == ((arch, shape) in registry.SKIPPED_CELLS)
    if ref is None:
        return
    kind, _, args, in_specs, _, cfg = got
    assert kind == ref[0]
    want = _ref_leaves(ref[2], ref[3])
    have = _port_leaves(args, in_specs)
    if kind == "decode":  # the port's cache keeps cur as a Python int
        assert want.pop(("1", "cur")) == ((), "int32", ()) and have.pop(("1", "cur")) == ("int", ())
    assert have == want
    # per-device shapes: jax's where every dim divides, rounded up elsewhere
    jmesh = JaxAbstractMesh(sizes, names)
    total = 0
    for path, (shp, dtype, spec) in have.items():
        per_dev = sharding.shard_shape(shp, spec, mesh)
        divisors = [math.prod(mesh.shape[a] for a in ((d,) if isinstance(d, str) else d or ()))
                    for d in spec] + [1] * (len(shp) - len(spec))
        if all(n % q == 0 for n, q in zip(shp, divisors)):
            assert per_dev == NamedSharding(jmesh, PartitionSpec(*spec)).shard_shape(shp), path
        else:
            assert per_dev == tuple(-(-n // q) for n, q in zip(shp, divisors))
        total += math.prod(per_dev) * np.dtype(dtype if dtype != "bfloat16" else "uint16").itemsize
    assert argument_bytes_per_dev(args, in_specs, mesh) == total
    if getattr(cfg, "n_experts", None):  # the MoE launch fields, as the reference sets them
        ref_cfg = _ref_step_cfg(arch, shape, jmesh, monkeypatch)
        for field in ("moe_groups", "moe_virtual_split", "moe_expert_axis", "moe_tp_axis",
                      "seq_shard_axis", "batch_shard_axes"):
            assert getattr(cfg, field) == getattr(ref_cfg, field), field


def _ref_step_cfg(arch, shape, mesh, monkeypatch):
    """The config the reference's LM step closes over (its build_cell
    returns the registry's), caught where its spec rule reads it."""
    captured = {}
    real = ref_sharding.lm_param_specs

    def spy(cfg, mesh, **kw):
        captured["cfg"] = cfg
        return real(cfg, mesh, **kw)

    monkeypatch.setattr(ref_sharding, "lm_param_specs", spy)
    ref_steps.build_cell(arch, shape, mesh)
    return captured["cfg"]


def test_production_meshes():
    one, two = make_production_mesh(), make_production_mesh(multi_pod=True)
    assert one.shape == {"data": 16, "model": 16} and one.size == 256
    assert two.shape == {"pod": 2, "data": 16, "model": 16} and two.size == 512
    assert dp_axes(one) == ("data",) and dp_axes(two) == ("pod", "data")
    assert sharding.P(("data",), None) == tuple(PartitionSpec(("data",), None))
    assert sharding.P((), ("pod", "data")) == tuple(PartitionSpec((), ("pod", "data")))
    assert sharding.shard_shape((33, 7), ("data", None), one) == (3, 7)
    assert [c for c in registry.list_cells() if c[2]] == \
        [c for c in ref_registry.list_cells() if c[2]]


# ------------------------------------------------------- FLOPs at published shapes
FLOP_CELLS = [
    ("starcoder2-7b", "train_4k"), ("starcoder2-7b", "prefill_32k"),
    ("starcoder2-7b", "decode_32k"), ("mixtral-8x22b", "prefill_32k"),
    ("gcn-cora", "full_graph_sm"), ("mace", "molecule"),
    ("dimenet", "molecule"), ("graphcast", "full_graph_sm"), ("dlrm-rm2", "train_batch"),
    ("dlrm-rm2", "serve_p99"), ("dlrm-rm2", "retrieval_cand"),
]


def _no_attention(q, k, v, **kw):
    """A dot-free stand-in for the reference's attention: q, k and v stay
    in the graph (so every projection keeps its gradient), no product."""
    del kw
    return q + (jnp.mean(k, axis=(1, 2)) + jnp.mean(v, axis=(1, 2)))[:, None, None, :]


def _ref_flops(arch, shape, monkeypatch):
    from repro.launch.sharding import tree_named
    from repro.models import transformer as ref_T

    monkeypatch.setattr(ref_T, "attention", _no_attention)
    mesh = Mesh(np.array(jax.devices()[:1]).reshape(1, 1), ("data", "model"))
    _, step, args, in_specs, out_specs, _ = ref_steps.build_cell(arch, shape, mesh)
    with mesh:
        jitted = jax.jit(step, in_shardings=tree_named(mesh, in_specs),
                         out_shardings=None if out_specs is None
                         else tree_named(mesh, out_specs))
        hlo = jitted.lower(*args).compile().as_text()
    return analyze_hlo(hlo)["flops"]


def _port_only_flops(arch: str, shape: str, cfg) -> float:
    """The FLOPs the port's step runs that the reference's compiled step
    does not (ROADMAP §C)."""
    if arch not in ("mace", "dimenet"):
        return 0.0
    n, e, _ = _gnn_sizes(shape)
    if arch == "mace":  # C.28: msg1, msg2 and m22_2 reach no output; forward and recompute
        c = cfg.channels
        one_pass = 2 * (n * 3) * (5 * c) * c + 2 * (n * 9) * (4 * c) * c + 2 * (n * c) * 3 ** 3
        return 2 * cfg.n_layers * one_pass
    # C.29: dimenet's out_mlp, w_sbf and rbf_gate products recomputed
    d, t = cfg.d_hidden, TRIPLET_CAP_FACTOR * e
    return cfg.n_blocks * 2 * (e * d * d + t * cfg.n_spherical * cfg.n_radial
                               * cfg.n_bilinear + e * cfg.n_radial * d)


@pytest.mark.parametrize("arch,shape", FLOP_CELLS)
def test_step_flops_at_published_shapes_match_the_reference(arch, shape, monkeypatch):
    _, step, args, _, _, cfg = build_cell(arch, shape, AbstractMesh((1, 1), ("data", "model")))
    got = trace_step(step, args, "cpu")
    want = _ref_flops(arch, shape, monkeypatch)
    port_only = _port_only_flops(arch, shape, cfg)
    assert got["flops"] - port_only == pytest.approx(want, rel=0.02), (got["flops"], want)
    if registry.get_arch(arch).FAMILY == "lm" and shape != "decode_32k":
        assert got["kernels"]["flash_attention"]["flops"] > 0


# ------------------------------------------------------------------------ the CLI
def test_cli_writes_records_skips_and_caches(tmp_path, capsys):
    out = tmp_path / "dry.json"
    args = ["--arch", "dlrm-rm2", "--shape", "serve_p99", "--out", str(out), "--device", "cpu"]
    r = subprocess.run([sys.executable, "-m", "repro_torch.launch.dryrun", *args],
                       capture_output=True, text=True, cwd=tmp_path, timeout=300,
                       env={**os.environ, "PYTHONPATH": str(ROOT / "src")})
    assert r.returncode == 0, r.stderr
    assert "[ok] dlrm-rm2 × serve_p99" in r.stdout
    (rec,) = json.loads(out.read_text())
    assert rec["kernels"]["embedding_bag"]["calls"] == 1 and rec["coll_bytes"] is None
    assert rec["flops"] > 0 and rec["peak_bytes"] > rec["argument_bytes"] > 0
    assert rec["argument_bytes_per_dev"] < rec["argument_bytes"]
    dryrun.main(args)
    assert "[cached] dlrm-rm2 × serve_p99" in capsys.readouterr().out
    dryrun.main(["--arch", "qwen2-72b", "--shape", "long_500k", "--out", str(out),
                 "--device", "cpu"])
    assert "[skip] qwen2-72b × long_500k" in capsys.readouterr().out
    assert json.loads(out.read_text())[-1] == {"arch": "qwen2-72b", "shape": "long_500k",
                                               "multi_pod": False, "device": "cpu",
                                               "skipped": True}
    with pytest.raises(SystemExit) as failed:
        dryrun.main(["--arch", "no-such-arch", "--shape", "train_4k", "--out", str(out),
                     "--device", "cpu"])
    assert failed.value.code == 1 and "FAILURES" in capsys.readouterr().out


if __name__ == "__main__":  # the figures behind PERF.md's and ROADMAP C.28/C.29's comparisons
    for arch, shape in FLOP_CELLS:
        _, step, args, _, _, cfg = build_cell(arch, shape, AbstractMesh((1, 1), ("data", "model")))
        got = trace_step(step, args, "cpu")["flops"]
        with pytest.MonkeyPatch.context() as mp:
            want = _ref_flops(arch, shape, mp)
        only = _port_only_flops(arch, shape, cfg)
        print(f"{arch} × {shape}: port {got:.5e}, port-only {only:.5e}, reference {want:.5e}, "
              f"(port - port-only) / reference - 1 = {(got - only) / want - 1:+.5f}", flush=True)
