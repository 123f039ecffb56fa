"""The partitioned dry run of the GNN and DLRM cells: each as one device's
program on a device mesh, through DTensor over a fake process group
(``launch/dryrun.trace_partitioned``), against the reference's partitioned
program on the CPU.

* Placements: every GNN and DLRM cell's arguments on a (2, 4) mesh, each
  rank's shard at the offsets and of the shape jax's
  ``NamedSharding.devices_indices_map`` gives its device (eight host devices
  in a subprocess).
* Against the reference: at the smoke configs on (2, 4), the shape tables
  overridden alike on both sides (as ``test_torch_dryrun_partitioned_gnn_
  gloo.py`` overrides them), the port's per-device matmul FLOPs within 5% of
  ``analyze_hlo`` of the reference's compiled per-device program (less, for
  MACE and DimeNet, the work ROADMAP C.28 and C.29 log, split as the rows
  are); B4's and B5's charges apart, against the whole step's split as each
  rank's bags and edges are; every collective kind either side issues
  tabled with the ratio, a gap over 25% named in ROADMAP §C's C.31.
* B4's row window in its plain version: the bags of the windows of a split
  of [0, V) sum to the reference's ``embedding_bag_ref`` within 1e-6, an id
  outside [-V, V) makes its bag NaN in every window, and the full window is
  the unwindowed call bit for bit.
* Hints: GraphCast's ``_constrain`` and split MLPs, and the sharded gather
  and scatter, change nothing on plain tensors, bit for bit.
"""
import dataclasses
import inspect
import re
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import jax  # noqa: F401  (the reference's analyzer below; jax stays on the CPU)
import numpy as np
import pytest
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh
from torch.testing._internal.distributed.fake_pg import FakeStore

from repro.kernels.embedding_bag.ref import embedding_bag_ref as reference_bags
from repro_torch.configs import common, registry
from repro_torch.graph import segment_ops
from repro_torch.kernels.embedding_bag.ref import embedding_bag_ref
from repro_torch.launch import sharding
from repro_torch.launch.dryrun import trace_partitioned, trace_step
from repro_torch.launch.mesh import AbstractMesh, fake_device_mesh
from repro_torch.launch.steps import build_cell, leaf_specs
from repro_torch.models import graphcast
from test_torch_dryrun_partitioned import _INDICES, KINDS, MESH24, _jsonable, _xla8

ROOT = Path(__file__).resolve().parents[1]
CELLS = [(a, s) for a, s, skip in registry.list_cells()
         if registry.get_arch(a).FAMILY in ("gnn", "recsys") and not skip]


# ------------------------------------------------------------------ placements
def test_every_gnn_and_dlrm_cells_shards_sit_where_jax_puts_them():
    pairs = {}
    for arch, shape in CELLS:
        _, _, args, in_specs, _, _ = build_cell(arch, shape, MESH24)
        for t, spec in leaf_specs(args, in_specs):
            pairs[(tuple(t.shape), tuple(spec))] = None
    pairs = list(pairs)
    want = _xla8(_INDICES, [[list(s), _jsonable(p)] for s, p in pairs])
    for rank in range(MESH24.size):  # rank r is jax's device r: row-major over (data, model)
        dist.init_process_group("fake", store=FakeStore(), rank=rank, world_size=MESH24.size)
        try:
            dmesh = init_device_mesh("cpu", MESH24.axis_sizes, mesh_dim_names=MESH24.axis_names)
            for (shape, spec), per_device in zip(pairs, want):
                local, offsets = sharding.local_shard(shape, sharding.named(dmesh, spec), dmesh)
                got = [[o, o + n] for o, n in zip(offsets, local)]
                assert got == per_device[rank], (shape, spec, rank)
        finally:
            dist.destroy_process_group()


# ---------------------------------------------------------- against the reference
SMOKE_GNN = {"full_graph_sm": {"n_nodes": 500, "n_edges": 2000, "d_feat": 32},
             "molecule": {"n_nodes": 6, "n_edges": 16, "batch": 16}}
# retrieval at 100,352 candidates: the scores' matvec outweighs the bottom MLP's (1, 13)
# products, which XLA rewrites into no dot at all
SMOKE_RECSYS = {"train_batch": {"batch": 64}, "serve_p99": {"batch": 16},
                "retrieval_cand": {"n_candidates": 100_000}}
SMOKE_CELLS = [("gcn-cora", "full_graph_sm"), ("mace", "molecule"), ("dimenet", "molecule"),
               ("graphcast", "full_graph_sm"), ("dlrm-rm2", "train_batch"),
               ("dlrm-rm2", "serve_p99"), ("dlrm-rm2", "retrieval_cand")]

def configure(common, registry, gnn, recsys):
    """The reduced shapes and the smoke configs in one package's shape
    tables and registry (the reference's side runs this function's source)."""
    for table, over in ((common.GNN_SHAPES, gnn), (common.RECSYS_SHAPES, recsys)):
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
        else:
            mod.full_config = smoke


_REFERENCE = "import dataclasses\n" + inspect.getsource(configure) + r"""
import json, sys
import jax, numpy as np
from jax.sharding import Mesh
from repro.configs import common, registry
from repro.launch import steps
from repro.launch.hlo_analysis import analyze_hlo
from repro.launch.sharding import tree_named

cells, gnn, recsys = json.load(sys.stdin)
configure(common, registry, gnn, recsys)
mesh = Mesh(np.array(jax.devices()[:8]).reshape(2, 4), ("data", "model"))
out = {}
for arch, shape in cells:
    _, step, args, in_specs, out_specs, _ = steps.build_cell(arch, shape, mesh)
    with mesh:
        jitted = jax.jit(step, in_shardings=tree_named(mesh, in_specs),
                         out_shardings=None if out_specs is None else tree_named(mesh, out_specs))
        tot = analyze_hlo(jitted.lower(*args).compile().as_text())
    out[arch + " " + shape] = {"flops": tot["flops"], "coll_by_kind": dict(tot["coll_by_kind"])}
print(json.dumps(out))
"""


@pytest.fixture(scope="module")
def reference_run():
    """The reference's (2, 4) program compiled in its subprocess, started
    first so that it runs beside the port's traces."""
    with ThreadPoolExecutor(1) as pool:
        yield pool.submit(_xla8, _REFERENCE, [SMOKE_CELLS, SMOKE_GNN, SMOKE_RECSYS])


@pytest.fixture(scope="module")
def smoke_cells(monkeypatch_module, reference_run):
    """{cell: (partitioned totals on (2, 4), whole-step totals, cfg, sizes)} of
    the port at the smoke cells, the overrides in place while they trace."""
    configure(common, registry, SMOKE_GNN, SMOKE_RECSYS)
    out = {}
    for arch, shape in SMOKE_CELLS:
        _, step, args, in_specs, _, cfg = build_cell(arch, shape, MESH24)
        out[(arch, shape)] = (trace_partitioned(step, args, in_specs, MESH24, "cpu"),
                              trace_step(step, args, "cpu"), cfg,
                              common._gnn_sizes(shape) if shape in SMOKE_GNN else None)
    return out


@pytest.fixture(scope="module")
def monkeypatch_module():
    """The shape tables and registry entries the smoke cells override, put
    back after the module's tests."""
    mp = pytest.MonkeyPatch()
    for table in (common.GNN_SHAPES, common.RECSYS_SHAPES):
        for name in list(table):
            mp.setitem(table, name, dict(table[name]))
    for arch in ("gcn-cora", "mace", "dimenet", "graphcast", "dlrm-rm2"):
        mod = registry.get_arch(arch)
        mp.setattr(mod, "full_config", mod.full_config)
    yield mp
    mp.undo()


@pytest.fixture(scope="module")
def reference_per_device(reference_run):
    return reference_run.result()


def port_only_per_device(arch: str, cfg, sizes) -> float:
    """The FLOPs one device of the (2, 4) mesh runs that the reference's
    compiled step does not (ROADMAP C.28, C.29; ``test_torch_dryrun.
    _port_only_flops``' formulas), split over ``data`` as the rows are."""
    if arch not in ("mace", "dimenet"):
        return 0.0
    n, e, _ = sizes
    if arch == "mace":
        c = cfg.channels
        one_pass = 2 * (n * 3) * (5 * c) * c + 2 * (n * 9) * (4 * c) * c + 2 * (n * c) * 3 ** 3
        whole = 2 * cfg.n_layers * one_pass
    else:
        d, t = cfg.d_hidden, common.TRIPLET_CAP_FACTOR * e
        whole = cfg.n_blocks * 2 * (e * d * d + t * cfg.n_spherical * cfg.n_radial
                                    * cfg.n_bilinear + e * cfg.n_radial * d)
    return whole / MESH24.shape["data"]


def collective_table(smoke_cells, reference_per_device):
    """{cell: {kind: (reference bytes, port bytes, port / reference)}}."""
    table = {}
    for cell, (got, _, _, _) in smoke_cells.items():
        ref = reference_per_device[" ".join(cell)]["coll_by_kind"]
        mine = got["coll_by_kind"]
        table[cell] = {k: (ref.get(k, 0.0), mine.get(k, 0.0),
                           mine.get(k, 0.0) / ref[k] if ref.get(k) else None)
                       for k in KINDS if ref.get(k) or mine.get(k)}
    return table


def test_per_device_flops_against_the_reference(smoke_cells, reference_per_device):
    for (arch, shape), (got, _, cfg, sizes) in smoke_cells.items():
        want = reference_per_device[f"{arch} {shape}"]["flops"]
        port = got["flops"] - port_only_per_device(arch, cfg, sizes)
        assert port == pytest.approx(want, rel=0.05), (arch, shape, port, want)


def test_b4_and_b5_charges_split_as_each_ranks_bags_and_edges(smoke_cells):
    """B5 runs on the rank's edges (split over ``data``) and B4 on its bags
    (the batch split over ``data``; retrieval's one bag on every rank):
    the same launches as the whole step, their FLOPs split so."""
    charged = set()
    for (arch, shape), (got, whole, _, _) in smoke_cells.items():
        share = 1 if shape == "retrieval_cand" else MESH24.shape["data"]
        assert set(got["kernels"]) == set(whole["kernels"]), (arch, shape)
        for name, k in whole["kernels"].items():
            charged.add(name)
            assert got["kernels"][name]["calls"] == k["calls"], (arch, shape, name)
            assert got["kernels"][name]["flops"] == k["flops"] / share, (arch, shape, name)
    assert {"seg_mm", "seg_mm_transposed", "embedding_bag", "embedding_bag_backward"} <= charged


def test_collectives_by_kind_against_the_reference(smoke_cells, reference_per_device):
    roadmap = (ROOT / "ROADMAP.md").read_text()
    entry = re.search(r"^31\. \*\*.*?(?=^\S)", roadmap, re.M | re.S)  # §C's C.31
    for cell, rows in collective_table(smoke_cells, reference_per_device).items():
        for kind, (ref_b, port_b, ratio) in rows.items():
            if ratio is None or not 0.75 <= ratio <= 1.25:  # a gap ROADMAP C.31 logs
                assert entry and kind in entry.group(0), (cell, kind, ref_b, port_b)


def test_dtensors_strategy_through_a_decomposition_is_no_ranks_work():
    """DTensor has no rule for ``mv`` here and propagates a strategy by
    running its decomposition on fake tensors of the global shapes, the
    first time only (then cached): the counter books the rank's local work
    alone either time (retrieval's scores: a 515 MB difference between a
    first and a second trace of the same cell)."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed.tensor import DTensor, Replicate, Shard

    from repro_torch.launch.hlo_analysis import CostCounter

    n, d = 4 * 7_919, 24  # a shape no other test propagates, so the first call here is first
    totals = []
    with fake_device_mesh(AbstractMesh((4,), ("model",)), "cpu") as dmesh, FakeTensorMode():
        x = DTensor.from_local(torch.empty((n // 4, d)), dmesh, [Shard(0)], run_check=False)
        v = DTensor.from_local(torch.empty((d,)), dmesh, [Replicate()], run_check=False)
        for _ in range(2):
            with CostCounter(arguments=(x, v)) as counter:
                x @ v
            totals.append(counter.totals())
    assert totals[0] == totals[1]
    assert totals[0]["peak_bytes"] == (n // 4) * d * 4 + d * 4 + (n // 4) * 4  # x, v, the scores


# ------------------------------------------------------------------ B4's window
@pytest.mark.parametrize("split", [(0, 500), (0, 125, 250, 375, 500), (0, 1, 2, 499, 500),
                                   (0, 97, 310, 500)])
def test_b4_windows_sum_to_the_whole_lookup(split):
    rng = np.random.default_rng(len(split))
    f, v, d, b, mh = 3, 500, 8, 16, 4
    tables = rng.standard_normal((f, v, d)).astype(np.float32)
    idx = rng.integers(-v, v, (b, f, mh)).astype(np.int32)
    idx[2, 1, 3], idx[5, 0, 0], idx[7, 2, 1] = v + 3, -v - 1, -1  # NaN, NaN, wraps
    t = torch.from_numpy(tables)
    i = torch.from_numpy(idx)
    got = sum(embedding_bag_ref(t[:, lo:hi].contiguous(), i, (v, lo))
              for lo, hi in zip(split, split[1:]))
    want = np.asarray(reference_bags(tables, idx))
    nan = np.isnan(want)
    assert nan[2, 1].all() and nan[5, 0].all() and nan.sum() == 2 * d
    assert np.array_equal(np.isnan(got.numpy()), nan)
    np.testing.assert_allclose(got.numpy()[~nan], want[~nan], atol=1e-6, rtol=0)
    for lo, hi in zip(split, split[1:]):  # every window's bag is NaN where the id lies beyond
        part = embedding_bag_ref(t[:, lo:hi].contiguous(), i, (v, lo))
        assert torch.isnan(part[2, 1]).all() and torch.isnan(part[5, 0]).all()
    full, whole = embedding_bag_ref(t, i, (v, 0)), embedding_bag_ref(t, i)
    assert torch.equal(full.view(torch.int32), whole.view(torch.int32))  # NaNs too


# ---------------------------------------------------------------------- hints
def test_graphcast_hints_and_the_sharded_paths_change_nothing_on_plain_tensors():
    from repro_torch.configs import graphcast_cfg
    from repro_torch.data.graph import synthetic_gc_batch

    cfg = dataclasses.replace(graphcast_cfg.smoke_config(), dtype=torch.float32)
    hinted = dataclasses.replace(cfg, dp_axes=("data",), tp_axis="model")
    params = graphcast.init_params(torch.Generator().manual_seed(0), cfg, device="cpu")
    batch = synthetic_gc_batch(n_nodes=64, n_edges=256, n_vars=cfg.n_vars, seed=1, device="cpu")
    assert torch.equal(graphcast.forward(params, batch, cfg),
                       graphcast.forward(params, batch, hinted))
    assert graphcast._tp_params(params, hinted)["out_mlp"][0]["w"] is params["out_mlp"][0]["w"]
    g = torch.Generator().manual_seed(2)
    x = torch.randn(40, 6, generator=g)
    ids = torch.randint(-45, 45, (90,), generator=g, dtype=torch.int32)
    assert torch.equal(segment_ops.gather_rows(x, ids),
                       segment_ops.ref.gather_rows(x, ids))
    n = 40
    dst64 = ids.to(torch.int64)
    want = torch.zeros(n + 1, 6).index_add_(
        0, torch.where((dst64 >= 0) & (dst64 < n), dst64, n), x[:1].expand(90, 6))[:n]
    assert torch.equal(segment_ops.segment_sum(x[:1].expand(90, 6), ids, n), want)


if __name__ == "__main__":  # the table behind ROADMAP C.31 and PERF.md §5
    configure(common, registry, SMOKE_GNN, SMOKE_RECSYS)
    ref = _xla8(_REFERENCE, [SMOKE_CELLS, SMOKE_GNN, SMOKE_RECSYS])
    cells = {}
    for arch, shape in SMOKE_CELLS:
        _, step, args, in_specs, _, cfg = build_cell(arch, shape, MESH24)
        cells[(arch, shape)] = (trace_partitioned(step, args, in_specs, MESH24, "cpu"), None,
                                cfg, common._gnn_sizes(shape) if shape in SMOKE_GNN else None)
    for cell, rows in collective_table(cells, ref).items():
        got, _, cfg, sizes = cells[cell]
        port = got["flops"] - port_only_per_device(cell[0], cfg, sizes)
        print(" × ".join(cell), "flops/dev", port, ref[" ".join(cell)]["flops"])
        for kind, (r, p, ratio) in rows.items():
            print(f"  {kind:20s} reference {r:12.0f}  port {p:12.0f}  ratio "
                  f"{'—' if ratio is None else f'{ratio:.3f}'}")
