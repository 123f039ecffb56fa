"""The port's sharded DIP stores against the reference's single-device answers.

The counterpart of ``tests/test_shard_pg.py`` and of the sharded-plane
check of ``tests/test_bitplane.py``: the same seeded inputs go through the
reference ``PropGraph`` on one device and the port's ``PropGraph`` on an
entity mesh of P CPU shards (``make_entity_mesh(devices=["cpu"] * P)``, the
port's counterpart of the reference's 8 forced host devices), and every
query surface must agree bitwise, for P in {1, 2, 3, 4, 6, 8}.  Also: the
mesh, the collectives, the placement specs, the sharded bitmap_query
wrappers and the OR all-reduce on their own.
"""
from functools import lru_cache

import numpy as np
import pytest
import torch

from _torch_parity import as_np
from repro.core import PropGraph as RefPG
from repro.core.io import save_propgraph as ref_save
from repro.graph import random_uniform_graph
from repro_torch.core import PropGraph, bitplane, dip_shard
from repro_torch.core.io import load_propgraph, save_propgraph
from repro_torch.kernels.bitmap_query import ops, ref
from repro_torch.launch import collectives, sharding
from repro_torch.launch.mesh import EntityMesh, dp_axes, make_entity_mesh, mesh_axes

BACKENDS = ("arr", "list", "listd")
P_SWEEP = (1, 2, 3, 4, 6, 8)
PATTERNS = (
    "(a:l1|l2)-[:follows]->(b:l3)",
    "(a:l1|l2 {age > 30})-[:follows]->(b)",
    "(a)<-[:likes]-(b:l0|l4)",
    "(a:l1)-[:follows*1..3]->(b:l3)",  # var-length: frontier layers on the lead device
)


def cpu_mesh(p: int) -> EntityMesh:
    return make_entity_mesh(devices=["cpu"] * p)


@lru_cache(maxsize=None)
def inputs(m: int = 1200, seed: int = 7) -> dict:
    """``tests/test_shard_pg.py``'s graph: edges, 12 labels, two
    relationships and an int32 ``age``, drawn in its order."""
    rng = np.random.default_rng(seed)
    src, dst = random_uniform_graph(m, seed=seed)
    g = RefPG(backend="arr").add_edges_from(src, dst).graph
    nodes = np.asarray(g.node_map)
    es, ed = np.asarray(g.src), np.asarray(g.dst)
    return {"src": src, "dst": dst, "nodes": nodes,
            "labels": rng.choice([f"l{i}" for i in range(12)], size=len(nodes)),
            "rel_src": nodes[es], "rel_dst": nodes[ed],
            "rels": rng.choice(["follows", "likes"], size=len(es)),
            "ages": rng.integers(0, 90, len(nodes)).astype(np.int32)}


def ingest(pg, r: dict):
    pg.add_edges_from(r["src"], r["dst"])
    pg.add_node_labels(r["nodes"], r["labels"])
    pg.add_edge_relationships(r["rel_src"], r["rel_dst"], r["rels"])
    pg.add_node_properties("age", r["nodes"], r["ages"])
    return pg


@lru_cache(maxsize=None)
def ref_graph(backend: str):
    """The reference on one device — read-only across tests."""
    return ingest(RefPG(backend=backend), inputs())


@lru_cache(maxsize=None)
def ref_match(backend: str, pattern: str):
    return ref_graph(backend).match(pattern)


@lru_cache(maxsize=None)
def mesh_graph(backend: str, p: int = 8):
    """The port on a P-shard CPU mesh — read-only; mutating tests build
    their own."""
    return ingest(PropGraph(backend=backend, mesh=cpu_mesh(p)), inputs())


def same(a, b) -> bool:
    a, b = as_np(a), as_np(b)
    return a.shape == b.shape and bool((a == b).all())


def same_match(r1, r2) -> bool:
    return (same(r1.vertex_mask, r2.vertex_mask) and same(r1.edge_mask, r2.edge_mask)
            and len(r1.node_masks) == len(r2.node_masks)
            and all(same(x, y) for x, y in zip(r1.node_masks, r2.node_masks))
            and all(same(x, y) for x, y in zip(r1.edge_masks, r2.edge_masks)))


# ------------------------------------------------------------------- the mesh
def test_make_entity_mesh_contracts(monkeypatch):
    mesh = cpu_mesh(8)
    assert mesh.size == 8 and mesh.shape == {"data": 8} and mesh.lead == torch.device("cpu")
    assert mesh_axes(mesh) == ("data",) and dp_axes(mesh) == ("data",)
    assert hash(mesh) == hash(cpu_mesh(8)) and mesh == cpu_mesh(8) and mesh != cpu_mesh(4)
    assert make_entity_mesh(3, devices=["cpu"] * 8).size == 3  # a sub-mesh
    for bad in (0, 9):
        with pytest.raises(ValueError, match=r"not in \[1, 8\]"):
            make_entity_mesh(bad, devices=["cpu"] * 8)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    with pytest.raises(ValueError, match=r"not in \[1, 0\]"):  # the default spans the cards
        make_entity_mesh()
    with pytest.raises(ValueError, match="all CUDA devices or all CPU"):
        EntityMesh((torch.device("cpu"), torch.device("meta")))


def test_propgraph_device_is_the_mesh_lead():
    mesh = cpu_mesh(4)
    assert PropGraph(mesh=mesh).device == mesh.lead
    assert PropGraph(mesh=mesh, device="cpu").device == mesh.lead
    with pytest.raises(ValueError, match="lead device"):
        PropGraph(mesh=mesh, device="cuda:0")
    with pytest.raises(TypeError, match="mesh"):
        PropGraph(mesh=object(), device="cpu")


def test_sharding_specs():
    mesh = cpu_mesh(6)
    assert sharding.pg_entity_axes(mesh) == ("data",)
    assert sharding.pg_entity_shards(mesh) == 6
    specs = sharding.pg_specs(mesh)
    assert specs["arr"]["bitmap"] == (None, ("data",))
    assert specs["list"] == {"off": sharding.REPLICATED, "val": (("data",),),
                             "slot_entity": (("data",),)}
    assert specs["listd"]["a_off"] == sharding.REPLICATED
    assert specs["di"]["src"] == sharding.LEAD and specs["prop"] == sharding.LEAD
    # ⌈n/32⌉ words rounded up to a positive multiple of P
    assert [sharding.pg_word_pad(mesh, n) for n in (0, 1, 32 * 6, 32 * 6 + 1)] == [6, 6, 6, 12]


def test_collectives():
    rng = np.random.default_rng(0)
    parts = [torch.from_numpy(rng.normal(size=7).astype(np.float32)) for _ in range(5)]
    stack = torch.stack(parts)
    for op, want in (("max", stack.max(0).values), ("min", stack.min(0).values)):
        got = collectives.all_reduce(parts, op)
        assert len(got) == 5 and all(torch.equal(g, want) for g in got)
    want = parts[0] + parts[1] + parts[2] + parts[3] + parts[4]  # shard order
    assert all(torch.equal(g, want) for g in collectives.all_reduce(parts, "sum"))
    bools = [p > 0 for p in parts]
    assert torch.equal(collectives.all_reduce(bools, "max")[0], torch.stack(bools).any(0))
    with pytest.raises(ValueError, match="unknown all_reduce op"):
        collectives.all_reduce(parts, "or")
    assert all(torch.equal(g, stack) for g in collectives.all_gather(parts))
    moved = collectives.ppermute(parts, [(0, 1), (1, 0)])
    assert torch.equal(moved[0], parts[1]) and torch.equal(moved[1], parts[0])
    assert not moved[2].any()  # no pair targets shard 2: zeros
    with pytest.raises(ValueError, match="targeted twice"):
        collectives.ppermute(parts, [(0, 1), (2, 1)])
    assert torch.equal(collectives.gather(parts, torch.device("cpu")), torch.cat(parts))
    assert len(collectives.broadcast(parts[0], cpu_mesh(3).devices)) == 3


@pytest.mark.parametrize("p", range(1, 9))
def test_or_allreduce_equals_an_or_fold(p):
    """The butterfly (P a power of two) and the gather-and-fold (any other
    P) both give every shard the OR of all parts — bits 31 included."""
    rng = np.random.default_rng(p)
    words = rng.integers(0, 2**32, size=(p, 45), dtype=np.uint64).astype(np.uint32)
    words[:, 3] = 0x80000000  # the sign bit of an int32 word
    want = np.bitwise_or.reduce(words, axis=0)
    parts = [torch.from_numpy(w.view(np.int32).copy()) for w in words]
    got = bitplane.or_allreduce(parts)
    assert len(got) == p
    for g in got:
        assert np.array_equal(g.numpy().view(np.uint32), want)


# -------------------------------------------------------- sharded bitmap_query
@pytest.mark.parametrize("p", (3, 8))
def test_sharded_kernel_wrappers_equal_the_unsharded_query(p):
    """Each wrapper runs its kernel's plain version once per CPU shard; the
    parts joined equal the unsharded query, and nothing counts as a kernel
    launch on the CPU."""
    mesh = cpu_mesh(p)
    rng = np.random.default_rng(p)
    k, w = 9, 5 * p
    plane = torch.from_numpy(rng.integers(-2**31, 2**31, (k, w), dtype=np.int64)
                             .astype(np.int32))
    bitmap = torch.from_numpy(rng.integers(0, 2, (k, 32 * p), dtype=np.int8))
    masks = torch.from_numpy(rng.random((4, k)) < 0.4)
    ops.reset_launches()
    wshards = tuple(c.contiguous() for c in plane.chunk(p, dim=1))
    bshards = tuple(c.contiguous() for c in bitmap.chunk(p, dim=1))
    cases = [
        (ops.bitmap_query_batched_packed_sharded(wshards, masks, mesh=mesh),
         ref.bitmap_query_batched_packed_ref(plane, masks)),
        (ops.bitmap_query_packed_sharded(wshards, masks[1], mesh=mesh),
         ref.bitmap_query_batched_packed_ref(plane, masks[1:2])[0]),
        (ops.bitmap_query_batched_sharded(bshards, masks, mesh=mesh),
         ref.bitmap_query_batched_ref(bitmap, masks)),
        (ops.bitmap_query_sharded(bshards, masks[2], mesh=mesh),
         ref.bitmap_query_batched_ref(bitmap, masks[2:3])[0]),
    ]
    for parts, want in cases:
        assert len(parts) == p and torch.equal(torch.cat(parts, dim=-1), want)
    assert ops.launches == {ops.PACKED: 0, ops.BYTE: 0}
    with pytest.raises(ValueError, match="shards for a mesh"):
        ops.bitmap_query_sharded(bshards[:-1], masks[0], mesh=mesh)
    with pytest.raises(ValueError, match="contiguous"):  # _check still guards each shard
        ops.bitmap_query_batched_sharded(tuple(bitmap.chunk(p, dim=1)), masks, mesh=mesh)


# ----------------------------------------------------------- store queries
@pytest.mark.parametrize("backend", BACKENDS)
def test_query_masks_bitwise_equal(backend):
    r, g = ref_graph(backend), mesh_graph(backend)
    assert same(r.query_labels(["l1", "l2"]), g.query_labels(["l1", "l2"]))
    assert same(r.query_relationships(["follows"]), g.query_relationships(["follows"]))
    # degenerate queries short-circuit identically
    assert same(r.query_labels([]), g.query_labels([]))
    assert same(r.query_labels(["nope"]), g.query_labels(["nope"]))


@pytest.mark.parametrize("pattern", PATTERNS)
@pytest.mark.parametrize("backend", BACKENDS)
def test_match_bitwise_equal(backend, pattern):
    assert same_match(ref_match(backend, pattern), mesh_graph(backend).match(pattern))


def test_arr_impl_variants_agree():
    """matvec, scan and kernel (B2/B1 once per shard) give the same mask."""
    want = as_np(ref_graph("arr").query_labels(["l1", "l2"]))
    g = mesh_graph("arr")
    for impl in ("matvec", "scan", "kernel"):
        assert same(want, g.query_labels(["l1", "l2"], impl=impl)), impl
    with pytest.raises(ValueError, match="unknown impl"):
        g.query_labels(["l1", "l2"], impl="inverted")
    with bitplane.byte_masks():  # the byte plane: B2's plain version per shard
        gb = ingest(PropGraph(backend="arr", mesh=cpu_mesh(3)), inputs())
        assert not gb._vstore.packed
        for impl in ("matvec", "scan", "kernel"):
            assert same(want, gb.query_labels(["l1", "l2"], impl=impl)), impl


def test_listd_single_device_impls_degrade():
    """budget and linked are single-device layouts; a mesh runs the
    inverted slot scan instead — the same mask either way."""
    want = as_np(ref_graph("listd").query_labels(["l1"], impl="budget"))
    g = mesh_graph("listd")
    assert same(want, g.query_labels(["l1"], impl="budget"))
    assert same(want, g.query_labels(["l1"], impl="linked"))
    with pytest.raises(ValueError, match="unknown impl"):  # typos still fail
        g.query_labels(["l1"], impl="linkd")


def test_batched_fused_and_word_masks_equal():
    r, g = ref_graph("arr"), mesh_graph("arr")
    qs = [("l1", "l2"), ("l3",), ("l0", "l4", "l5")]
    assert same(r._vstore.query_any_batched(qs), g._vstore.query_any_batched(qs))
    assert same(as_np(r._vstore.query_any_batched_words(qs)),
                as_np(g._vstore.query_any_batched_words(qs), words=True))
    assert same(as_np(r._estore.query_any_words(["likes"])),
                as_np(g._estore.query_any_words(["likes"]), words=True))


def test_incremental_insert_invalidates_sharded_store():
    """An insert after a query must reach the answers, not the stale
    shards: before the seal it rebuilds them, after it the delta unions
    in."""
    r = inputs()
    ref = ingest(RefPG(backend="list"), r)
    port = ingest(PropGraph(backend="list", mesh=cpu_mesh(8)), r)
    assert not as_np(port.query_labels(["extra"])).any()
    for pg in (ref, port):
        pg.add_node_labels(r["nodes"][:17], ["extra"] * 17)
    assert same(ref.query_labels(["extra"]), port.query_labels(["extra"]))
    assert int(port.query_labels(["extra"]).sum()) == 17
    fresh = ingest(PropGraph(backend="list", mesh=cpu_mesh(8)), r)
    fresh.add_node_labels(r["nodes"][:5], ["pre"] * 5)  # before any seal: in the shards
    assert int(fresh.query_labels(["pre"]).sum()) == 5 and fresh._vstore._delta.size == 0


def test_save_load_onto_mesh(tmp_path):
    """A save of either package reopens straight onto a mesh, as any
    backend, and answers as the reference does."""
    r = ref_graph("arr")
    paths = {"ref": ref_save(str(tmp_path / "ref"), r),
             "port": save_propgraph(str(tmp_path / "port"), mesh_graph("arr"))}
    want_q = as_np(r.query_labels(["l1", "l2"]))
    for who, path in paths.items():
        for backend in BACKENDS:
            pg = load_propgraph(path, backend=backend, mesh=cpu_mesh(8))
            assert pg.mesh.size == 8 and pg.device == torch.device("cpu")
            assert same(want_q, pg.query_labels(["l1", "l2"])), (who, backend)
            assert same_match(ref_match("arr", PATTERNS[0]), pg.match(PATTERNS[0])), who
    with pytest.raises(ValueError, match="lead device"):
        load_propgraph(paths["port"], mesh=cpu_mesh(2), device="cuda:0")


def test_to_arrays_joins_the_shards():
    single = ingest(PropGraph(backend="arr", device="cpu"), inputs()).to_arrays()
    sharded = mesh_graph("arr", 6).to_arrays()
    for key in ("vstore", "estore"):
        a, b = single[key], sharded[key]
        assert a["values"] == b["values"] and (a["k"], a["n"]) == (b["k"], b["n"])
        assert np.array_equal(a["bitmap"], b["bitmap"]) and a["bitmap"].dtype == b["bitmap"].dtype


@pytest.mark.parametrize("p", P_SWEEP)
def test_submesh_sweep(p):
    """Every locale count P answers as the reference on one device: every
    backend's label and relationship masks and the first pattern, the
    fused batch, and listd's degraded impls."""
    qs = [("l1", "l2"), ("l3",), ("l0", "l4", "l5")]
    for backend in BACKENDS:
        r, g = ref_graph(backend), ingest(PropGraph(backend=backend, mesh=cpu_mesh(p)), inputs())
        assert same(r.query_labels(["l1", "l2"]), g.query_labels(["l1", "l2"])), (p, backend)
        assert same(r.query_relationships(["likes"]), g.query_relationships(["likes"]))
        assert same_match(ref_match(backend, PATTERNS[0]), g.match(PATTERNS[0])), (p, backend)
        assert same(r._vstore.query_any_batched(qs), g._vstore.query_any_batched(qs))


def test_tail_zero_sharded_plane():
    """``tests/test_bitplane.py``'s sharded-plane check: each shard holds
    whole words, and the bits past n (the last real word's tail and every
    pad word) are zero."""
    rng = np.random.default_rng(5)
    n, m = 271, 800
    src, dst = rng.integers(0, n, m), rng.integers(0, n, m)
    for p in (3, 8):
        pg = PropGraph(backend="arr", mesh=cpu_mesh(p)).add_edges_from(src, dst)
        pg.add_node_labels(np.arange(0, n, 2), "x")
        ss = pg._vstore.finalize_sharded()
        assert ss.packed and len(ss.bitmap) == p
        assert all(b.is_contiguous() and b.shape[1] == ss.n_pad // 32 // p for b in ss.bitmap)
        words = np.concatenate([b.numpy() for b in ss.bitmap], axis=1).view(np.uint32)
        bits = bitplane.unpack_bits_host(words, ss.n_pad)
        assert not bits[:, ss.n:].any() and bits[:, :ss.n].any()


@pytest.mark.parametrize("backend", BACKENDS)
def test_each_shard_holds_one_pth_of_the_padded_store(backend):
    """The entity (slot) axis splits evenly: every shard's bytes are 1/P of
    the padded store, plus listd's replicated attribute offsets."""
    for p in (3, 8):
        pg = mesh_graph(backend, p)
        ss = pg._vstore.finalize_sharded()
        per = dip_shard.store_bytes(ss)
        assert len(per) == p and len(set(per)) == 1
        if backend == "arr":
            whole = sum(b.numel() * b.element_size() for b in ss.bitmap)
        elif backend == "list":
            whole = 2 * 4 * ss.nnz_pad
        else:
            whole = 2 * 4 * ss.nnz_pad
            assert per[0] - whole // p == 4 * (ss.k + 1)  # a_off on every shard
            per = tuple(b - 4 * (ss.k + 1) for b in per)
        assert per[0] * p == whole
        assert pg._vstore._store is None and pg._vstore._host is None
