"""The entity mesh on the card against the port on the CPU (whose answers the
CPU mesh tests hold to the reference package): a mesh of 8 shards of one
card, and one over every card when there are several.  Each sharded arr
query launches B1 (packed) or B2 (byte) once per shard.  Needs an NVIDIA
card (marker ``cuda``; skips without one):

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_mesh_cuda.py
"""
import numpy as np
import pytest
import torch

from _torch_parity import SERVE_PATTERNS
from repro_torch.core import bitplane
from repro_torch.kernels.bitmap_query import ops
from repro_torch.launch import pgserve
from repro_torch.launch.mesh import make_entity_mesh

FIELDS = ("src_nodes", "dst_nodes", "edge_src", "edge_dst", "edge_mask")


@pytest.fixture
def meshes():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: this holds the mesh on the card to the CPU port")
    lead = torch.device("cuda", torch.cuda.current_device())
    out = [make_entity_mesh(devices=[lead] * 8)]
    if torch.cuda.device_count() > 1:
        out.append(make_entity_mesh())
    return out


def _same(a, b) -> bool:
    return torch.equal(a.cpu(), b.cpu())


@pytest.mark.cuda
@pytest.mark.parametrize("backend", ["arr", "list", "listd"])
def test_mesh_on_card_equals_cpu(meshes, backend):
    cpu = pgserve.build_tenant_graph(backend, 3_000, seed=2, device="cpu")
    nodes = cpu.graph.node_map.numpy()
    for mesh in meshes:
        ops.reset_launches()
        pg = pgserve.build_tenant_graph(backend, 3_000, mesh=mesh, seed=2)
        assert pg.device == mesh.lead
        for p in SERVE_PATTERNS + ("(a:l1)-[:follows*1..3]->(b:l2)",):
            got, want = pg.match(p), cpu.match(p)
            assert _same(got.vertex_mask, want.vertex_mask) and _same(got.edge_mask, want.edge_mask)
        if backend == "arr":
            assert ops.launches[ops.PACKED] >= mesh.size
        for store in (pg._vstore, pg._estore):
            assert store._store is None and store._sharded is not None
        seeds = nodes[:16]
        assert _same(pg.khop(seeds, 3, pattern="(a)-[:follows]->(b)"),
                     cpu.khop(seeds, 3, pattern="(a)-[:follows]->(b)"))
        assert _same(pg.shortest_paths(seeds, weight="w"), cpu.shortest_paths(seeds, weight="w"))
        assert torch.allclose(pg.pagerank(weight="w").cpu(), cpu.pagerank(weight="w"),
                              rtol=0, atol=1e-6)
        assert _same(pg.components(), cpu.components())


@pytest.mark.cuda
def test_sharded_kernels_launch_once_per_shard(meshes):
    rng = np.random.default_rng(0)
    for mesh in meshes:
        p = mesh.size
        plane = torch.from_numpy(rng.integers(-2**31, 2**31, (50, 64 * p), dtype=np.int64)
                                 .astype(np.int32))
        bitmap = torch.from_numpy(rng.integers(0, 2, (50, 1000 * p), dtype=np.int8))
        masks = torch.from_numpy(rng.random((3, 50)) < 0.2)
        wsh = tuple(c.contiguous().to(d) for c, d in zip(plane.chunk(p, 1), mesh.devices))
        bsh = tuple(c.contiguous().to(d) for c, d in zip(bitmap.chunk(p, 1), mesh.devices))
        ops.reset_launches()
        words = ops.bitmap_query_batched_packed_sharded(wsh, masks.to(mesh.lead), mesh=mesh)
        bits = ops.bitmap_query_batched_sharded(bsh, masks.to(mesh.lead), mesh=mesh)
        assert ops.launches == {ops.PACKED: p, ops.BYTE: p}
        assert torch.equal(torch.cat([w.cpu() for w in words], 1),
                           ops.bitmap_query_batched_packed(plane, masks))
        assert torch.equal(torch.cat([b.cpu() for b in bits], 1),
                           ops.bitmap_query_batched(bitmap, masks))
        with pytest.raises(ValueError, match="mesh device"):  # no shard runs elsewhere
            ops.bitmap_query_batched_sharded((bitmap[:, :1000].contiguous(),) * p,
                                             masks, mesh=mesh)


@pytest.mark.cuda
def test_byte_mesh_and_sample_on_card(meshes):
    cpu = pgserve.build_tenant_graph("arr", 3_000, seed=4, device="cpu")
    nodes = cpu.graph.node_map.numpy()
    for mesh in meshes:
        with bitplane.byte_masks():
            pg = pgserve.build_tenant_graph("arr", 3_000, mesh=mesh, seed=4)
            pg.match(SERVE_PATTERNS[0])  # seals byte shards
        ops.reset_launches()
        for p in SERVE_PATTERNS:
            got, want = pg.match(p), cpu.match(p)
            assert _same(got.vertex_mask, want.vertex_mask) and _same(got.edge_mask, want.edge_mask)
        assert ops.launches[ops.BYTE] >= mesh.size
        # sampling runs on the lead device: the card's draws give valid
        # blocks; equal to a single-device card graph's at the same key
        one = pgserve.build_tenant_graph("arr", 3_000, seed=4, device=mesh.lead)
        a = pg.sample(nodes[:64], [4, 3], seed=5)
        b = one.sample(nodes[:64], [4, 3], seed=5)
        for x, y in zip(a, b):
            for f in FIELDS:
                assert np.array_equal(np.asarray(getattr(x, f)), np.asarray(getattr(y, f))), f
