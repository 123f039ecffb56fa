"""Port ``repro_torch.core.io`` against ``repro.core.io``: a graph saved by
either package loads in the other (and in itself, under any backend) with
``match()`` answers bitwise equal to the graph that was saved; both write
the same arrays, keys and types; the save is atomic and leaves no litter."""
import json
import os

import numpy as np
import pytest
import torch

from _torch_parity import as_np, assert_same_match, ingest, raw_inputs
from repro.core import PropGraph as RefPG
from repro.core import io as rio
from repro_torch.core import PropGraph
from repro_torch.core import io as tio

BACKENDS = ("arr", "list", "listd")
PATTERNS = (
    "(a:rare)-[:follows]->(b:common)",
    "(a:mid {age > 20})-[e:likes {w < 0.5}]->(b)<-[:knows*1..2]-(c:rare)",
    "(a:common {tag != 3})-[:follows|likes*]->(b:mid)",
)


def _raw(seed=0):
    """The parity graph plus a uint32 vertex column (held as int64 on the
    port's device, saved as uint32)."""
    raw = raw_inputs(seed)
    raw["tag"] = np.random.default_rng(seed + 1).integers(0, 6, len(raw["age_nodes"]))
    return raw


def _ingest(pg, raw):
    pg = ingest(pg, raw)
    pg.add_node_properties("tag", raw["age_nodes"], raw["tag"].astype(np.uint32))
    return pg


def _port(backend="arr", seed=0):
    return _ingest(PropGraph(backend=backend, device="cpu"), _raw(seed))


def _ref(backend="arr", seed=0):
    return _ingest(RefPG(backend=backend), _raw(seed))


def _same_answers(a, b):
    for text in PATTERNS:
        assert a.explain(text) == b.explain(text)
        assert_same_match(a.match(text), b.match(text))
    assert a.label_counts() == b.label_counts()
    assert a.relationship_counts() == b.relationship_counts()


@pytest.mark.parametrize("backend", BACKENDS)
def test_round_trip_on_every_backend(tmp_path, backend):
    pg = _port(backend)
    path = tio.save_propgraph(str(tmp_path / "g"), pg)
    back = tio.load_propgraph(path, device="cpu")
    assert back.backend == backend
    _same_answers(pg, back)
    for f in ("src", "dst", "seg", "node_map"):
        got, want = getattr(back.graph, f), getattr(pg.graph, f)
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(as_np(got), as_np(want))
    assert back.graph.max_deg == pg.graph.max_deg
    for kind in ("node", "edge"):
        for name, (col, valid) in pg.host_columns(kind).items():
            gcol, gvalid = back.host_columns(kind)[name]
            assert gcol.dtype == col.dtype
            np.testing.assert_array_equal(gcol, col)
            np.testing.assert_array_equal(gvalid, valid)


@pytest.mark.parametrize("saved, loaded", [(s, t) for s in BACKENDS for t in BACKENDS if s != t])
def test_cross_backend_load(tmp_path, saved, loaded):
    path = tio.save_propgraph(str(tmp_path / "g"), _port(saved))
    back = tio.load_propgraph(path, backend=loaded, device="cpu")
    assert back.backend == loaded
    ref = _ref(loaded)
    _same_answers(ref, back)


@pytest.mark.parametrize("backend", BACKENDS)
def test_port_saves_reference_loads(tmp_path, backend):
    path = tio.save_propgraph(str(tmp_path / "g"), _port(backend))
    _same_answers(rio.load_propgraph(path), _ref(backend))


@pytest.mark.parametrize("backend", BACKENDS)
def test_reference_saves_port_loads(tmp_path, backend):
    path = rio.save_propgraph(str(tmp_path / "g"), _ref(backend))
    back = tio.load_propgraph(path, device="cpu")
    assert back.backend == backend
    _same_answers(_ref(backend), back)
    _same_answers(_port(backend), back)


def test_both_packages_write_the_same_arrays(tmp_path):
    """Same keys, same types (the reference's 32-bit columns; uint32 stays
    uint32), same values, same manifest."""
    rp = rio.save_propgraph(str(tmp_path / "ref"), _ref("listd"))
    tp = tio.save_propgraph(str(tmp_path / "port"), _port("listd"))
    with np.load(os.path.join(rp, "graph.npz")) as r, np.load(os.path.join(tp, "graph.npz")) as t:
        assert sorted(r.files) == sorted(t.files)
        for k in r.files:
            assert t[k].dtype == r[k].dtype, k
            np.testing.assert_array_equal(t[k], r[k], err_msg=k)
        assert t["vp_tag"].dtype == np.uint32 and t["vp_age"].dtype == np.int32
    with open(os.path.join(rp, "manifest.json")) as f, open(os.path.join(tp, "manifest.json")) as g:
        assert json.load(f) == json.load(g)


def test_loads_64_bit_index_arrays(tmp_path):
    """A graph whose index arrays and ``node_map`` were written as int64
    loads as int32, as the reference narrows them."""
    path = tio.save_propgraph(str(tmp_path / "g"), _port("list"))
    npz = os.path.join(path, "graph.npz")
    with np.load(npz) as z:
        data = {k: z[k] for k in z.files}
    for k in ("src", "dst", "seg", "node_map", "v_ent", "v_attr", "e_ent", "e_attr"):
        data[k] = data[k].astype(np.int64)
    np.savez_compressed(npz, **data)
    back = tio.load_propgraph(path, device="cpu")
    assert back.graph.node_map.dtype == torch.int32
    _same_answers(_port("list"), back)
    _same_answers(rio.load_propgraph(path), back)


def test_overwrite_leaves_no_litter(tmp_path):
    path = str(tmp_path / "g")
    tio.save_propgraph(path, _port("arr", seed=0))
    tio.save_propgraph(path, _port("listd", seed=1))
    assert sorted(os.listdir(tmp_path)) == ["g"]
    assert sorted(os.listdir(path)) == ["graph.npz", "manifest.json"]
    back = tio.load_propgraph(path, device="cpu")
    assert back.backend == "listd"
    _same_answers(_port("listd", seed=1), back)


def test_version_mismatch_raises(tmp_path):
    path = tio.save_propgraph(str(tmp_path / "g"), _port())
    man_path = os.path.join(path, "manifest.json")
    with open(man_path) as f:
        man = json.load(f)
    man["version"] = 2
    with open(man_path, "w") as f:
        json.dump(man, f)
    with pytest.raises(ValueError, match="format v2"):
        tio.load_propgraph(path, device="cpu")


def test_plane_only_store_does_not_save(tmp_path):
    """A graph built by ``from_arrays`` holds planes and no raw pairs: the
    save raises, and writes nothing."""
    imported = PropGraph.from_arrays(_port().to_arrays(), device="cpu")
    with pytest.raises(ValueError, match="no raw"):
        tio.save_propgraph(str(tmp_path / "g"), imported)
    assert os.listdir(tmp_path) == []


def test_load_contracts(tmp_path, monkeypatch):
    path = tio.save_propgraph(str(tmp_path / "g"), _port())
    with pytest.raises(TypeError, match="mesh"):  # a mesh is an EntityMesh
        tio.load_propgraph(path, mesh=object(), device="cpu")
    with pytest.raises(ValueError, match="backend"):
        tio.load_propgraph(path, backend="nope", device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        tio.load_propgraph(path)
