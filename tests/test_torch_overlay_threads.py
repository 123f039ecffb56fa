"""The port's overlay under concurrent writes, on the CPU (the in-process
cases of ``tests/test_overlay_concurrency.py``): snapshot reads stay pinned
while a writer thread streams batches into the parent, and writes racing a
background ``Compactor`` are never lost.  Each result is also held to the
reference run of the same stream without threads.  (The service case waits
for the service's port, the eight-device case for the mesh's.)
"""
import threading
import time

import numpy as np

from _torch_parity import DictRegistry, as_np, assert_same_match, overlay_pair
from repro_torch.overlay import Compactor

PATTERN = "(a:l1|l2)-[:follows]->(b:l3)"
COMP_PATTERN = "(a)-[:follows]->(b)"
N_BATCHES = 10
BATCH = 32


def _batches(nodes, seed):
    rng = np.random.default_rng(seed)
    return [(rng.choice(nodes, BATCH), rng.choice(nodes, BATCH)) for _ in range(N_BATCHES)]


def _write(pg, batches):
    for bs, bd in batches:
        pg.insert_edges(bs, bd)
        pg.add_edge_relationships(bs, bd, ["follows"] * BATCH)
        pg.add_node_labels(bs[:8], ["l1"] * 8)


def test_snapshot_reads_are_isolated_from_writer_thread():
    ref, port, meta = overlay_pair(31, n=60, m=300)
    snap = port.snapshot()
    want_comp = as_np(snap.components(COMP_PATTERN)).copy()
    want_match = snap.match(PATTERN)
    batches = _batches(meta["nodes"], 37)
    stop, errors = threading.Event(), []

    def writer():
        try:
            for bs, bd in batches:
                port.insert_edges(bs, bd)
                port.add_edge_relationships(bs, bd, ["follows"] * BATCH)
                time.sleep(0.002)
        except Exception as e:  # noqa: BLE001 — reported below
            errors.append(e)
        finally:
            stop.set()

    t = threading.Thread(target=writer)
    t.start()
    reads = 0
    while not stop.is_set() or reads < 3:
        assert np.array_equal(as_np(snap.components(COMP_PATTERN)), want_comp), reads
        assert_same_match(want_match, snap.match(PATTERN))
        reads += 1
        if reads > 500:
            break
    t.join(timeout=60)
    assert not errors, errors
    assert port.delta_stats()["delta_edges"] > 0 and snap.delta_stats()["delta_edges"] == 0
    for bs, bd in batches:  # the parent converged to the reference's answer
        ref.insert_edges(bs, bd)
        ref.add_edge_relationships(bs, bd, ["follows"] * BATCH)
    assert_same_match(ref.match(PATTERN), port.match(PATTERN))
    assert np.array_equal(as_np(port.components(COMP_PATTERN)),
                          as_np(ref.components(COMP_PATTERN)))


def test_writes_survive_concurrent_background_compaction():
    """A writer streaming batches while the Compactor folds the overlay
    again and again loses NOTHING: the final compacted graph is bitwise
    what the same stream gives with no compactor racing it, in the port
    and in the reference."""

    def run(threshold):
        ref, pg, meta = overlay_pair(41, n=60, m=300)
        comp = None
        if threshold is not None:
            comp = Compactor(DictRegistry(g=pg), threshold=threshold, interval=0.001)
            comp.start()
        try:
            _write(pg, _batches(meta["nodes"], 53))
        finally:
            if comp is not None:
                deadline = time.monotonic() + 60
                while pg.has_overlay() and time.monotonic() < deadline:
                    time.sleep(0.005)
                comp.stop()
                assert comp.compactions >= 1
                assert comp.errors == 0, comp.last_error
        pg.compact()
        return ref, pg, meta

    _, raced, _ = run(16)
    ref, quiet, meta = run(None)
    _write(ref, _batches(meta["nodes"], 53))
    ref.compact()
    for pg in (raced, ref):
        assert (pg.n_vertices, pg.n_edges) == (quiet.n_vertices, quiet.n_edges)
        assert pg.label_counts() == quiet.label_counts()
        assert pg.relationship_counts() == quiet.relationship_counts()
        assert_same_match(pg.match(PATTERN), quiet.match(PATTERN))
        assert np.array_equal(as_np(pg.components(COMP_PATTERN)),
                              as_np(quiet.components(COMP_PATTERN)))


def test_snapshot_taken_under_a_writer_is_consistent():
    """snapshot() clones under the write lock: every snapshot taken while a
    writer streams holds a whole number of batches — its edge delta and its
    relationship delta always come from the same batches."""
    _, port, meta = overlay_pair(43, n=60, m=300)
    batches = _batches(meta["nodes"], 59)
    done = threading.Event()

    def writer():
        for bs, bd in batches:
            with port._write_lock:  # one batch = one atomic step here
                port.insert_edges(bs, bd)
                port.add_edge_relationships(bs, bd, ["follows"] * BATCH)
        done.set()

    t = threading.Thread(target=writer)
    t.start()
    seen = 0
    while not done.is_set() or seen < 3:
        snap = port.snapshot()
        assert snap._estore._delta.size % BATCH == 0
        seen += 1
        if seen > 2000:
            break
    t.join(timeout=60)
    assert port._estore._delta.size == BATCH * N_BATCHES
