"""Randomized overlay mutation streams, replayed into the reference and the
port on the CPU (ROADMAP A8 "Parity"): over seeds 0..30 and every store,
``overlay_stream`` interleaves inserts (with base duplicates), relationship
and label writes (values first seen after the seal among them), base and
delta edge deletes, revivals, vertex deletes, property updates, a snapshot
and a fork.  After every step the six request kinds (bitwise), the counts
(dtype included), sizes and overlay stats equal the reference's; at the
end the snapshot still answers as it did when taken, the parent of the
fork answers as it did before the fork, and compaction equals the
reference's compaction bitwise.

Plain parametrized tests, not hypothesis: the reference's own
``_hyp_seeded`` tests do not run under hypothesis 6.142 (ROADMAP C.3).
"""
import pytest

from _torch_parity import (
    OV_PATTERNS,
    assert_same_flat,
    assert_same_match,
    assert_same_overlay,
    flat_state,
    overlay_pair,
    overlay_stream,
)

SEEDS = range(31)


@pytest.mark.parametrize("backend", ["arr", "list", "listd"])
@pytest.mark.parametrize("seed", SEEDS)
def test_mutation_stream_matches_the_reference(seed, backend):
    ref, port, meta = overlay_pair(seed, backend)
    pinned = []  # (ref view, port view, port answers when pinned)
    for step in overlay_stream(seed, meta):
        if step[0] in ("snapshot", "fork"):
            views = ref.snapshot(), port.snapshot()
            pinned.append((*views, [views[1].match(t) for _, t in OV_PATTERNS]))
            if step[0] == "fork":
                ref, port = ref.fork(), port.fork()
            continue
        getattr(ref, step[0])(*step[1])
        getattr(port, step[0])(*step[1])
        assert_same_overlay(ref, port)
    for ref_view, port_view, answers in pinned:
        for (_, text), want in zip(OV_PATTERNS, answers):
            assert_same_match(want, port_view.match(text))
        assert_same_overlay(ref_view, port_view)
    ref.compact()
    port.compact()
    assert not port.has_overlay()
    assert_same_flat(flat_state(ref), flat_state(port))
    assert_same_overlay(ref, port)
