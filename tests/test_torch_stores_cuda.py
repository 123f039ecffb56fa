"""The list and listd stores on the card against the same stores on the
CPU (whose answers the CPU parity tests hold to the reference package):
every query impl on inputs with repeated pairs and entity ids outside
[0, n), bitwise, and ``PropGraph(backend=...)`` on the card answering the
phase-3 request kinds and sampling (B3) as the arr graph does.  Needs an
NVIDIA card (marker ``cuda``; skips without one); imports neither JAX nor
the reference package:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_stores_cuda.py
"""
import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

from _torch_parity import ingest, raw_inputs
from repro_torch.core import PropGraph
from repro_torch.core import dip_list as tdl
from repro_torch.core import dip_listd as tdd
from repro_torch.kernels.neighbor_sample import ops as ns_ops

_spec = importlib.util.spec_from_file_location(
    "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
chip_smoke = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(chip_smoke)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: this holds the card's answers to the CPU's")
    return torch.device("cuda")


def _pairs(seed, n=5000, k=40, nnz=60_000):
    rng = np.random.default_rng(seed)
    ent = rng.integers(-n - 50, n + 50, nnz)  # some wrap, some drop
    ent[: nnz // 2] = rng.integers(0, 20, nnz // 2)  # hubs: many repeated pairs
    return ent, rng.integers(0, k, nnz), k, n


@pytest.mark.cuda
@pytest.mark.parametrize("seed", [0, 1])
def test_store_queries_on_card_equal_cpu(cuda, seed):
    ent, att, k, n = _pairs(seed)
    masks = [np.random.default_rng(seed + i).random(k) < p for i, p in enumerate((0.03, 0.3, 1.0))]
    lc = tdl.build_dip_list(np.abs(ent), att, k=k, n=n, device="cpu")
    lg = tdl.build_dip_list(np.abs(ent), att, k=k, n=n, device=cuda)
    dc = tdd.build_dip_listd(ent, att, k=k, n=n, device="cpu")
    dg = tdd.build_dip_listd(ent, att, k=k, n=n, device=cuda)
    for mask in masks:
        mc, mg = torch.from_numpy(mask), torch.from_numpy(mask).to(cuda)
        assert tdl.query_any(lg, mg).cpu().equal(tdl.query_any(lc, mc))
        for impl in ("linked", "inverted"):
            assert tdd.query_any(dg, mg, impl=impl).cpu().equal(tdd.query_any(dc, mc, impl=impl))
        ids = torch.from_numpy(np.flatnonzero(mask).astype(np.int32))
        for budget in (1, 500, 60_000):
            assert tdd.query_any_budget(dg, ids.to(cuda), budget=budget).cpu().equal(
                tdd.query_any_budget(dc, ids, budget=budget))


@pytest.mark.cuda
@pytest.mark.parametrize("backend", ["list", "listd"])
def test_propgraph_on_card_answers_as_arr(cuda, backend):
    raw = raw_inputs(0, n_pool=3000, m=40_000)
    rng = np.random.default_rng(3)
    raw["labels"] = rng.choice([f"l{i}" for i in range(4)], size=len(raw["labels"]))
    raw["rels"] = rng.choice([f"r{i}" for i in range(3)], size=len(raw["rels"]))
    raw["ages"] = rng.integers(0, 100, len(raw["ages"]))
    arr = ingest(PropGraph(backend="arr", device="cpu"), raw)
    card = ingest(PropGraph(backend=backend, device=cuda), raw)
    for kind, text in chip_smoke.requests(6):
        assert chip_smoke.same_result(card.match(text), arr.match(text)), kind
    ns_ops.reset_launches()
    blocks = card.sample("(a:l0)", [5, 3], key=11)
    torch.cuda.synchronize()
    assert ns_ops.launches[ns_ops.WINDOW_SELECT] == 2
    want = ingest(PropGraph(backend="arr", device=cuda), raw).sample("(a:l0)", [5, 3], key=11)
    assert chip_smoke.same_blocks(blocks, want)
