"""Graph generators.

``random_uniform_graph`` reproduces the paper's §VII-A dataset regime: two
endpoint arrays of length m filled with uniform integers from a pool of size m
("we set the random vertex integers created to be that of the same size as
number of edges to minimize the amount of multiple edges"), giving
n ≈ 0.865·m distinct vertices and avg degree ≈ 1 — matching Tab. I exactly
(graph1: n=86,503 ≈ 0.865e5 for m=1e5).  Attribute assignment mirrors §VII-A:
a pool of ``n_attrs`` (=50) labels/relationships sampled uniformly with
replacement, "some vertices or edges could be repeated and some not selected".

``rmat_graph`` adds the standard Graph500 power-law generator for structure-
sensitive benchmarks (the paper defers structure effects to future work; we
include it so the harness can probe them).
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

__all__ = ["random_uniform_graph", "rmat_graph", "attach_random_attributes", "paper_graph"]

# the paper's Tab. I ladder: name -> number of edges
PAPER_GRAPHS = {
    "graph1": 100_000,
    "graph2": 1_000_000,
    "graph3": 10_000_000,
    "graph4": 100_000_000,
    "graph5": 1_000_000_000,
}


def random_uniform_graph(m: int, *, seed: int = 0, vertex_pool: Optional[int] = None):
    """§VII-A generator: (src, dst) uniform over a pool of size ``m``."""
    rng = np.random.default_rng(seed)
    pool = m if vertex_pool is None else vertex_pool
    src = rng.integers(0, pool, size=m, dtype=np.int64)
    dst = rng.integers(0, pool, size=m, dtype=np.int64)
    return src, dst


def rmat_graph(scale: int, edge_factor: int = 16, *, a=0.57, b=0.19, c=0.19, seed: int = 0):
    """Graph500 R-MAT: 2**scale vertices, edge_factor·2**scale edges."""
    rng = np.random.default_rng(seed)
    n_edges = edge_factor * (1 << scale)
    src = np.zeros(n_edges, dtype=np.int64)
    dst = np.zeros(n_edges, dtype=np.int64)
    for lvl in range(scale):
        r = rng.random(n_edges)
        src_bit = r > (a + b)
        dst_bit = ((r > a) & (r <= a + b)) | (r > (a + b + c))
        src |= src_bit.astype(np.int64) << lvl
        dst |= dst_bit.astype(np.int64) << lvl
    return src, dst


def attach_random_attributes(
    n_entities: int, *, n_attrs: int = 50, coverage: float = 1.0, seed: int = 0
) -> Tuple[np.ndarray, np.ndarray]:
    """§VII-A attribute assignment: each selected entity draws one attribute
    uniformly from a pool of ``n_attrs`` (paper sets 50 for both labels and
    relationships).  ``coverage`` < 1 leaves some entities bare (the paper's
    'some not selected at all')."""
    rng = np.random.default_rng(seed)
    cnt = int(n_entities * coverage)
    entities = rng.choice(n_entities, size=cnt, replace=True).astype(np.int64)
    attrs = rng.integers(0, n_attrs, size=cnt, dtype=np.int64)
    return entities, attrs


def paper_graph(name: str, *, scale_down: int = 1, seed: int = 0):
    """Tab. I graph, optionally scaled down by ``scale_down`` (CPU container
    cannot hold 1e9 edges; benchmarks report the scale factor alongside)."""
    m = PAPER_GRAPHS[name] // scale_down
    return random_uniform_graph(m, seed=seed)
