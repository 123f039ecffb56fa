#!/usr/bin/env python3
"""On-card smoke test of the PyTorch/CUDA port (``src/repro_torch``).

    python3 chip_smoke.py [--edges 10000000] [--seed 0]

Needs one CUDA card and ``nvcc``; exits non-zero without them.  Phases,
none of whose failures is caught:

1. print the card's name and power limit; build the CUDA kernels from
   ``src/repro_torch/kernels/*/csrc``, one ``nvcc`` per source, together;
2. hold every kernel against its plain PyTorch version on the card over
   ragged shapes (B1 and B2 also with few rows selected, B2 also at every
   N mod 16, with bytes other than 0 and 1 and from an unaligned base, B3
   on calls that mix one-edge windows, hubs and fully filtered windows, B5
   also on x from an unaligned base): bitwise, or for
   seg_mm's float sums within a bound on reordered summation, and bitwise
   run to run, or for flash_attention within the reference's tolerances,
   each case on the kernel
   ``kernel.variant`` names (the wgmma/TMA kernel, the mma.sync kernel for
   other bf16 inputs, the SIMT kernel for f32);
3. the main path at the paper's Tab. I ``graph3`` scale (10M edges drawn
   uniformly from a pool of 10M ids, §VII-A; 50 labels, 50 relationships,
   one int64 vertex column, one float64 edge column): build a
   ``PropGraph(backend="arr")`` on the card, answer a mix of ``match()``
   requests (fused 1-hop, 2-hop with a fused edge batch, predicates,
   reversed hop, ``*1..3``, ``*``), time them, and hold every request kind
   bitwise against the same graph run through the port on the CPU;
3a. the paper's other two stores and persistence on the same graph:
   ``save_propgraph`` it, ``load_propgraph`` it back as ``list``, ``listd``
   and ``arr`` (load and seal timed apart: the paper's build comparison
   from the same raw pairs), answer phase 3's 32 requests on ``list`` and
   ``listd`` (timed) and the six kinds under listd's forced ``inverted``
   and ``budget`` impls, all bitwise equal to phase 3's answers (the
   reloaded ``arr`` graph too: the round trip); one ``linked`` walk of
   ``(a:l0)``'s chain (the paper's baseline, timed once) equal to the
   inverted answer; each store's bytes on the card (§IV-D); and one
   ``sample`` of ``(a:l0)`` on the listd graph, which runs B3, equal to
   the arr graph's blocks at the same key;
3b. sampling on the same graph: three ``PropGraph.sample`` requests with
   GraphSAGE's 15-10 fanouts (1,024 explicit ids; the seeds of a label
   pattern; a predicate pattern under an edge filter), timed; every layer
   checked by the port's ``check_sample`` and every block held bitwise
   against the port on the CPU fed the card's priorities;
3c. GNN serving on the same graph: a ``gcn-cora`` GCN at its published
   widths (d_in 1,433, 16 hidden, 7 classes; random weights from
   ``--seed``) answers node-classification requests for pattern-seeded
   minibatches: ``PropGraph.sample`` under an edge filter, the union of the
   blocks compacted into one ``GraphBatch`` whose features are gathered on
   the card from a (n, 1433) float32 table, then ``GCN.forward`` with its
   aggregation on the seg_mm kernel.  Eight ``minibatch`` requests of 1,024
   seeds drawn from a predicate pattern's vertices, and one ``population``
   request scoring every seed of a label pattern, timed and split into
   sample, batch and forward; one request of each kind held against the
   port on the CPU on the same blocks and features;
3d. recsys serving: ``dlrm-rm2`` at its published widths (26 tables of
   1,000,000 x 64 f32 rows on the card, 6.66 GB; random weights from
   ``--seed``) with its lookup on the embedding_bag kernel answers the
   request kinds of ``RECSYS_SHAPES``: 16 ``serve_p99`` requests of 512
   rows, a ``serve_bulk`` request of 262,144 rows, a ``retrieval_cand``
   query against 1,000,000 candidates (top-100); batches from
   ``dlrm_batch`` on the host, timed end to end; one request of each kind
   held to the port on the CPU fed the rows the batch names.  Then the
   graph-side user context (``examples/recsys_serving.py``'s second half):
   ``sample_embed`` of 512 pattern-seeded users under the edge filter's
   packed mask from an (n, 64) table, and each user's top-5 items over
   1,000,000 rows, held to the CPU port replayed on the card's priorities;
3e. LM serving: ``gemma2-9b`` at its published widths and depth (42
   layers, d 3,584, 16 query and 8 KV heads of 256, d_ff 14,336, vocab
   256,000; 9.24 B random weights from ``--seed`` held in bf16, 18.5 GB on
   the card) with its prefill attention on the wgmma/TMA flash_attention
   kernel (every launch of both prefill kinds) answers ``prefill_8k`` (one 8,192-token prompt: ``prefill_32k`` of
   ``LM_SHAPES`` cut from 32 x 32,768), ``prefill_batch`` (8 x 1,024) and
   ``generate`` (``launch/serve.py``'s decode loop, batch 4, 16 prompt and
   16 greedy tokens), timed; checked (b) at full depth: every layer's
   kernel output against the port's plain chunked attention on its inputs
   (bf16), and the logits of a 4,608-token prefill against the plain paths'
   in f32; (c) at full width and two layers in f32 against the port on the
   CPU, (d) on that model decode's logits at every position against the
   forward's;
3f. the frontier and semiring analytics on graph3 (``ANALYTICS``), last of the
   phase-3 family (see ``run``):
   ``khop`` (1,024 seeds from ``--seed``, k = 3, ``frontier`` and ``csr``),
   ``components``, ``shortest_paths`` (weight ``w``), ``pagerank`` (weight
   ``w``) and ``communities``, unfiltered and under a filter of 25
   relationships (PageRank: 25 labels), each timed (median of 3 after a
   warm run) with its relax rounds and whether it reached its cap, and
   profiled once (busy share, top device ops); the filtered ones must
   launch B1.  k-hop held bitwise to the CPU port (csr equal to the frontier
   path), components and shortest paths by certificates and over their
   first rounds to the CPU port (in full where the host takes at most
   30 s), PageRank within an L1 distance,
   communities bitwise at a few rounds; then every request at its full cap
   on ``graph1`` (100K edges) against the CPU port;
3g. the overlay on a ``fork()`` of graph3 and the same stream on a fork of
   its CPU twin (``overlay_ops``, every draw from ``--seed``): 12 batches
   of ``insert_edges`` (8,192 pairs, 256 of them base edges), relationships
   on them (r50 first seen after the seal) and labels on 4,096 vertices
   (l50 new), one ``match()`` after each batch (the read under writes, each
   write batch timed), a ``snapshot()`` after batch 6, deletes of 4,096
   base and 512 delta edges, a re-insert of 256 deleted pairs (revival),
   deletes of the 16 highest out-degree vertices and 1,024 drawn ones,
   ``age`` and ``w`` updates on 4,096 entities each; then phase 3's 32
   requests (timed, each kind bitwise to the CPU fork), k-hop (``csr``
   degrades to the frontier step and equals it), components (certificate,
   and the first rounds against the CPU fork), PageRank over ``w`` (L1),
   and ``sample`` of ``(a:l0)`` (15-10) over the re-sorted view (its build
   timed), bitwise against the CPU fork on the card's priorities; B1 and B3
   must launch.  Then ``compact()``, timed: every kind keeps its answer in
   external ids, the snapshot answers as it did, and the parent graph
   still equals phase 3.  The same stream at graph1 (batches of 128):
   compaction bitwise equal to the CPU port's and to a from-scratch build
   of the surviving state;
4. the byte layout (``byte_masks()``): build it and answer a fused pattern,
   which runs the byte kernel; its masks must equal the packed graph's; the
   same request timed warm (median of 5, ``byte_request_ms``);
5. time each kernel at the main path's shapes beside its plain version,
   its bound and (where one exists) a PyTorch call computing the same:
   ``ms`` brackets calls of the wrapper with events, ``device_ms`` is the
   kernel's own time from the profiler (``ms`` also holds the host's time
   when a launch is shorter than the host's call); B1 and B2 also with
   every row selected; flash_attention also beside the mma.sync kernel it
   replaced on the path; B5ᵀ at 3j (a)'s backward shapes and B4's backward
   at 3j (b)'s, beside cuSPARSE and ``F.embedding_bag``'s backward; B6's
   backward at train_4k's layer and at prefill_8k's local and global
   layers, beside SDPA's backward (no softcap: not the same function),
   timed right after phase 2 while the process is young (``on_card``);
3h. last, after phase 5 (see ``run``), the service and wire layer over the
   same graph (``service_phase``):
   8 closed-loop client threads send 256 requests (zipf 1.1 over phase 3's
   texts, ``pgserve.synthetic_workload``) through ``Service.submit`` with
   both caches off (every request reaches the card; its fused masks
   coalesce into B1 launches) and then with the default caches, timed
   (p50, p95, QPS) beside ``run_sequential``; 9 sample requests of 1,024
   ids (15-10, the ninth under the edge filter) through
   ``Service.sample_batch`` (one B3 launch of 16 rows for their layer 0)
   and as 9 concurrent ``submit_sample`` calls; a ``PGServer`` on
   127.0.0.1 answering the port's ``PGClient`` (the six kinds, a
   pipelined burst of 32 with duplicates, metrics, a trace id); EXPLAIN
   ANALYZE twice; every answer bitwise phase 3's, every sample its solo
   run's; then ``python -m repro_torch.launch.pgserve --smoke`` and
   ``--net --smoke`` as subprocesses on the card;
3i. last, the entity mesh (``mesh_phase``): phase 3a's save of graph3
   reopened with ``load_propgraph(path, backend=b, mesh=mesh)`` as ``arr``
   (through ``GraphRegistry.load``), ``list`` and ``listd`` on a mesh of
   ``MESH_SHARDS`` shards of the one card (and over every card when there
   are several): load and seal timed, each shard's store bytes, no dense
   store kept; phase 3's requests (p50, p95, QPS) bitwise phase 3's
   answers; on ``arr`` k-hop (phase 3f's 1,024 seeds, k = 3, unfiltered
   and filtered), directed shortest paths over ``w``, components,
   communities and a sample of ``(a:l0)`` bitwise the single-device
   graph's, PageRank within an L1 distance, 5 service requests bitwise;
   one request on byte shards; each sharded query launches B1 (B2 on the
   byte shards) once per shard, read from the wrappers' counters;
3j. training, in three places: (a) inside 3c on its feature table
   (``train_gnn_phase``): ``gcn_cora.full_config()`` on 1,024-seed 15-10
   minibatches of ``GNN_SEED_POOL`` under ``GNN_FILTER`` drawn from (seed,
   step), AdamW as ``examples/gnn_sampled_training.py``; step 0's loss and
   every gradient within ``TRAIN_TOL`` of the CPU port on the same batch,
   30 steps under the ``TrainController`` (checkpoints every 10, a failure
   at 17) bitwise the unbroken run, 20 steps on one batch whose loss must
   fall, B5 four launches a step (two B5ᵀ), one layout per orientation a
   step, B3 every step and no B1 (the pool is 3c's, the filter's mask the
   graph's cached one); (b) after phase 5 (``train_dlrm_phase``), on 3d's model: 65,536-row
   ``train_batch`` steps, step 0's loss and gradients against the CPU port
   fed only the rows the batch names, every other row's gradient exactly 0,
   bitwise across two calls, a sparse rowwise update against the dense
   one, 3 dense AdamW steps; (c) after 3i, ``python -m
   repro_torch.launch.train`` for GCN and DLRM as subprocesses, each
   printing ``done``.  Phase 2 holds B5ᵀ and B4's backward to the plain
   backward; phase 5 times both, B5ᵀ at (a)'s backward shapes and at the
   population request's;
3k. LM training after 3j (b) (``train_lm_phase``): ``gemma2_9b``'s
   published widths (d 3,584, 16 query and 8 KV heads of 256, d_ff 14,336,
   vocab 256,000, softcaps 50 and 30) at ``train_4k``'s 4,096 tokens;
   (i) two layers (local, global) in f32 at ``LM_CHECK_SEQ`` tokens, step
   0's loss and every gradient with B6 forward and backward within
   ``LM_GRAD_TOL`` of the same under the plain chunked attention on the
   card; (ii) ``LM_TRAIN_LAYERS`` bf16 layers (``reduced``: 8 of 42, batch
   1 of 256), AdamW with f32 moments, with ``remat`` on and off: step 0's
   loss and gradients bitwise equal under both, ``LM_TRAIN_STEPS`` steps
   on one batch timed (batch, forward, backward, update) whose loss must
   fall, each run's peak memory; (iii) ``examples/train_lm_torch.py`` as a
   subprocess (a failure mid-run, the restart bitwise the unbroken run,
   ``OK``); (iv) after 3i, the training CLI for ``gemma2-9b`` beside 3j
   (c)'s.  Phase 2 holds B6's backward to the plain backward over ragged
   shapes (``B6_BWD_CASES``), bitwise run to run, and the forward's
   log-sum-exp to the plain one.

Kernel launch counts are zeroed right before each path and read right
after it; a kernel of the path that did not launch fails the run.  The
second-to-last lines are a JSON object with one entry per kernel and the
``nvidia-smi`` name/power-limit line; the last line is
``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

HBM_BYTES_PER_S = 3.35e12  # H100 SXM published memory rate
N_ATTRS = 50  # §VII-A: 50 labels and 50 relationships
SOURCES = {  # kernel family -> its CUDA source
    "bitmap_query": "src/repro_torch/kernels/bitmap_query/csrc/bitmap_query.cu",
    "neighbor_sample": "src/repro_torch/kernels/neighbor_sample/csrc/neighbor_sample.cu",
    "seg_mm": "src/repro_torch/kernels/seg_mm/csrc/seg_mm.cu",
    "embedding_bag": "src/repro_torch/kernels/embedding_bag/csrc/embedding_bag.cu",
    "flash_attention": "src/repro_torch/kernels/flash_attention/csrc/flash_attention.cu",
    "flash_attention_sm90": "src/repro_torch/kernels/flash_attention/csrc/flash_attention_sm90.cu",
    "flash_attention_bwd": "src/repro_torch/kernels/flash_attention/csrc/flash_attention_bwd.cu",
    "flash_attention_bwd_sm90":
        "src/repro_torch/kernels/flash_attention/csrc/flash_attention_bwd_sm90.cu",
}
FANOUTS = [15, 10]  # GraphSAGE 15-10
CHECK_ROWS = 4096  # rows of a sampled layer held to the Python-loop oracle
D_FEAT, N_CLASSES = 1433, 7  # gcn-cora's published widths (Cora: 1,433 features, 7 classes)
GNN_SEED_POOL = "(a:l0 {age > 50})"  # minibatch seeds are drawn from its vertices
GNN_POPULATION = "(a:l0)"  # the population request scores every seed it binds
GNN_FILTER = "(a)-[e {w < 0.5}]->(b)"  # only these edges may be sampled
GNN_MINIBATCHES, GNN_BATCH = 8, 1024
GNN_TOL = 1e-4  # card vs CPU logits, atol = rtol: cuBLAS and CPU matmuls round differently
SUM_RTOL = 1e-5  # seg_mm vs a plain version summing in another order, relative to Σ|terms|
P99_REQUESTS = 16  # serve_p99 requests of RECSYS_SHAPES' batch
RETRIEVAL_TOPK = 100
RECSYS_TOL = 1e-4  # card vs CPU logits and scores, atol = rtol: cuBLAS and CPU sum in other orders
CONTEXT_USERS, CONTEXT_FANOUT, CONTEXT_DIM, CONTEXT_TOPK = 512, 8, 64, 5
CONTEXT_ITEMS = 1_000_000  # item rows: the context table's last rows
ITEM_BLOCK = 131_072  # item rows scored at once: no (users, items) matrix is made
BAG_TOL = 1e-5  # card vs CPU context bags (a masked mean summed in another order)
BF16_FLOP_PER_S = 989e12  # H100 SXM published dense bf16 tensor-core rate
F32_FLOP_PER_S = 67e12  # H100 SXM published f32 rate outside the tensor cores
B6_TOL = {"float32": 2e-5, "bfloat16": 2e-2}  # the reference's flash tolerances (rtol = atol)
# B6's backward against the plain backward (f32 inputs: in float64; bf16: in f32 from the
# bf16 inputs), rtol and atol times the largest |gradient| of the tensor: f32 sums of up
# to Sq·G terms in another order, P as exp(s - lse); bf16 P and dS rounded to bf16 before
# their products (a relative 2^-9 each) and the gradients written in bf16
B6_GRAD_TOL = {"float32": 1e-4, "bfloat16": 2e-2}
# analytics (phase 3f): 1,024 seeds from --seed, k = 3; the edge filter keeps 25 of the 50
# relationships (about half the edges), the vertex filter 25 of the 50 labels
ANALYTICS_SEEDS, ANALYTICS_K = 1024, 3
ANALYTICS_EDGE_FILTER = "(a)-[:" + "|".join(f"r{i}" for i in range(25)) + "]->(b)"
ANALYTICS_VERTEX_FILTER = "(a:" + "|".join(f"l{i}" for i in range(25)) + ")"
ANALYTICS = [  # (request, PropGraph method, filter pattern, other settings)
    ("khop", "khop", None, {"k": ANALYTICS_K}),
    ("khop_csr", "khop", None, {"k": ANALYTICS_K, "impl": "csr"}),
    ("khop_filtered", "khop", ANALYTICS_EDGE_FILTER, {"k": ANALYTICS_K}),
    ("khop_csr_filtered", "khop", ANALYTICS_EDGE_FILTER, {"k": ANALYTICS_K, "impl": "csr"}),
    ("components", "components", None, {}),
    ("components_filtered", "components", ANALYTICS_EDGE_FILTER, {}),
    ("shortest_paths", "shortest_paths", None, {"weight": "w"}),
    ("shortest_paths_filtered", "shortest_paths", ANALYTICS_EDGE_FILTER,
     {"weight": "w", "undirected": True}),
    ("pagerank", "pagerank", None, {"weight": "w"}),
    ("pagerank_filtered", "pagerank", ANALYTICS_VERTEX_FILTER, {"weight": "w"}),
    ("communities", "communities", None, {}),
]
# graph3's components and shortest paths are held by certificates and over their first
# CPU_PROBE_ROUNDS rounds to the CPU port, whose per-round time projects a full CPU run;
# where that projection is at most CPU_FULL_S, the full answer is held to the CPU port too
# (on an H100's host components and the filtered shortest paths project 7-12 s, the
# directed shortest paths, ~370 rounds, 61-72 s: PERF.md §5), and every full answer at
# graph1.  Communities are held to the CPU port at graph3 at
# COMMUNITIES_CHECK_ROUNDS rounds (a round sorts 20M keys, seconds on the host) and at the
# full cap at graph1.
CPU_PROBE_ROUNDS, CPU_FULL_S, COMMUNITIES_CHECK_ROUNDS = 8, 30.0, 4
# PageRank: ranks summing to 1 over 8.6M vertices, summed in another order on the card
# (float atomics) than on the host; f32 rounding leaves an L1 distance ~1e-7
PR_L1_TOL, PR_SUM_TOL = 1e-5, 1e-4
# q and k entries of std QK_SCALE give scores (q·k)·D^-0.5 of std 9: they reach the
# softcap's scale (|s| ~ 20-40 over thousands of keys) and the attention is peaked,
# so outputs are single V rows rather than the mean of V.  There f32 cases are held
# to the plain version in float64: its own f32 rounding uses up the 2e-5 tolerance
# at such scores, the kernel's does not (phase 2 reports both; PERF.md, PR 15)
QK_SCALE = 3.0
# LM serving (phase 3e): LM_SHAPES["prefill_32k"] (32 x 32,768) cut to one prompt of
# Gemma-2's published context, 8,192 tokens: 32 such prompts do not fit one card
LM_REQUESTS = {"prefill_8k": (1, 8192), "prefill_batch": (8, 1024)}
LM_GENERATE = dict(batch=4, prompt_len=16, gen=16)  # launch/serve.py's CLI defaults
LM_CHECK_SEQ = 4608  # checks (b) in f32 and (c): past the 4,096 window
LM_F32_TOL = 1e-4  # f32 logits (atol = rtol) of paths whose matmuls round differently
# check (b) in f32 at full depth (atol = rtol): 42 layers grow f32 rounding differences
# between two correct paths to ~8e-3 at logits of absmax ~11 (direct vs chunked
# attention, measured on the H100); a model with its window off lands ~13 away
# (PERF.md, PR 15)
LM_DEPTH_TOL = 3e-2
# training (phase 3j): GCN at minibatch_lg's shape with examples/gnn_sampled_training.py's
# AdamW; DLRM at RECSYS_SHAPES["train_batch"], dense AdamW at lr 1e-3 from step 1
TRAIN_STEPS, TRAIN_CKPT_EVERY, TRAIN_FAIL_AT, TRAIN_FIXED_STEPS = 30, 10, 17, 20
GNN_TRAIN_OPT = dict(lr=5e-3, warmup_steps=5, total_steps=100)  # the example's AdamWConfig
DLRM_TRAIN_STEPS = 3
DLRM_TRAIN_OPT = dict(lr=1e-3, warmup_steps=1, total_steps=10_000)
TRAIN_TOL = 1e-4  # card vs CPU loss and gradients (atol = rtol): cuBLAS and CPU sum in other orders
SPARSE_LR = 0.01  # sparse_table_update's default
SPARSE_UPDATE_TOL = 1e-6  # sparse vs dense row updates: duplicates summed in other orders
TRAIN_CLI_TIMEOUT = 300  # seconds for each training CLI run as a subprocess
# LM training (phase 3k): gemma2-9b at its published widths, LM_SHAPES["train_4k"]'s
# 4,096 tokens, cut to LM_TRAIN_LAYERS of 42 layers (4 local/global pairs) and batch 1 of
# 256; bf16 weights, AdamW with f32 moments (lr 3e-4 from step 0) on one fixed batch
LM_TRAIN_LAYERS, LM_TRAIN_STEPS = 8, 4
LM_TRAIN_OPT = dict(lr=3e-4, warmup_steps=1, total_steps=10_000)
# step-0 loss and gradients of two full-width f32 layers at LM_CHECK_SEQ tokens, B6 forward
# and backward against the plain chunked attention, both on the card: rtol, and atol times
# each leaf's largest |gradient| (f32 sums in other orders: B6's dot products and
# exp(s - lse) against the chunked path's online softmax)
LM_GRAD_TOL = 1e-4
# examples/train_lm_torch.py: lm100m, a failure at step 31 (a restart from the checkpoint
# at 20), the restart bitwise the unbroken run, the loss improving over the 60 steps
LM_EXAMPLE_ARGS = ("--steps", "60", "--ckpt-every", "20", "--check-restart")


def check(cond: bool, what: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke check failed: {what}")


# ---------------------------------------------------------------- the data
def build_graph(src, dst, seed: int, device, sync=lambda: None):
    """Ingest the graph, its labels, relationships and two typed columns
    (§VII-A: each drawn entity takes one of ``N_ATTRS`` attributes).
    Returns the graph and the seconds each ingest step took (the input
    data for a step is made before its clock starts)."""
    from repro_torch.core import PropGraph
    from repro_torch.graph.generators import attach_random_attributes

    steps = {}

    def timed(name, fn, *args):
        t0 = time.perf_counter()
        fn(*args)
        sync()
        steps[name] = time.perf_counter() - t0

    pg = PropGraph(backend="arr", device=device)
    timed("edges", pg.add_edges_from, src, dst)
    nodes = pg.graph.node_map.cpu().numpy()
    es, ed = pg.graph.src.cpu().numpy(), pg.graph.dst.cpu().numpy()
    ents, attrs = attach_random_attributes(pg.n_vertices, n_attrs=N_ATTRS, seed=seed + 1)
    timed("labels", pg.add_node_labels, nodes[ents],
          np.array([f"l{i}" for i in range(N_ATTRS)])[attrs])
    ents, attrs = attach_random_attributes(pg.n_edges, n_attrs=N_ATTRS, seed=seed + 2)
    timed("relationships", pg.add_edge_relationships, nodes[es[ents]], nodes[ed[ents]],
          np.array([f"r{i}" for i in range(N_ATTRS)])[attrs])
    rng = np.random.default_rng(seed + 3)
    timed("vertex_column", pg.add_node_properties, "age", nodes,
          rng.integers(0, 100, pg.n_vertices, dtype=np.int64))
    timed("edge_column", pg.add_edge_properties, "w", nodes[es], nodes[ed],
          rng.random(pg.n_edges))
    # seal both stores: planes built and placed
    timed("seal", lambda: (pg._vstore.finalize(), pg._estore.finalize()))
    return pg, steps


def requests(count: int):
    """``count`` patterns cycling through the six request kinds."""
    kinds = [
        ("fused_1hop", "(a:l{0}|l{1})-[:r{0}]->(b:l{2})"),
        ("two_hop", "(a:l{0})-[:r{0}]->(b)-[:r{1}|r{2}]->(c:l{3})"),
        ("predicates", "(a:l{0} {{age > 50}})-[e:r{0} {{w < 0.25}}]->(b:l{1})"),
        ("reversed", "(a:l{0})<-[:r{0}]-(b:l{1})"),
        ("bounded", "(a:l{0})-[:r{0}*1..3]->(b)"),
        ("unbounded", "(a:l{0})-[:r{0}|r{1}*]->(b:l{2})"),
    ]
    out = []
    for i in range(count):
        name, text = kinds[i % len(kinds)]
        j = (7 * (i // len(kinds))) % (N_ATTRS - 4)
        out.append((name, text.format(j, j + 1, j + 2, j + 3)))
    return out


def same_result(a, b) -> bool:
    """Masks and bindings of two MatchResults equal bit for bit."""
    if not (a.vertex_mask.cpu().equal(b.vertex_mask.cpu())
            and a.edge_mask.cpu().equal(b.edge_mask.cpu())):
        return False
    ba, bb = a.bindings(), b.bindings()
    return set(ba) == set(bb) and all(ba[k].cpu().equal(bb[k].cpu()) for k in ba)


# ------------------------------------------------------------------ timing
def time_ms(fn, reps: int = 50) -> float:
    import torch

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


PROFILER_SESSIONS_MAX = 8  # sessions on_card takes at most while ``want`` goes unrecorded


def on_card(fn, sessions: int = 3, want: str | None = None):
    """``fn()`` under ``torch.profiler``: the events that ran on the card
    (kernels and copies), most time first, and the window's wall seconds.
    Only device-side events are kept: a host op's device time repeats its
    kernels'.  The profiler on the card's host loses device records, more
    often the older the process (``tools/profiler_session_probe.py``: from
    about 200 s, sessions of one DLRM forward alternate between all and
    part or none of its kernels; late in a run three sessions in a row have
    recorded nothing), but never adds any.  So ``fn`` runs under a second
    session and, unless the two recorded the same nonzero number of device
    events, a third; where ``want`` names a kernel, further sessions (up to
    ``PROFILER_SESSIONS_MAX``) follow until one records it.  The fullest
    session (of those that recorded ``want``, where any did) is returned
    and the caller's checks judge it.  Sessions that disagree are reported
    on stderr."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    def has_want(events):
        return want is None or any(want in e.key for e in events)

    recorded = []
    for session in range(1, PROFILER_SESSIONS_MAX + 1):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall_s = time.perf_counter() - t0
        events = sorted((e for e in prof.key_averages() if e.device_type == DeviceType.CUDA),
                        key=lambda e: e.self_device_time_total, reverse=True)
        recorded.append((sum(e.count for e in events), events, wall_s))
        agreed = session >= 2 and recorded[-1][0] == recorded[-2][0] > 0
        if any(has_want(ev) for _, ev, _ in recorded) and (agreed or session >= sessions):
            break
    counts = [n for n, _, _ in recorded]
    if len(set(counts)) > 1 or len(recorded) > sessions:
        print(f"on_card: profiler sessions recorded {counts} device events; the fullest is kept",
              file=sys.stderr, flush=True)
    _, events, wall_s = max(recorded, key=lambda r: (has_want(r[1]), r[0]))
    return events, wall_s


L2_FLUSH_BYTES = 256 * 2**20  # five times the H100's 50 MB L2
DEVICE_MS_BY_EVENTS: list = []  # kernels whose device_ms no profiler session recorded


def kernel_device_ms(fn, name: str, reps: int = 20, cold_l2: bool = False) -> dict:
    """The card's own time per launch of the kernels whose name holds
    ``name``, over ``reps`` calls of ``fn`` under ``torch.profiler``: the
    mean over the launches the profiler recorded (``recorded``), without
    the host's time between launches that ``time_ms`` sees when a launch is
    shorter than the host's call.  With ``cold_l2`` every call follows a
    write of ``L2_FLUSH_BYTES`` (its fill kernel is not counted), so the
    inputs come from HBM, not from what the last call left in L2.  Where
    several kernels' names hold ``name`` (a call launches each), ``ms`` is
    the sum of their means and ``by_kernel`` each one's mean.  Where no
    session of ``on_card`` recorded ``name``, ``ms`` is the mean of ``reps``
    calls, each between two CUDA events (``"from": "cuda_events"``: the
    call's whole time on the stream, at least the kernels' own)."""
    import torch

    fn()
    flush = torch.empty(L2_FLUSH_BYTES, dtype=torch.int8, device="cuda") if cold_l2 else None

    def call(events=None):
        if flush is not None:
            flush.zero_()
        if events:
            events[0].record()
        fn()
        if events:
            events[1].record()

    events, _ = on_card(lambda: [call() for _ in range(reps)], want=name)
    hits = [e for e in events if name in e.key]
    recorded = sum(e.count for e in hits)
    if not recorded:
        print(f"kernel_device_ms: no profiler session recorded {name}; timed by CUDA events",
              file=sys.stderr, flush=True)
        DEVICE_MS_BY_EVENTS.append(name)
        ms = []
        for _ in range(reps):
            pair = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            call(pair)
            torch.cuda.synchronize()
            ms.append(pair[0].elapsed_time(pair[1]))
        return {"ms": statistics.mean(ms), "recorded": 0, "calls": reps, "from": "cuda_events"}
    out = {"ms": sum(e.self_device_time_total for e in hits) / 1e3 / recorded,
           "recorded": recorded, "calls": reps, "from": "profiler"}
    if len(hits) > 1:
        out["by_kernel"] = {e.key[:80]: e.self_device_time_total / 1e3 / e.count for e in hits}
        out["ms"] = sum(out["by_kernel"].values())
    return out


B1_KERNEL, B2_KERNEL = "bitmap_query_packed_kernel", "bitmap_query_byte_kernel"
B3_KERNEL = "window_select_kernel"


def max_abs_err(a, b) -> float:
    import torch

    return float((a.to(torch.int64) - b.to(torch.int64)).abs().max()) if a.numel() else 0.0


def device_profile(pg, reqs) -> dict:
    """Answer ``reqs`` once more under ``torch.profiler``: the summed time
    of the work that ran on the card (kernels and copies, one stream, so
    they do not overlap) against the window's wall time — the device's busy
    share; the profiler's own host cost lengthens the window — and the
    kernels that took the most of it."""
    events, wall_s = on_card(lambda: [pg.match(text) for _, text in reqs])
    device_s = sum(e.self_device_time_total for e in events) / 1e6
    return {"wall_s": wall_s, "device_s": device_s,
            "busy_share": device_s / wall_s if device_s else "not measured",
            "top_ms": [(e.key[:60], e.self_device_time_total / 1e3, e.count)
                       for e in events[:12]]}


# ------------------------------------------------------------------ phases
# B1/B2 with few rows selected (the main path selects 1-3 of 50): (how, Q, K)
SPARSE_SELECT_CASES = [("one", 1, 50), ("one", 2, 50), ("none", 2, 50), ("second_tile", 3, 300),
                       ("per_group", 9, 50), ("per_group", 64, 300)]


def sparse_selects(how: str, q: int, k: int, gen):
    """(Q, K) bool selects of a few rows: ``one`` row for every query,
    ``none`` at all, rows only in the ``second_tile`` of 256 attribute rows,
    or ``per_group``: each group of 8 queries its own 3 rows, every query a
    random subset of them (some empty)."""
    import torch

    masks = torch.zeros((q, k), dtype=torch.bool)
    if how == "one":
        masks[:, int(torch.randint(0, k, (1,), generator=gen))] = True
    elif how == "second_tile":
        rows = 256 + torch.randperm(k - 256, generator=gen)[:3]
        masks[:, rows] = torch.rand((q, 3), generator=gen) < 0.7
        masks[0, rows[0]] = True
    elif how == "per_group":
        for g in range(0, q, 8):
            rows = torch.randperm(k, generator=gen)[:3]
            masks[g:g + 8, rows] = torch.rand((min(8, q - g), 3), generator=gen) < 0.5
    elif how != "none":
        raise ValueError(how)
    return masks


def mixed_windows(r: int, s: int, w: int, gen, ties: bool = False):
    """B3 inputs that mix window sizes in one call: Poisson(1) degrees, a
    few mid-size windows (9-32 lanes) and hubs (40-1,000 lanes, and one of
    W + 5, cut to the window), windows
    that start within a few edges of m, windows whose edge words are all
    zero (fully filtered), zero degrees; with ``ties`` priorities of three
    values.  Returns start, deg (R, S), dst (m,), words (R, W_m), pri
    (R, S, W) on the CPU."""
    import torch

    shape = (r, s)
    deg = torch.poisson(torch.ones(shape), generator=gen).to(torch.int32)
    pick = torch.rand(shape, generator=gen)
    mid = torch.randint(9, 33, shape, generator=gen, dtype=torch.int32)
    hub = torch.randint(40, 1001, shape, generator=gen, dtype=torch.int32)
    deg = torch.where(pick < 0.05, mid, torch.where(pick < 0.08, hub, deg))
    deg.view(-1)[0] = w + 5  # a hub cut to the window in every call
    deg[torch.rand(shape, generator=gen) < 0.05] = 0
    m = 2 * int(deg.sum()) + 4096 + 13
    start = (torch.rand(shape, generator=gen) * (m - 64)).to(torch.int32) + 64
    near_end = torch.rand(shape, generator=gen) < 0.05
    start = torch.where(near_end, m - torch.randint(1, 40, shape, generator=gen,
                                                    dtype=torch.int32), start)
    filtered = torch.rand(shape, generator=gen) < 0.05  # windows inside the zeroed words
    start = torch.where(filtered, torch.randint(0, 64, shape, generator=gen, dtype=torch.int32),
                        start)
    deg = torch.where(filtered, deg.clamp(max=2048 - 64), deg)
    dst = torch.randint(0, m, (m,), dtype=torch.int32, generator=gen)
    words = torch.randint(-2**31, 2**31, (r, -(-m // 32)), dtype=torch.int64,
                          generator=gen).to(torch.int32)
    words[:, :2048 // 32] = 0
    pri = torch.rand((r, s, w), generator=gen)
    if ties:
        pri = torch.floor(pri * 3) / 3
    return start, deg, dst, words, pri


def kernel_checks(device) -> dict:
    """Every kernel against its plain version, bitwise, on ragged shapes
    (B5 and B6 within their tolerances); returns the shares of the
    tolerance B6's cases use (``flash_attention_checks``)."""
    import torch

    from repro_torch.kernels.bitmap_query import ops, ref

    gen = torch.Generator(device="cpu").manual_seed(0)
    for q in (1, 2, 3, 8, 64):
        for k in (1, 50, 129, 300):
            for cols in (1, 31, 4099, 100_003):
                masks = (torch.rand((q, k), generator=gen) < 0.3).to(device)
                plane = torch.randint(-2**31, 2**31, (k, cols), dtype=torch.int64,
                                      generator=gen).to(torch.int32).to(device)
                got = ops.bitmap_query_batched_packed(plane, masks)
                check(got.equal(ref.bitmap_query_batched_packed_ref(plane, masks)),
                      f"B1 Q={q} K={k} W={cols}")
                bitmap = (torch.rand((k, cols), generator=gen) < 0.05).to(torch.int8).to(device)
                got = ops.bitmap_query_batched(bitmap, masks)
                check(got.equal(ref.bitmap_query_batched_ref(bitmap, masks)),
                      f"B2 Q={q} K={k} N={cols}")
    plane = torch.randint(0, 2**31, (50, 4099), dtype=torch.int32).to(device)
    mask = torch.rand(50) < 0.5
    check(ops.bitmap_query_packed(plane, mask.to(device)).equal(
        ref.bitmap_query_packed_ref(plane, mask.to(device))), "B1 single query")
    for how, q, k in SPARSE_SELECT_CASES:
        for cols in (1, 31, 4099, 100_003):
            masks = sparse_selects(how, q, k, gen).to(device)
            plane = torch.randint(-2**31, 2**31, (k, cols), dtype=torch.int64,
                                  generator=gen).to(torch.int32).to(device)
            check(ops.bitmap_query_batched_packed(plane, masks).equal(
                ref.bitmap_query_batched_packed_ref(plane, masks)),
                f"B1 {how} selects Q={q} K={k} W={cols}")
            bitmap = (torch.rand((k, cols), generator=gen) < 0.05).to(torch.int8).to(device)
            check(ops.bitmap_query_batched(bitmap, masks).equal(
                ref.bitmap_query_batched_ref(bitmap, masks)),
                f"B2 {how} selects Q={q} K={k} N={cols}")
    byte_query_checks(device, gen)
    window_select_checks(device)
    embedding_bag_checks(device)
    seg_mm_checks(device)
    train_backward_checks(device)
    shares = flash_attention_checks(device)
    shares.update(flash_attention_bwd_checks(device))
    torch.cuda.synchronize()
    return shares


# B2's byte values: the store writes 0 and 1; any nonzero byte counts as set (ROADMAP C.16)
BYTE_VALUES = (0,) * 16 + (1, -128, -1, 2)
# (N, Q, K) for B2's alignment cases: N at every residue mod 16, past one 4,096-entity block,
# and graph3-like N = 14 (mod 16)
BYTE_ALIGN_CASES = ([(n, q, k) for n in range(1, 35) for q, k in ((1, 3), (2, 50), (9, 20))]
                    + [(n, 2, 50) for n in (4095, 4097, 4110, 100_014)] + [(1_000_014, 2, 5)])


def byte_query_checks(device, gen) -> None:
    """B2 against its plain version, bitwise, where its realigned 16-byte
    loads and staged stores could go wrong: N at every residue mod 16, so
    that rows and output rows start at every offset from alignment; bytes
    -128, -1 and 2 beside 0 and 1; and bitmaps whose base is not 16-byte
    aligned (a view 3 bytes into a larger tensor)."""
    import torch

    from repro_torch.kernels.bitmap_query import ops, ref

    values = torch.tensor(BYTE_VALUES, dtype=torch.int8)
    for n, q, k in BYTE_ALIGN_CASES:
        masks = torch.rand((q, k), generator=gen) < 0.3
        masks[0, 0] = True
        masks = masks.to(device)
        for off in (0, 3):
            big = values[torch.randint(0, len(BYTE_VALUES), (k * n + off,), generator=gen)]
            bitmap = big.to(device)[off:off + k * n].view(k, n)
            check(ops.bitmap_query_batched(bitmap, masks).equal(
                ref.bitmap_query_batched_ref(bitmap, masks)),
                f"B2 bytes in {sorted(set(BYTE_VALUES))} N={n} Q={q} K={k} base offset {off}")


def window_select_checks(device) -> None:
    """B3 against its plain version, bitwise: ragged windows (degrees past
    W, zero degrees, a ragged last edge word), no / shared / per-request
    edge words, and every other case with priorities forced to tie; then
    calls that mix small windows, mid-size ones and hubs
    (``mixed_windows``), with and without ties."""
    import torch

    from repro_torch.kernels.neighbor_sample import ops, ref

    gen = torch.Generator(device="cpu").manual_seed(1)
    case = 0
    for r in (1, 8):
        for s in (1, 17, 1024, 262_144):
            for w in (8, 16, 64, 1024):
                if r * s * w > 2**28:  # keep the plain version's sort within 1 GiB of input
                    continue
                m = 2 * s * min(w, 64) + 13
                dst = torch.randint(0, m, (m,), dtype=torch.int32, generator=gen)
                deg = torch.randint(0, w + 5, (r, s), dtype=torch.int32, generator=gen)
                deg[torch.rand((r, s), generator=gen) < 0.1] = 0
                deg = deg.clamp(max=m)
                start = (torch.rand((r, s), generator=gen) * (m - deg + 1)).to(torch.int32)
                pri = torch.rand((r, s, w), generator=gen)
                if case % 2:
                    pri = torch.floor(pri * 3) / 3
                words = torch.randint(-2**31, 2**31, (r, -(-m // 32)), dtype=torch.int64,
                                      generator=gen).to(torch.int32)
                args = [t.to(device) for t in (start, deg, dst, pri, words)]
                start, deg, dst, pri, words = args
                for fanout in (1, 10, 15):
                    if fanout > w:
                        continue
                    for ew in (None, words[0].contiguous(), words):
                        got = ops.window_select(start, deg, dst, ew, pri, fanout=fanout)
                        want = ref.window_select_ref(start, deg, dst, ew, pri, fanout=fanout)
                        check(all(a.equal(b) for a, b in zip(got, want)),
                              f"B3 R={r} S={s} W={w} fanout={fanout} "
                              f"words={None if ew is None else tuple(ew.shape)} ties={case % 2}")
                case += 1
                del args, start, deg, dst, pri, words
    for r in (1, 8):
        for s in (1, 300, 65_536):
            for w in (16, 1024, 2048):  # 2048: hubs past the 1,024 lanes held in registers
                if r * s * w > 2**28:  # as above
                    continue
                for ties in (False, True):
                    args = [t.to(device) for t in mixed_windows(r, s, w, gen, ties)]
                    start, deg, dst, words, pri = args
                    for fanout in (f for f in (1, 10, 15, 16, 17) if f <= w):
                        for ew in (None, words[0].contiguous(), words):
                            got = ops.window_select(start, deg, dst, ew, pri, fanout=fanout)
                            want = ref.window_select_ref(start, deg, dst, ew, pri, fanout=fanout)
                            check(all(a.equal(b) for a, b in zip(got, want)),
                                  f"B3 mixed windows R={r} S={s} W={w} fanout={fanout} "
                                  f"words={None if ew is None else tuple(ew.shape)} ties={ties}")
                    del args, start, deg, dst, pri, words


def same_bits(got, want) -> bool:
    """Equal values of one dtype and shape, NaN where and only where the
    other has NaN."""
    nan = want.isnan()
    return (got.shape == want.shape and got.dtype == want.dtype
            and bool((got.isnan() == nan).all()) and got[~nan].equal(want[~nan]))


def embedding_bag_checks(device) -> None:
    """B4 against its plain version, bitwise: the reference test's shapes
    (b, f, mh, v, d), RM2's serve shape, ragged D (scalar loads, several
    passes), MH = 0 and B = 0; each in f32 and bf16, with in-range
    indices and with wrapped and out-of-range ones (NaN bags)."""
    import torch

    from repro_torch.kernels.embedding_bag import ops, ref

    gen = torch.Generator(device="cpu").manual_seed(3)
    shapes = [(8, 4, 3, 100, 16), (16, 26, 1, 500, 64), (32, 2, 8, 50, 32),
              (512, 26, 1, 100_000, 64), (37, 5, 2, 40, 7), (9, 3, 4, 30, 300),
              (4, 2, 0, 10, 8), (0, 26, 1, 10, 64)]
    for b, f, mh, v, d in shapes:
        for dtype in (torch.float32, torch.bfloat16):
            for wild in (False, True):
                tables = torch.randn((f, v, d), generator=gen).to(dtype).to(device)
                lo, hi = (-v - 3, v + 3) if wild else (0, v)
                idx = torch.randint(lo, hi, (b, f, mh), generator=gen,
                                    dtype=torch.int32).to(device)
                got = ops.embedding_bag_fields(tables, idx)
                check(same_bits(got, ref.embedding_bag_ref(tables, idx)),
                      f"B4 B={b} F={f} MH={mh} V={v} D={d} {dtype} wild={wild}")


def attention_within(got, want) -> bool:
    """Within the reference's flash tolerance for ``got``'s dtype (rtol =
    atol); ``want`` may be computed in a wider type."""
    import torch

    tol = B6_TOL[str(got.dtype).split(".")[-1]]
    return torch.allclose(got.double(), want.double(), rtol=tol, atol=tol)


def attention_close(got, want, what: str) -> float:
    """B6 against its plain version within the reference's tolerance for
    the dtype; returns the largest difference."""
    import torch

    err = float((got.double() - want.double()).abs().max()) if got.numel() else 0.0
    check(got.shape == want.shape and bool(torch.isfinite(got).all()), f"{what}: shape, finite")
    check(attention_within(got, want), f"{what}: within {B6_TOL} (max err {err})")
    return err


def tolerance_share(got, want, tol: float) -> float:
    """The largest |got - want| / (tol + tol |want|): 1 is the limit."""
    got, want = got.double(), want.double()
    return float(((got - want).abs() / (tol + tol * want.abs())).max())


def flash_attention_checks(device) -> dict:
    """B6 against its plain version: ``prefill_8k``'s layer shapes (q (1,
    8192, 16, 256), k and v (1, 8192, 8, 256), bf16, cap 50) with the local
    window and without, on scores at the cap's scale (``QK_SCALE``); the
    wgmma/TMA kernel's own cases (interior and edge tiles, window and none,
    causal off, G = 1, 2, 4 and odd, D = 8..256, ragged Sq and Skv,
    q_offset, strided H, rows with no valid key); bf16 inputs TMA does not
    take (the mma.sync kernel); f32 cases (the SIMT kernel); rows with no
    valid key (q_offset past the window: the mean of V).  Each case names
    the kernel it must run, read from the per-kernel launch counts.  Where
    the cap is set and the scores reach it, the same call without the cap
    must fail the check: the check can tell the softcap from none.  Returns,
    for each case, the share of the tolerance the kernel uses and, for each
    f32 case held in float64, the share the f32 plain version uses."""
    import torch

    from repro_torch.kernels.flash_attention import ops, ref

    gen = torch.Generator(device=device).manual_seed(11)
    layer = (1, 8192, 8192, 16, 8, 256)
    big, small = QK_SCALE, 0.3
    bf16, f32 = torch.bfloat16, torch.float32
    cases = [(layer, bf16, big, dict(causal=True, window=4096, cap=50.0)),
             (layer, bf16, big, dict(causal=True, cap=50.0)),
             ((2, 640, 700, 16, 8, 256), f32, big, dict(causal=True, window=300, cap=50.0)),
             ((1, 256, 256, 16, 8, 256), bf16, 5.0, dict(causal=True, window=64, cap=30.0)),
             ((1, 256, 256, 16, 8, 256), f32, big, dict(causal=True, window=64, cap=30.0)),
             ((1, 77, 131, 4, 2, 16), f32, small, dict(causal=True)),
             ((2, 65, 300, 18, 2, 128), bf16, small, dict(causal=True, window=40, q_offset=200)),
             ((1, 33, 70, 2, 2, 40), bf16, small, dict(causal=False, window=20, cap=30.0)),
             # the wgmma/TMA kernel: G = 1, 2, 4, D = 64, 128, 256, ragged lengths
             ((1, 1000, 1000, 16, 8, 256), bf16, big, dict(causal=True, cap=50.0)),
             ((1, 300, 300, 4, 4, 256), bf16, big, dict(causal=True, window=100, cap=50.0)),
             ((2, 200, 333, 8, 2, 128), bf16, big, dict(causal=False, cap=30.0)),
             ((1, 130, 250, 6, 3, 64), bf16, small, dict(causal=True, window=70, q_offset=120)),
             ((1, 100, 130, 4, 4, 8), bf16, small, dict(causal=True)),
             ((1, 200, 200, 4, 2, 192), bf16, small, dict(causal=True, window=100)),
             # bf16 the TMA kernel does not take: D % 8 != 0 (the mma.sync kernel)
             ((1, 90, 120, 4, 2, 36), bf16, small, dict(causal=True, window=50, cap=30.0))]
    masked = dict(causal=True, window=64, q_offset=400)  # q_offset + i - 63 > Skv - 1 = 255
    shares = {}
    cases += [((1, 128, 256, 16, 8, 256), dt, small, masked) for dt in (bf16, f32)]
    for (b, sq, skv, hq, hkv, d), dtype, scale, kw in cases:
        q = (torch.randn((b, sq, hq, d), generator=gen, device=device) * scale).to(dtype)
        k = (torch.randn((b, skv, hkv, d), generator=gen, device=device) * scale).to(dtype)
        v = torch.randn((b, skv, hkv, d), generator=gen, device=device).to(dtype)
        # fresh contiguous tensors: TMA takes every bf16 case with D % 8 == 0
        expect = "simt" if dtype == f32 else ("sm90" if d % 8 == 0 else "mma")
        flash_attention_case(q, k, v, kw, scale, shares, expect, mean_of_v=kw is masked)
        del q, k, v
    # strided views of one packed projection (H strides TMA takes), and an H stride it
    # does not take (264 bytes: the mma.sync kernel)
    packed = (torch.randn((1, 300, 8, 128), generator=gen, device=device) * big).to(bf16)
    odd = torch.zeros((1, 300, 4, 132), dtype=bf16, device=device)[..., :128]
    odd.copy_(packed[:, :, :4])
    for q, expect in ((packed[:, :, :4], "sm90"), (odd, "mma")):
        flash_attention_case(q, packed[:, :, 4:6], packed[:, :, 6:], dict(causal=True, window=100,
                             cap=50.0), big, shares, expect)
    return shares


def flash_attention_case(q, k, v, kw: dict, scale: float, shares: dict, expect: str, *,
                         mean_of_v: bool = False) -> None:
    """One phase 2 case of B6 (``flash_attention_checks``): ``kernel.variant``
    names the ``expect`` kernel and it runs the case (counted under its
    name), within the tolerance of the plain version (f32 at the cap's
    scale: in float64); ``shares`` gets the share of the tolerance used."""
    import torch

    from repro_torch.kernels.flash_attention import kernel, ops, ref

    b, sq, hq, d = q.shape
    name = kernel.variant(q, k, v)
    what = f"B6 {name} {(b, sq, k.shape[1], hq, k.shape[2], d)} {q.dtype} qk x{scale} {kw}"
    check(name == expect, f"{what}: runs the {expect} kernel")
    ops.reset_launches()
    got = ops.flash_attention(q, k, v, **kw)
    check(ops.launches[ops.COUNTERS[name]] == ops.launches[ops.FLASH_ATTENTION] == 1,
          f"{what}: one launch of the {name} kernel")
    wide = q.dtype == torch.float32 and scale > 1  # the plain version in float64 (QK_SCALE)
    want = ref.flash_attention_ref(*(t.double() if wide else t for t in (q, k, v)), **kw)
    attention_close(got, want, what)
    tol = B6_TOL[str(q.dtype).split(".")[-1]]
    shares[what] = {"kernel": tolerance_share(got, want, tol)}
    if wide:
        shares[what]["plain_f32"] = tolerance_share(ref.flash_attention_ref(q, k, v, **kw), want,
                                                    tol)
    if mean_of_v:
        mean = v.float().mean(dim=1, keepdim=True).repeat_interleave(hq // k.shape[2], dim=2)
        attention_close(got, mean.expand(got.shape).to(q.dtype), what + " = mean of V")
    if kw.get("cap") is not None and scale > 1:
        uncapped = ops.flash_attention(q, k, v, **{**kw, "cap": None})
        check(not attention_within(uncapped, want), f"{what}: cap=None fails the check")
    ops.reset_launches()


def grads_within(got, want, tol: float):
    """(within, share): ``got`` within rtol ``tol`` and atol ``tol`` times
    the largest |want| (``want`` in a wider type), and the largest share of
    that limit used."""
    import torch

    got, want = got.double(), want.double()
    limit = tol * (want.abs() + float(want.abs().max()) + 1e-30)
    share = float(((got - want).abs() / limit).max()) if got.numel() else 0.0
    return bool(torch.isfinite(got).all()) and share <= 1.0, share


# B6's backward (phase 2): (b, sq, skv, hq, hkv, d), qk scale, dtypes, kwargs.  Ragged Sq ≠
# Skv, G = 1, 2, 8, D = 16, 64, 128, 256, causal on and off, window on and off, softcap on
# and off (at QK_SCALE the scores reach it), q_offset ≠ 0 (rows with no valid key at
# q_offset < 0 and past the window); train_4k's layer (whose 4,096 window masks nothing
# at 4,096 tokens) and prefill_8k's local layer (where it does), bf16: the LM's path.
# bf16 inputs TMA takes run on bwd_sm90 after the sm90 forward.  Last, bf16 inputs TMA
# refuses (D = 20; q, k, v views of rows PAD elements wider), which the mma forward takes,
# and bwd_mma after it: the backward recomputes S as that kernel did
B6_BWD_CASES = [
    ((1, 4096, 4096, 16, 8, 256), 0.3, ("bfloat16",), dict(causal=True, window=4096, cap=50.0)),
    ((1, 8192, 8192, 16, 8, 256), 0.3, ("bfloat16",), dict(causal=True, window=4096, cap=50.0)),
    ((1, 1000, 1000, 16, 8, 256), QK_SCALE, ("bfloat16", "float32"), dict(causal=True, cap=50.0)),
    ((1, 333, 200, 8, 1, 128), 0.3, ("bfloat16", "float32"), dict(causal=False, window=70,
                                                                  cap=30.0)),
    ((2, 130, 250, 4, 2, 64), 1.0, ("bfloat16", "float32"), dict(causal=True, window=50,
                                                                 q_offset=120)),
    ((1, 77, 131, 4, 4, 16), 1.0, ("bfloat16", "float32"), dict(causal=False)),
    ((1, 150, 150, 16, 2, 128), 1.0, ("bfloat16", "float32"), dict(causal=True, q_offset=-30)),
    ((1, 200, 300, 4, 2, 256), 1.0, ("bfloat16", "float32"), dict(causal=True, window=64,
                                                                  cap=50.0, q_offset=-10)),
    ((1, 64, 100, 2, 1, 16), 1.0, ("bfloat16", "float32"), dict(causal=False, window=8,
                                                                q_offset=100)),
    ((1, 90, 150, 4, 2, 20), 1.0, ("bfloat16",), dict(causal=True, cap=30.0, q_offset=-7)),
    ((2, 200, 170, 8, 2, 64), 0.3, ("bfloat16",), dict(causal=True, window=50, cap=50.0,
                                                       pad=4)),
    ((1, 130, 130, 8, 4, 256), 0.3, ("bfloat16",), dict(causal=True, window=40, cap=50.0,
                                                        pad=4)),
]


def flash_attention_bwd_checks(device) -> dict:
    """Phase 2: B6's backward (``flash_attention_bwd_sm90.cu`` after the sm90
    forward, ``flash_attention_bwd.cu`` after the others, through the
    autograd Function of ``ops.flash_attention``) against the plain backward
    ``ref.flash_attention_bwd_ref`` fed the plain forward's output and
    log-sum-exp, on ``B6_BWD_CASES``, within ``B6_GRAD_TOL``; bitwise from
    run to run; the forward's log-sum-exp against the plain one (rows with
    no valid key exactly -1e30).  A case's ``pad`` makes q, k and v views
    of rows that many elements wider, which TMA refuses.  Returns each
    case's share of the tolerance."""
    import torch

    from repro_torch.kernels.flash_attention import kernel, ops, ref

    gen = torch.Generator(device=device).manual_seed(13)
    shares = {}
    for (b, sq, skv, hq, hkv, d), scale, dtypes, case_kw in B6_BWD_CASES:
        kw = {k_: w for k_, w in case_kw.items() if k_ != "pad"}
        wide_d = d + case_kw.get("pad", 0)
        q0 = torch.randn((b, sq, hq, wide_d), generator=gen, device=device) * scale
        k0 = torch.randn((b, skv, hkv, wide_d), generator=gen, device=device) * scale
        v0 = torch.randn((b, skv, hkv, wide_d), generator=gen, device=device)
        do0 = torch.randn((b, sq, hq, d), generator=gen, device=device)
        for name in dtypes:
            dtype = getattr(torch, name)
            q, k, v = (t.to(dtype)[..., :d] for t in (q0, k0, v0))
            do = do0.to(dtype)
            what = f"B6 backward {(b, sq, skv, hq, hkv, d)} {name} qk x{scale} {case_kw}"
            forward = kernel.variant(q, k, v)
            check(forward == ("simt" if dtype == torch.float32 else
                              "mma" if wide_d != d or d % 8 else "sm90"),
                  f"{what}: the forward kernel is {forward}")
            runs = []
            for _ in range(2):
                ts = [t.to(dtype).clone()[..., :d].requires_grad_(True) for t in (q0, k0, v0)]
                check(kernel.variant(*ts) == forward, f"{what}: the copies take {forward}")
                ops.reset_launches()
                runs.append(list(torch.autograd.grad(ops.flash_attention(*ts, **kw), ts, do)))
                which = kernel.bwd_variant(q, forward)
                check(which == {"sm90": "bwd_sm90", "mma": "bwd_mma",
                                "simt": "bwd_simt"}[forward],
                      f"{what}: the backward after {forward} is {which}")
                check(ops.launches[ops.FLASH_ATTENTION_BWD] == ops.launches[
                    ops.BWD_COUNTERS[which]] == 1 and ops.launches[ops.COUNTERS[forward]] == 1,
                      f"{what}: one launch of {forward} and one of {which}")
                del ts
            check(all(a.dtype == dtype and a.equal(b_) for a, b_ in zip(*runs)),
                  f"{what}: bitwise run to run")
            wide = torch.float64 if dtype == torch.float32 else torch.float32
            qw, kw_, vw = (t.to(wide) for t in (q, k, v))
            o, lse = ref.flash_attention_ref(qw, kw_, vw, return_lse=True, **kw)
            want = ref.flash_attention_bwd_ref(qw, kw_, vw, o, lse, do.to(wide), **kw)
            del qw, kw_, vw, o
            share = 0.0
            for g, w, part in zip(runs[0], want, ("dq", "dk", "dv")):
                ok, sh = grads_within(g, w, B6_GRAD_TOL[name])
                check(ok, f"{what}: {part} within {B6_GRAD_TOL[name]} (share {sh:.3g})")
                share = max(share, sh)
            # the forward's log-sum-exp, as the backward reads it
            got_lse = torch.empty(lse.shape, dtype=torch.float32, device=device)
            kernel.launch_flash_attention(q, k, v, torch.empty(q.shape, dtype=dtype,
                                                               device=device), variant=forward,
                                          lse=got_lse, **{**dict(window=None, cap=None,
                                                                 q_offset=0), **kw})
            none = lse <= ref.NEG_INF / 2
            check(bool((got_lse[none] == ref.NEG_INF).all()), f"{what}: lse -1e30 where no key")
            lse_err, lse_max = 0.0, 0.0
            if bool((~none).any()):
                lse_err = float((got_lse[~none].double() - lse[~none].double()).abs().max())
                lse_max = float(lse[~none].abs().max())
            check(lse_err <= 1e-4 * (1 + lse_max), f"{what}: lse within 1e-4 (err {lse_err})")
            shares[what] = {"kernel": share, "lse_max_abs_err": lse_err}
            del runs, want, lse, got_lse
    ops.reset_launches()
    return shares


def sums_close(got, want, scale) -> bool:
    """Two sums of the same terms in another order agree within
    ``SUM_RTOL`` of Σ|terms| (``scale``), the size a reordering error is
    bounded by (and 1e-6 absolute for rows of a few tiny terms)."""
    return bool(((got - want).abs() <= SUM_RTOL * scale + 1e-6).all())


def seg_mm_checks(device) -> None:
    """B5 against its plain version on the card over ragged shapes: every
    D the path runs and wider (D % 4 == 0 takes 16-byte loads), hub rows
    (degree 10,000 and more), empty rows, unsorted dst, weighted and not;
    and bitwise run to run; src ids N, N + 5 and -N - 2, which read the
    rows the reference's gather reads; x whose base is not 16-byte aligned
    (a view 4 bytes into a larger tensor), and a row view ``big[1:]``."""
    import torch

    from repro_torch.kernels.seg_mm import ops, ref

    gen = torch.Generator(device="cpu").manual_seed(2)
    for d in (1, 4, 7, 8, 16, 64, 128, 300):
        for n, e in ((1, 3), (37, 91), (5000, 40_000), (20_000, 60_000)):
            src = torch.randint(0, n, (e,), dtype=torch.int32, generator=gen)
            dst = torch.randint(0, n, (e,), dtype=torch.int32, generator=gen)
            if n >= 5000:
                dst[: e // 4] = 3  # a hub row of degree >= 10,000
                dst[dst % 7 == 5] = 6  # rows 5, 12, 19, ... stay empty
            x = torch.randn((n, d), generator=gen)
            w = torch.rand(e, generator=gen)
            x, src, dst, w = (t.to(device) for t in (x, src, dst, w))
            for ew in (None, w):
                got = ops.seg_mm(x, src, dst, n, edge_weight=ew)
                want = ref.seg_mm_ref(x, src, dst, n, edge_weight=ew)
                scale = ref.seg_mm_ref(x.abs(), src, dst, n,
                                       edge_weight=None if ew is None else ew.abs())
                what = f"B5 D={d} n={n} E={e} weighted={ew is not None}"
                check(sums_close(got, want, scale), what)
                check(got.equal(ops.seg_mm(x, src, dst, n, edge_weight=ew)), what + " run to run")
    # src ids outside [0, N): the reference's gather wraps [-N, -1] and clamps the rest
    n, e = 5000, 40_000
    for bad in (n, n + 5, -n - 2):
        src = torch.randint(0, n, (e,), dtype=torch.int32, generator=gen)
        src[::97] = bad
        dst = torch.randint(0, n, (e,), dtype=torch.int32, generator=gen)
        x = torch.randn((n, 16), generator=gen)
        x, src, dst = (t.to(device) for t in (x, src, dst))
        got = ops.seg_mm(x, src, dst, n)
        want = ref.seg_mm_ref(x, src, dst, n)
        check(sums_close(got, want, ref.seg_mm_ref(x.abs(), src, dst, n)), f"B5 src id {bad}")
    # x at a base that is not 16-byte aligned, and a row view of a larger x
    for d in (4, 7, 8, 16, 64):
        big = torch.randn(((n + 1) * d + 1,), generator=gen).to(device)
        src = torch.randint(0, n, (e,), dtype=torch.int32, generator=gen).to(device)
        dst = torch.randint(0, n, (e,), dtype=torch.int32, generator=gen).to(device)
        w = torch.rand(e, generator=gen).to(device)
        views = {"4 bytes in": big[1:1 + n * d].view(n, d),
                 "big[1:]": big[:(n + 1) * d].view(n + 1, d)[1:]}
        for where, x in views.items():
            check(x.is_contiguous(), f"B5 view {where} is contiguous")
            for ew in (None, w):
                got = ops.seg_mm(x, src, dst, n, edge_weight=ew)
                want = ref.seg_mm_ref(x, src, dst, n, edge_weight=ew)
                scale = ref.seg_mm_ref(x.abs(), src, dst, n,
                                       edge_weight=None if ew is None else ew.abs())
                what = f"B5 D={d} x {where} weighted={ew is not None}"
                check(sums_close(got, want, scale), what)
                check(got.equal(ops.seg_mm(x, src, dst, n, edge_weight=ew)), what + " run to run")


def answer(pg, reqs, sync):
    """Answer ``reqs`` on ``pg``, ``sync()`` ending each request; returns
    per-request latencies (ms), the results and the window's seconds."""
    lat, results = [], []
    sync()
    t_all = time.perf_counter()
    for _, text in reqs:
        t0 = time.perf_counter()
        res = pg.match(text)
        sync()
        lat.append((time.perf_counter() - t0) * 1e3)
        results.append(res)
    total = time.perf_counter() - t_all
    return lat, results, total


# ------------------------------------------------------------ other stores
def store_bytes(store) -> int:
    """Bytes of a sealed store's tensors on the card."""
    import torch

    built = store.finalize()
    return sum(v.numel() * v.element_size() for v in vars(built).values() if torch.is_tensor(v))


def stores_phase(pg, reqs, results, seed: int, device: str, sync) -> dict:
    """Phase 3a (module docstring): ``results`` are phase 3's answers to
    ``reqs``, already held to the CPU port."""
    import torch

    from repro_torch.core.io import load_propgraph, save_propgraph
    from repro_torch.kernels.neighbor_sample import ops as ns_ops

    t_phase = time.perf_counter()
    kinds = reqs[:6]
    out = {}
    tmp = tempfile.mkdtemp(prefix="chip_smoke_graph.")
    path = os.path.join(tmp, "graph3")
    t0 = time.perf_counter()
    save_propgraph(path, pg)
    out["save_s"] = time.perf_counter() - t0
    out["saved_mb"] = sum(f.stat().st_size for f in Path(path).iterdir()) / 1e6
    graphs = {}
    for backend in ("list", "listd", "arr"):
        sync()
        t0 = time.perf_counter()
        g = load_propgraph(path, backend=backend, device=device)
        sync()
        t1 = time.perf_counter()
        g._vstore.finalize()
        g._estore.finalize()
        sync()
        graphs[backend] = g
        out[backend] = {"load_s": t1 - t0, "seal_s": time.perf_counter() - t1,
                        "store_bytes": {"vertex": store_bytes(g._vstore),
                                        "edge": store_bytes(g._estore)}}
    # the round trip: the reloaded arr graph answers as the saved one did
    for (kind, text), want in zip(kinds, results):
        check(same_result(graphs["arr"].match(text), want), f"3a: reloaded arr {kind} equals phase 3")
    for backend in ("list", "listd"):
        g = graphs[backend]
        for _, text in kinds:  # warm
            g.match(text)
        lat, res, total = answer(g, reqs, sync)
        out[backend].update(p50_ms=statistics.median(lat), p95_ms=float(np.percentile(lat, 95)),
                            qps=len(reqs) / total)
        for (kind, _), got, want in zip(kinds, res, results):
            check(same_result(got, want), f"3a: {backend} {kind} equals arr")
    listd = graphs["listd"]
    out["listd"]["planned"] = [p.split("impl=")[1].split(" ")[0]
                               for p in listd.explain(kinds[0][1]).splitlines() if "impl=" in p]
    check(out["listd"]["planned"] and set(out["listd"]["planned"]) == {"budget"},
          "3a: the planner picks listd's budget gather for selective masks")
    for impl in ("inverted", "budget"):
        for (kind, text), want in zip(kinds, results):
            check(same_result(listd.match(text, impl=impl), want),
                  f"3a: listd {kind} under impl={impl} equals arr")
    # one label's mask on each store and impl; the linked walk once (the
    # paper's baseline: one node per step along a chain of ~2% of n)
    out["l0_mask_ms"] = {}
    for backend, impl in (("arr", None), ("list", None), ("listd", "inverted"),
                          ("listd", "budget")):
        g = graphs[backend]
        run_once = lambda: g.query_labels(["l0"], impl=impl)  # noqa: E731
        out["l0_mask_ms"][f"{backend}:{impl or 'default'}"] = (
            time_ms(run_once, reps=20) if device == "cuda" else None)
    inverted = listd.query_labels(["l0"], impl="inverted")
    sync()
    t0 = time.perf_counter()
    linked = listd.query_labels(["l0"], impl="linked")
    sync()
    out["linked_walk_s"] = time.perf_counter() - t0
    out["linked_walk_steps"] = int(listd._vstore.attr_counts()[listd._vstore.known_ids(["l0"])][0])
    check(linked.equal(inverted), "3a: the linked walk equals the inverted answer")
    check(linked.equal(graphs["arr"].query_labels(["l0"])), "3a: the linked walk equals arr")
    # sampling on the listd graph: seeds from its match, windows on B3
    ns_ops.reset_launches()
    blocks = listd.sample("(a:l0)", FANOUTS, key=seed)
    sync()
    out["b3_launches"] = ns_ops.launches[ns_ops.WINDOW_SELECT]
    if device == "cuda":
        check(out["b3_launches"] > 0, "3a: the listd graph's sample launched B3")
    check(same_blocks(blocks, pg.sample("(a:l0)", FANOUTS, key=seed)),
          "3a: the listd graph's blocks equal the arr graph's at the same key")
    del graphs, listd, blocks, linked, inverted, g
    out["path"] = path  # kept for phase 3i, which removes it
    if device == "cuda":
        torch.cuda.empty_cache()
    out["phase_s"] = time.perf_counter() - t_phase
    return out


# ------------------------------------------------------- phase 3i: the mesh
MESH_SHARDS = 8  # P on one card: the reference CI's 8 forced host devices
MESH_SERVICE_REQUESTS = 5


@contextlib.contextmanager
def counting_sharded_queries():
    """Counts the sharded arr queries made inside the block: ``packed``
    (each launches B1 once per shard on the card), ``byte`` (B2 once per
    shard: the kernel and scan impls) and ``byte_matvec`` (a matmul per
    shard: the planner's impl for an unfused mask of a byte store with
    many rows)."""
    from repro_torch.core import dip_shard

    calls = {"packed": 0, "byte": 0, "byte_matvec": 0}
    words, byte = dip_shard._arr_words_parts, dip_shard._arr_byte_parts

    def counted_words(ss, masks):
        calls["packed"] += 1
        return words(ss, masks)

    def counted_byte(ss, masks, impl):
        calls["byte" if impl in ("scan", "kernel") else "byte_matvec"] += 1
        return byte(ss, masks, impl)

    dip_shard._arr_words_parts, dip_shard._arr_byte_parts = counted_words, counted_byte
    try:
        yield calls
    finally:
        dip_shard._arr_words_parts, dip_shard._arr_byte_parts = words, byte


def single_device_answers(pg, seeds, seed: int) -> dict:
    """What ``mesh_analytics`` holds the mesh graph to: the single-device
    graph's answers, taken before the mesh's launches are counted."""
    out = {name: pg.khop(seeds, ANALYTICS_K, pattern=pattern)
           for name, pattern in (("khop", None), ("khop_filtered", ANALYTICS_EDGE_FILTER))}
    out["shortest_paths"] = pg.shortest_paths(seeds, weight="w")
    out["pagerank"] = pg.pagerank(weight="w")
    out["components"], out["communities"] = pg.components(), pg.communities()
    out["sample"] = pg.sample("(a:l0)", FANOUTS, key=seed)
    return out


def mesh_analytics(g, want: dict, seeds, seed: int, sync) -> dict:
    """Phase 3i's analytics on the mesh graph ``g``, each timed warm (its
    second run) and held to the single-device graph's answers ``want``."""
    out = {}

    def warm(name, fn):
        fn()
        sync()
        t0 = time.perf_counter()
        got = fn()
        sync()
        out[f"{name}_ms"] = (time.perf_counter() - t0) * 1e3
        return got

    for name, pattern in (("khop", None), ("khop_filtered", ANALYTICS_EDGE_FILTER)):
        got = warm(name, lambda: g.khop(seeds, ANALYTICS_K, pattern=pattern))
        check(got.equal(want[name]), f"3i: {name} equals the single-device graph's")
    got = warm("shortest_paths", lambda: g.shortest_paths(seeds, weight="w"))
    check(got.equal(want["shortest_paths"]),
          "3i: directed shortest paths over w equal the single-device graph's")
    got = warm("pagerank", lambda: g.pagerank(weight="w"))
    out["pagerank_l1"] = float((got.double() - want["pagerank"].double()).abs().sum())
    check(out["pagerank_l1"] <= PR_L1_TOL, f"3i: PageRank L1 {out['pagerank_l1']} <= {PR_L1_TOL}")
    for name in ("components", "communities"):
        got = warm(name, getattr(g, name))
        check(got.equal(want[name]), f"3i: {name} equal the single-device graph's")
    blocks = warm("sample", lambda: g.sample("(a:l0)", FANOUTS, key=seed))
    check(same_blocks(blocks, want["sample"]),
          "3i: the sample of (a:l0) equals the single-device graph's")
    return out


def mesh_phase(pg, reqs, results, path, seed: int, device: str, sync) -> dict:
    """Phase 3i (module docstring): graph3 saved by phase 3a reopened on
    entity meshes; ``results`` are phase 3's answers to ``reqs``."""
    import torch

    from repro_torch.core import bitplane, dip_shard
    from repro_torch.core.io import load_propgraph
    from repro_torch.kernels.bitmap_query import ops
    from repro_torch.launch.mesh import make_entity_mesh
    from repro_torch.service import GraphRegistry, Service

    t_phase = time.perf_counter()
    lead = (torch.device("cuda", torch.cuda.current_device()) if device == "cuda"
            else torch.device(device))
    meshes = {"one_card": make_entity_mesh(devices=[lead] * MESH_SHARDS)}
    if device == "cuda" and torch.cuda.device_count() > 1:
        meshes["all_cards"] = make_entity_mesh()
    seeds = np.random.default_rng(seed + 11).choice(  # phase 3f's seeds
        pg.graph.node_map.cpu().numpy(), ANALYTICS_SEEDS, replace=False)
    want = single_device_answers(pg, seeds, seed)
    out = {"launches": {ops.PACKED: 0, ops.BYTE: 0}}
    texts = [t for _, t in reqs]

    def count(res, calls, mesh, what):
        res["b1_launches"], res["b2_launches"] = ops.launches[ops.PACKED], ops.launches[ops.BYTE]
        res["sharded_queries"] = dict(calls)
        out["launches"][ops.PACKED] += res["b1_launches"]
        out["launches"][ops.BYTE] += res["b2_launches"]
        if device == "cuda":
            for kind, kernel in (("packed", ops.PACKED), ("byte", ops.BYTE)):
                check(ops.launches[kernel] >= mesh.size * calls[kind],
                      f"3i {what}: {kernel} launched once per shard of each {kind} query")

    for label, mesh in meshes.items():
        res_mesh = out[label] = {"P": mesh.size, "devices": [str(d) for d in mesh.devices]}
        print("phase 3i mesh", json.dumps({"mesh": label, **res_mesh}), flush=True)
        for backend in ("arr", "list", "listd") if label == "one_card" else ("arr",):
            what = f"{label} {backend}"
            ops.reset_launches()
            with counting_sharded_queries() as calls:
                sync()
                t0 = time.perf_counter()
                if backend == "arr":  # through the service's registry
                    reg = GraphRegistry()
                    g = reg.load("graph3", path, backend=backend, mesh=mesh)
                else:
                    g = load_propgraph(path, backend=backend, mesh=mesh)
                sync()
                t1 = time.perf_counter()
                g._vstore.finalize()
                g._estore.finalize()
                sync()
                res = res_mesh[backend] = {"load_s": t1 - t0, "seal_s": time.perf_counter() - t1}
                res["shard_bytes"] = {k: list(dip_shard.store_bytes(s._sharded))
                                      for k, s in (("vertex", g._vstore), ("edge", g._estore))}
                check(all(s._store is None and s._host is None and s._sharded is not None
                          for s in (g._vstore, g._estore)), f"3i {what}: no dense store kept")
                for text in texts[:6]:  # warm
                    g.match(text)
                lat, got, total = answer(g, reqs, sync)
                res.update(p50_ms=statistics.median(lat), p95_ms=float(np.percentile(lat, 95)),
                           qps=len(reqs) / total)
                check(all(same_result(a, b) for a, b in zip(got, results)),
                      f"3i {what}: the {len(reqs)} requests equal phase 3's bit for bit")
                del got
                if backend == "arr":
                    res["analytics"] = mesh_analytics(g, want, seeds, seed, sync)
                    with Service(reg) as svc:
                        sync()
                        t0 = time.perf_counter()
                        served = svc.query_batch("graph3", texts[:MESH_SERVICE_REQUESTS])
                        sync()
                        res["service_ms"] = (time.perf_counter() - t0) * 1e3
                    check(all(same_result(a, b) for a, b in zip(served, results)),
                          f"3i {what}: {MESH_SERVICE_REQUESTS} service requests equal phase 3's")
                    del served, reg
            count(res, calls, mesh, what)
            if device == "cuda" and backend == "arr":
                check(calls["packed"] > 0, f"3i {what}: the queries ran sharded on B1")
            del g
            if device == "cuda":
                torch.cuda.empty_cache()
        if label != "one_card":
            continue
        # one request on the byte layout: B2 once per shard
        with bitplane.byte_masks():
            g = load_propgraph(path, backend="arr", mesh=mesh)
            g._vstore.finalize()
            g._estore.finalize()
        check(not g._vstore.packed, "3i: byte_masks() sealed byte shards")
        g.match(texts[0])  # warm
        ops.reset_launches()
        with counting_sharded_queries() as calls:
            got = g.match(texts[0])
            sync()
        check(same_result(got, results[0]), "3i: the byte layout's request equals phase 3's")
        res = res_mesh["byte"] = {}
        count(res, calls, mesh, f"{label} byte")
        if device == "cuda":
            check(calls["byte"] > 0, "3i: the byte request ran sharded on B2")
        del g, got
        if device == "cuda":
            torch.cuda.empty_cache()
    del want
    shutil.rmtree(os.path.dirname(path))
    out["phase_s"] = time.perf_counter() - t_phase
    return out


# ------------------------------------------------------------- analytics
def analytics_call(pg, method: str, pattern, settings: dict, seeds, **over):
    """One phase 3f request on ``pg`` (``over`` overrides its settings)."""
    kw = {**settings, **over}
    if method == "khop":
        return pg.khop(seeds, kw.pop("k"), pattern=pattern, **kw)
    if method == "shortest_paths":
        return pg.shortest_paths(seeds, pattern=pattern, **kw)
    return getattr(pg, method)(pattern=pattern, **kw)


def fixed_point_of(step, state):
    """``state = step(state)`` until nothing changes (the certificates' own
    closure, with no cap)."""
    while True:
        new = step(state)
        if new.equal(state):
            return state
        state = new


def check_components_certificate(pg, pattern, labels, what: str) -> None:
    """Labels are the components of the filtered subgraph: they agree across
    every active edge, each label is the least id carrying it (no member
    below it, and its own vertex carries it), and every member is reached
    from its label's vertex over active edges.  With the first, the last
    makes each label class connected, so classes are the components."""
    import torch

    from repro_torch.traverse import frontier_step

    g, v_ok, e_ok, _ = pg._subgraph_filters(pattern)
    v_ok = torch.ones(g.n, dtype=torch.bool, device=g.device) if v_ok is None else v_ok
    e_act = torch.ones(g.m, dtype=torch.bool, device=g.device) if e_ok is None else e_ok
    src, dst = g.src.long(), g.dst.long()
    e_act = e_act & v_ok[src] & v_ok[dst]
    lab = labels.long()
    ids = torch.arange(g.n, device=g.device)
    check(labels.dtype == torch.int32 and labels.shape == (g.n,), f"{what}: (n,) int32 labels")
    check(((lab >= 0) == v_ok).all().item(), f"{what}: -1 exactly outside the filter")
    check((lab[src] == lab[dst])[e_act].all().item(), f"{what}: labels agree across edges")
    inside = lab[v_ok]
    check((inside <= ids[v_ok]).all().item() and (lab[inside] == inside).all().item(),
          f"{what}: each label is the least id carrying it")
    roots = v_ok & (lab == ids)
    reached = fixed_point_of(
        lambda m: m | frontier_step(g, m, e_act, undirected=True), roots)
    check(reached.equal(v_ok), f"{what}: every member is reached from its label's vertex")


def check_distances_certificate(pg, pattern, seeds, dist, undirected: bool, what: str) -> None:
    """Distances are the least fixed point of the f32 relax from the seeds:
    seeds at 0, no allowed edge relaxes any distance, and every finite
    vertex is reached from the seeds over tight allowed edges (an edge whose
    f32 ``dist[tail] + w`` equals ``dist[head]``).  With weights ≥ 0 the
    relax is monotone, so such a vector is unique."""
    import torch

    from repro_torch.traverse import frontier_step

    g, e_ok, direction = pg._step_filter(pattern)
    tail, head = ((g.src, g.dst) if direction == 1 else (g.dst, g.src))
    tail, head = tail.long(), head.long()
    w, e_ok = pg._weighted_edge_filter(e_ok, "w")
    check(bool((w[e_ok] >= 0).all()), f"{what}: the certificate needs weights >= 0")
    ew = torch.where(e_ok, w, float("inf"))
    seed_mask = pg._seed_mask(pg._seed_ids(seeds))
    check(dist.dtype == torch.float32 and dist.shape == (g.n,), f"{what}: (n,) f32 distances")
    check((dist[seed_mask] == 0).all().item(), f"{what}: seeds at 0")
    finite = torch.isfinite(dist)
    tight = {}
    for d, (t, h) in ((direction, (tail, head)), (-direction, (head, tail))):
        if d != direction and not undirected:
            continue
        cand = dist[t] + ew
        check((dist[h] <= cand).all().item(), f"{what}: no allowed edge relaxes a distance")
        tight[d] = e_ok & (cand == dist[h]) & finite[h]
    reached = fixed_point_of(
        lambda m: m | torch.stack([frontier_step(g, m, tm, direction=d)
                                   for d, tm in tight.items()]).any(0), seed_mask)
    check(reached.equal(finite), f"{what}: every finite vertex is reached over tight edges")


def analytics_at(pg, cpu_pg, seeds) -> dict:
    """Every ``ANALYTICS`` request on ``pg``, held to ``cpu_pg`` at the
    full caps (graph1's check): bitwise, PageRank within ``PR_L1_TOL``."""
    out = {}
    for name, method, pattern, settings in ANALYTICS:
        got = analytics_call(pg, method, pattern, settings, seeds)
        want = analytics_call(cpu_pg, method, pattern, settings, seeds)
        check(got.shape == want.shape and got.dtype == want.dtype, f"3f graph1 {name}: shape")
        if method == "pagerank":
            out[name] = float((got.cpu().double() - want.double()).abs().sum())
            check(out[name] <= PR_L1_TOL, f"3f graph1 {name}: L1 {out[name]} <= {PR_L1_TOL}")
        else:
            check(got.cpu().equal(want), f"3f graph1 {name}: card equals the CPU port")
            out[name] = "bitwise"
    return out


def analytics_phase(pg, cpu_pg, seed: int, device: str, sync) -> dict:
    """Phase 3f (module docstring): the frontier and semiring analytics at
    ``pg``'s scale; ``cpu_pg`` is the same graph on the CPU."""
    import torch

    from repro_torch.core import PropGraph
    from repro_torch.graph.generators import PAPER_GRAPHS, random_uniform_graph
    from repro_torch.kernels.bitmap_query import ops
    from repro_torch.traverse import engine

    t_phase = time.perf_counter()
    rng = np.random.default_rng(seed + 11)
    seeds = rng.choice(pg.graph.node_map.cpu().numpy(), ANALYTICS_SEEDS, replace=False)
    out = {"requests": {}}
    answers = {}
    for name, method, pattern, settings in ANALYTICS:
        def run():
            return analytics_call(pg, method, pattern, settings, seeds)

        ops.reset_launches()
        run()  # warm
        sync()
        times = []
        for _ in range(3):
            engine.reset_rounds()
            t0 = time.perf_counter()
            answers[name] = run()
            sync()
            times.append((time.perf_counter() - t0) * 1e3)
        req = {"median_ms": statistics.median(times), "ms": times,
               "rounds": dict(engine.rounds), "capped": dict(engine.capped),
               "b1_launches": ops.launches[ops.PACKED]}
        if device == "cuda":
            if pattern is not None:
                check(req["b1_launches"] > 0, f"3f: {name} launched B1 for its filter")
            events, wall_s = on_card(run)
            device_s = sum(e.self_device_time_total for e in events) / 1e6
            req["busy_share"] = device_s / wall_s if device_s else "not measured"
            req["top_ms"] = [(e.key[:60], e.self_device_time_total / 1e3, e.count)
                             for e in events[:8]]
        out["requests"][name] = req
    out["b1_launches"] = sum(r["b1_launches"] for r in out["requests"].values())
    reqs = {name: (method, pattern, settings) for name, method, pattern, settings in ANALYTICS}

    def cpu_answer(name, **over):
        method, pattern, settings = reqs[name]
        return analytics_call(cpu_pg, method, pattern, settings, seeds, **over)

    # k-hop: every variant bitwise against the CPU port; csr equals the frontier path
    for name in ("khop", "khop_csr", "khop_filtered", "khop_csr_filtered"):
        check(answers[name].dtype == torch.bool and answers[name].shape == (pg.n_vertices,),
              f"3f: {name} is an (n,) bool mask")
        check(answers[name].cpu().equal(cpu_answer(name)), f"3f: {name} equals the CPU port")
    check(answers["khop_csr"].equal(answers["khop"])
          and answers["khop_csr_filtered"].equal(answers["khop_filtered"]),
          "3f: csr k-hop equals the frontier path")
    # components and shortest paths: certificates (none holds where a cap was
    # reached), the first CPU_PROBE_ROUNDS rounds against the CPU port, and the full
    # answer too where the probe projects at most CPU_FULL_S on the host
    for name in ("components", "components_filtered", "shortest_paths",
                 "shortest_paths_filtered"):
        method, pattern, settings = reqs[name]
        req = out["requests"][name]
        req["check"] = []
        if not req["capped"]:
            if method == "components":
                check_components_certificate(pg, pattern, answers[name], f"3f: {name}")
            else:
                check_distances_certificate(pg, pattern, seeds, answers[name],
                                            settings.get("undirected", False), f"3f: {name}")
            req["check"].append("certificate")
        engine.reset_rounds()
        t0 = time.perf_counter()
        want = cpu_answer(name, max_iters=CPU_PROBE_ROUNDS)
        cpu_s = time.perf_counter() - t0
        cpu_rounds = engine.rounds[method]
        check(analytics_call(pg, method, pattern, settings, seeds,
                             max_iters=CPU_PROBE_ROUNDS).cpu().equal(want),
              f"3f: {name} at {CPU_PROBE_ROUNDS} rounds equals the CPU port")
        req["cpu_probe"] = {"rounds": cpu_rounds, "s": cpu_s,
                            "projected_full_s": cpu_s / cpu_rounds * req["rounds"][method]}
        req["check"].append(f"cpu port over {CPU_PROBE_ROUNDS} rounds")
        if req["capped"] or req["cpu_probe"]["projected_full_s"] <= CPU_FULL_S:
            t0 = time.perf_counter()
            check(answers[name].cpu().equal(cpu_answer(name)), f"3f: {name} equals the CPU port")
            req["cpu_probe"]["full_s"] = time.perf_counter() - t0
            req["check"].append("cpu port")
    # PageRank within PR_L1_TOL of the CPU port; unfiltered ranks sum to 1
    for name in ("pagerank", "pagerank_filtered"):
        got = answers[name]
        check(got.dtype == torch.float32 and bool(torch.isfinite(got).all()),
              f"3f: {name} finite f32")
        l1 = float((got.cpu().double() - cpu_answer(name).double()).abs().sum())
        check(l1 <= PR_L1_TOL, f"3f: {name} L1 distance {l1} to the CPU port <= {PR_L1_TOL}")
        out["requests"][name]["check"] = {"l1_to_cpu": l1,
                                          "sum": float(got.double().sum())}
    check(abs(out["requests"]["pagerank"]["check"]["sum"] - 1.0) <= PR_SUM_TOL,
          "3f: unfiltered ranks sum to 1")
    # communities: at COMMUNITIES_CHECK_ROUNDS rounds against the CPU port
    got = analytics_call(pg, "communities", None, {}, seeds, max_iters=COMMUNITIES_CHECK_ROUNDS)
    check(got.cpu().equal(cpu_answer("communities", max_iters=COMMUNITIES_CHECK_ROUNDS)),
          f"3f: communities at {COMMUNITIES_CHECK_ROUNDS} rounds equal the CPU port")
    out["requests"]["communities"]["check"] = f"cpu port at {COMMUNITIES_CHECK_ROUNDS} rounds"
    # graph1: every request at its full cap against the CPU port
    src1, dst1 = random_uniform_graph(PAPER_GRAPHS["graph1"], seed=seed)
    g1, _ = build_graph(src1, dst1, seed, device)
    g1_cpu = PropGraph.from_arrays(g1.to_arrays(), device="cpu")
    seeds1 = np.random.default_rng(seed + 11).choice(g1.graph.node_map.cpu().numpy(),
                                                     ANALYTICS_SEEDS, replace=False)
    out["graph1"] = {"n": g1.n_vertices, "m": g1.n_edges,
                     "check": analytics_at(g1, g1_cpu, seeds1)}
    del g1, g1_cpu
    out["phase_s"] = time.perf_counter() - t_phase
    return out


# ----------------------------------------------------------------- overlay
# phase 3g: 12 write batches in the shape of the reference's benchmarks/bench_ingest.py
# (insert, then relationships on the batch, a read between batches), scaled to graph3
OVERLAY_BATCHES, OVERLAY_BATCH, OVERLAY_SNAPSHOT_AFTER = 12, 8192, 6
OVERLAY_BATCH_GRAPH1 = 128


def overlay_ops(pg, seed: int, batch: int):
    """Phase 3g's write stream on ``pg``'s graph, as ``(method, args)`` steps
    and a ``("snapshot",)`` marker, every draw from ``seed`` and every
    endpoint an existing vertex.  Per batch: ``insert_edges`` of ``batch``
    pairs, 1/32 of them already base edges (the dedup path), relationships
    r0-r50 on all of them (r50 first seen after the seal), labels l0-l50 on
    ``batch``/2 vertices.  Then edge deletes (``batch``/2 base edges and
    ``batch``/16 delta edges), a re-insert of ``batch``/32 deleted pairs (the
    revival), vertex deletes (the 16 of highest out-degree and ``batch``/8
    drawn), and ``age``/``w`` updates on ``batch``/2 entities each (delta
    edges among the edges)."""
    rng = np.random.default_rng(seed + 21)
    g = pg.graph
    nodes = g.node_map.cpu().numpy()
    src, dst = nodes[g.src.cpu().numpy()], nodes[g.dst.cpu().numpy()]
    n_dup, half = batch // 32, batch // 2
    ops, fresh = [], []
    for b in range(OVERLAY_BATCHES):
        dup = rng.choice(g.m, n_dup, replace=False)
        new = (rng.choice(nodes, batch - n_dup), rng.choice(nodes, batch - n_dup))
        fresh.append(new)
        order = rng.permutation(batch)
        s, d = np.concatenate([new[0], src[dup]])[order], np.concatenate([new[1], dst[dup]])[order]
        ops.append(("insert_edges", (s, d)))
        ops.append(("add_edge_relationships",
                    (s, d, np.array([f"r{i}" for i in range(N_ATTRS + 1)])[
                        rng.integers(0, N_ATTRS + 1, batch)])))
        ops.append(("add_node_labels",
                    (rng.choice(nodes, half, replace=False),
                     np.array([f"l{i}" for i in range(N_ATTRS + 1)])[
                         rng.integers(0, N_ATTRS + 1, half)])))
        if b + 1 == OVERLAY_SNAPSHOT_AFTER:
            ops.append(("snapshot",))
    fs = np.concatenate([f[0] for f in fresh])
    fd = np.concatenate([f[1] for f in fresh])
    gone_b = rng.choice(g.m, half, replace=False)
    gone_d = rng.choice(fs.size, batch // 16, replace=False)
    gs, gd = np.concatenate([src[gone_b], fs[gone_d]]), np.concatenate([dst[gone_b], fd[gone_d]])
    ops.append(("delete_edges", (gs, gd)))
    back = rng.choice(gs.size, batch // 32, replace=False)
    ops.append(("insert_edges", (gs[back], gd[back])))
    deg = (g.seg[1:] - g.seg[:-1]).cpu().numpy()
    hubs = nodes[np.argsort(deg, kind="stable")[-16:]]
    ops.append(("delete_vertices", (np.concatenate([hubs, rng.choice(nodes, batch // 8)]),)))
    ops.append(("update_node_properties",
                ("age", rng.choice(nodes, half, replace=False), rng.integers(0, 100, half))))
    eb, ed_ = rng.choice(g.m, half // 2, replace=False), rng.choice(fs.size, half // 2,
                                                                    replace=False)
    ops.append(("update_edge_properties",
                ("w", np.concatenate([src[eb], fs[ed_]]), np.concatenate([dst[eb], fd[ed_]]),
                 rng.random(half))))
    return ops


def external_answer(pg, res):
    """A MatchResult in external ids: its vertices' ids and its edges'
    (src, dst) id pairs, each sorted — comparable across a compaction,
    which renumbers both."""
    g = pg._require_graph()
    nm = g.node_map.cpu().numpy().astype(np.int64)
    em = res.edge_mask.cpu().numpy()
    pairs = (nm[g.src.cpu().numpy()[em]] << 32) | nm[g.dst.cpu().numpy()[em]]
    return np.sort(nm[res.vertex_mask.cpu().numpy()]), np.sort(pairs)


def same_external(a, b) -> bool:
    return all(np.array_equal(x, y) for x, y in zip(a, b))


def from_scratch(pg, device):
    """A fresh ingest of ``pg``'s surviving state in external ids — the
    alive edges, every surviving attribute pair in history order, every
    column's valid rows — built without the compactor."""
    from repro_torch.core import PropGraph

    g = pg._require_graph()
    nm, s_all, d_all = (t.cpu().numpy() for t in (g.node_map, g.src, g.dst))
    ae = pg._alive_edge_mask()
    alive_e = np.ones(g.m, bool) if ae is None else ae.cpu().numpy()
    alive_v = np.ones(g.n, bool) if pg._dead_v is None else ~pg._dead_v
    fresh = PropGraph(backend=pg.backend, device=device).add_edges_from(
        nm[s_all[alive_e]], nm[d_all[alive_e]])
    ve, va = pg._vstore.all_pairs()
    ok = alive_v[ve]
    fresh.add_node_labels(nm[ve[ok]], np.array(pg._vstore.amap.values)[va[ok]])
    ee, ea = pg._estore.all_pairs()
    ok = alive_e[ee]
    fresh.add_edge_relationships(nm[s_all[ee[ok]]], nm[d_all[ee[ok]]],
                                 np.array(pg._estore.amap.values)[ea[ok]])
    for name, (col, valid) in pg.host_columns("node").items():
        keep = valid & alive_v
        fresh.add_node_properties(name, nm[keep], col[keep])
    for name, (col, valid) in pg.host_columns("edge").items():
        keep = np.zeros(g.m, bool)
        keep[:len(valid)] = valid
        keep &= alive_e
        fresh.add_edge_properties(name, nm[s_all[keep]], nm[d_all[keep]], col[keep[:len(col)]])
    return fresh


def same_arrays(a: dict, b: dict, *, by_value: bool = False) -> bool:
    """Two ``to_arrays`` states equal bit for bit: the DI fields, the
    columns and each store's plane — row by row in attribute-id order, or,
    ``by_value``, row by row of each attribute value (a value with no row is
    an all-zero row), for builds that interned the values in another
    order."""
    if any(not np.array_equal(a["graph"][k], b["graph"][k])
           for k in ("src", "dst", "seg", "node_map", "n", "m", "max_deg")):
        return False
    for props in ("vertex_props", "edge_props"):
        if set(a[props]) != set(b[props]) or any(
                x.dtype != y.dtype or not np.array_equal(x, y)
                for name in a[props] for x, y in zip(a[props][name], b[props][name])):
            return False
    for s in ("vstore", "estore"):
        x, y = a[s], b[s]
        if not by_value:
            if x["values"] != y["values"] or not np.array_equal(x["bitmap"], y["bitmap"]):
                return False
            continue
        rows_x = dict(zip(x["values"], x["bitmap"]))
        rows_y = dict(zip(y["values"], y["bitmap"]))
        zero = np.zeros_like(x["bitmap"][0])
        if any(not np.array_equal(rows_x.get(v, zero), rows_y.get(v, zero))
               for v in set(rows_x) | set(rows_y)):
            return False
    return True


def apply_ops(pg, ops, sync, on_batch=None, on_snapshot=None) -> dict:
    """Run ``ops`` on ``pg``; ``on_batch(i, seconds)`` after each batch's
    three writes (timed, ``sync()`` ending them) and ``on_snapshot()`` at the
    marker.  Returns each method's seconds per call, in call order."""
    t0, writes, per_step = time.perf_counter(), 0, {}
    for step in ops:
        if step[0] == "snapshot":
            if on_snapshot is not None:
                on_snapshot()
            t0 = time.perf_counter()
            continue
        t_step = time.perf_counter()
        getattr(pg, step[0])(*step[1])
        sync()
        per_step.setdefault(step[0], []).append(time.perf_counter() - t_step)
        if step[0] == "add_node_labels":
            sync()
            if on_batch is not None:
                on_batch(writes, time.perf_counter() - t0)
            writes += 1
            t0 = time.perf_counter()
    sync()
    return per_step


def overlay_phase(pg, cpu_pg, results, seed: int, device: str, sync) -> dict:
    """Phase 3g (module docstring): the overlay at ``pg``'s scale on a fork
    of it, the same stream on a fork of the CPU twin ``cpu_pg``; ``results``
    are phase 3's answers on ``pg``."""
    import torch

    from repro_torch.core import PropGraph
    from repro_torch.graph.generators import PAPER_GRAPHS, random_uniform_graph
    from repro_torch.kernels.bitmap_query import ops
    from repro_torch.kernels.neighbor_sample import ops as ns_ops

    t_phase = time.perf_counter()
    out = {}
    ops.reset_launches()
    ns_ops.reset_launches()
    t0 = time.perf_counter()
    ov = pg.fork()
    out["fork_ms"] = (time.perf_counter() - t0) * 1e3
    cpu_ov = cpu_pg.fork()
    stream = overlay_ops(pg, seed, OVERLAY_BATCH)
    kinds = requests(6)
    write_s, read_ms, snap = [], [], {}

    def on_batch(i, seconds):
        write_s.append(seconds)
        t = time.perf_counter()
        ov.match(kinds[i % 6][1])
        sync()
        read_ms.append((time.perf_counter() - t) * 1e3)

    def on_snapshot():
        t = time.perf_counter()
        snap["pg"] = ov.snapshot()
        snap["ms"] = (time.perf_counter() - t) * 1e3
        snap["answers"] = [snap["pg"].match(text) for _, text in kinds]

    t0 = time.perf_counter()
    per_step = apply_ops(ov, stream, sync, on_batch, on_snapshot)
    out["stream_s"] = time.perf_counter() - t0
    out["write_ms_by_step"] = {k: statistics.median(v[-4:]) * 1e3 for k, v in per_step.items()}
    t0 = time.perf_counter()
    apply_ops(cpu_ov, stream, lambda: None)
    out["cpu_stream_s"] = time.perf_counter() - t0
    out["write_ms_per_batch"] = statistics.median(write_s[-4:]) * 1e3
    out["write_ms_batches"] = [s * 1e3 for s in write_s]
    out["read_under_writes_p50_ms"] = statistics.median(read_ms)
    out["snapshot_ms"] = snap["ms"]
    out["delta_stats"] = ov.delta_stats()
    out["n"], out["m_eff"] = ov.n_vertices, ov.n_edges
    check(ov.delta_stats() == cpu_ov.delta_stats(), "3g: the CPU fork took the same stream")
    check(not pg.has_overlay() and pg.n_edges == results[0].edge_mask.shape[0],
          "3g: the parent has no overlay")

    # the 32 requests on the overlay, each kind held to the CPU fork
    reqs = requests(32)
    lat, ov_results, total = answer(ov, reqs, sync)
    out["p50_ms"], out["p95_ms"] = statistics.median(lat), float(np.percentile(lat, 95))
    out["qps"] = len(reqs) / total
    for (kind, text), res in zip(reqs[:6], ov_results[:6]):
        check(res.vertex_mask.shape == (ov.n_vertices,) and res.edge_mask.shape == (ov.n_edges,),
              f"3g {kind}: result shapes")
        check(same_result(res, cpu_ov.match(text)), f"3g {kind}: card equals the CPU fork")
    check(all(r.n_vertices() > 0 for r in ov_results[:6]), "3g: every request kind matched")

    # analytics on the overlay
    seeds = np.random.default_rng(seed + 11).choice(pg.graph.node_map.cpu().numpy(),
                                                    ANALYTICS_SEEDS, replace=False)
    timed = {}

    def run_timed(name, fn):
        fn()
        sync()
        t = time.perf_counter()
        got = fn()
        sync()
        timed[name] = (time.perf_counter() - t) * 1e3
        return got

    khop = run_timed("khop_ms", lambda: ov.khop(seeds, ANALYTICS_K))
    check(run_timed("khop_csr_ms", lambda: ov.khop(seeds, ANALYTICS_K, impl="csr")).equal(khop),
          "3g: csr k-hop degrades to the frontier step and equals it")
    check(khop.cpu().equal(cpu_ov.khop(seeds, ANALYTICS_K)), "3g: k-hop equals the CPU fork")
    comps = run_timed("components_ms", lambda: ov.components())
    check_components_certificate(ov, None, comps, "3g: components")
    check(ov.components(max_iters=CPU_PROBE_ROUNDS).cpu().equal(
        cpu_ov.components(max_iters=CPU_PROBE_ROUNDS)),
          f"3g: components at {CPU_PROBE_ROUNDS} rounds equal the CPU fork")
    ranks = run_timed("pagerank_ms", lambda: ov.pagerank(weight="w"))
    out["pagerank_l1"] = float((ranks.cpu().double() - cpu_ov.pagerank(weight="w").double())
                               .abs().sum())
    check(out["pagerank_l1"] <= PR_L1_TOL, f"3g: PageRank L1 {out['pagerank_l1']} <= {PR_L1_TOL}")
    out.update(timed)

    # sampling over the re-sorted view, held to the CPU fork on the card's priorities
    sync()
    t0 = time.perf_counter()
    vseg, vdst, _, perm = ov._sampling_view()
    sync()
    out["sampling_view_ms"] = (time.perf_counter() - t0) * 1e3
    check(perm is not None and vseg.shape == (ov.n_vertices + 1,), "3g: a re-sorted view")
    sample_ms = []
    for _ in range(4):
        t0 = time.perf_counter()
        ov.sample("(a:l0)", FANOUTS, seed=seed)
        sync()
        sample_ms.append((time.perf_counter() - t0) * 1e3)
    out["sample_ms"] = statistics.median(sample_ms[1:])
    with recording() as rec:
        blocks = ov.sample("(a:l0)", FANOUTS, seed=seed)
    sync()
    out["sample_rows_checked"] = check_layers(rec["layers"], vseg.cpu().numpy(),
                                              vdst.cpu().numpy(), ov.n_edges, seed)
    with replaying(rec["draws"]):
        cpu_blocks = cpu_ov.sample("(a:l0)", FANOUTS, seed=seed)
    check(same_blocks(blocks, cpu_blocks), "3g: sampled blocks equal the CPU fork's")
    del rec, blocks, cpu_blocks
    out["b1_launches"] = ops.launches[ops.PACKED]
    out["b3_launches"] = ns_ops.launches[ns_ops.WINDOW_SELECT]
    if device == "cuda":
        check(out["b1_launches"] > 0, "3g: the overlay path launched B1")
        check(out["b3_launches"] > 0, "3g: sampling over the overlay view launched B3")

    # compaction: the same answers in external ids, the snapshot and the parent untouched
    before = [external_answer(ov, r) for r in ov_results[:6]]
    sync()
    t0 = time.perf_counter()
    ov.compact()
    sync()
    out["compact_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    after = [ov.match(text) for _, text in kinds]
    sync()
    out["first_requests_after_compact_s"] = time.perf_counter() - t0
    check(not ov.has_overlay() and ov.n_edges == out["m_eff"] - np.count_nonzero(
        ~cpu_ov._alive_edge_mask().numpy()) and ov.n_vertices <= out["n"],
          "3g: compaction folded the overlay in")
    for (kind, _), a, b in zip(kinds, after, before):
        check(same_external(external_answer(ov, a), b), f"3g {kind}: compaction kept the answer")
    for (kind, text), want in zip(kinds, snap["answers"]):
        check(same_result(snap["pg"].match(text), want), f"3g {kind}: the snapshot still answers")
    for (kind, text), want in zip(kinds, results[:6]):
        check(same_result(pg.match(text), want), f"3g {kind}: the parent equals phase 3")
    del ov, cpu_ov, snap

    # graph1: the same stream at batches of OVERLAY_BATCH_GRAPH1, compaction held to a
    # from-scratch build of the surviving state and to the CPU port's compaction
    src1, dst1 = random_uniform_graph(PAPER_GRAPHS["graph1"], seed=seed)
    g1, _ = build_graph(src1, dst1, seed, device)
    g1_cpu = PropGraph.from_arrays(g1.to_arrays(), device="cpu")
    stream1 = overlay_ops(g1, seed, OVERLAY_BATCH_GRAPH1)
    for g in (g1, g1_cpu):
        apply_ops(g, stream1, sync)
    scratch = from_scratch(g1, device)
    g1.compact()
    g1_cpu.compact()
    a1 = g1.to_arrays()
    check(same_arrays(a1, g1_cpu.to_arrays()), "3g graph1: compaction equals the CPU port's")
    check(same_arrays(a1, scratch.to_arrays(), by_value=True),
          "3g graph1: compaction equals a from-scratch build of the surviving state")
    out["graph1"] = {"n": g1.n_vertices, "m": g1.n_edges, "check": "bitwise"}
    del g1, g1_cpu, scratch
    out["phase_s"] = time.perf_counter() - t_phase
    return out


# ------------------------------------------------------- phase 3h: the service
SERVICE_CLIENTS = 8  # closed-loop client threads
SERVICE_REQUESTS = 256  # zipf 1.1 over phase 3's texts (pgserve.synthetic_workload)
SERVICE_SAMPLES = 9  # coalesced sample requests of 1,024 ids; the last under GNN_FILTER
SERVICE_CLI_TIMEOUT = 300  # seconds for each pgserve gate run as a subprocess


@contextlib.contextmanager
def counting_launches():
    """B1 and B3 launches inside the block (``launches`` on exit), and the Q
    of every B1 call and the seed shape of every B3 call, from the
    wrappers."""
    from repro_torch.kernels.bitmap_query import ops
    from repro_torch.kernels.neighbor_sample import ops as ns_ops

    rec = {"b1_q": [], "b3_rows": [], "launches": None}
    saved = ops.bitmap_query_batched_packed, ns_ops.window_select

    def b1(plane, attr_masks):
        rec["b1_q"].append(int(attr_masks.shape[0]))
        return saved[0](plane, attr_masks)

    def b3(start, deg, dst, ew_words, pri, *, fanout):
        rec["b3_rows"].append(tuple(start.shape))
        return saved[1](start, deg, dst, ew_words, pri, fanout=fanout)

    ops.reset_launches()
    ns_ops.reset_launches()
    ops.bitmap_query_batched_packed, ns_ops.window_select = b1, b3
    try:
        yield rec
    finally:
        ops.bitmap_query_batched_packed, ns_ops.window_select = saved
        rec["launches"] = {"b1": ops.launches[ops.PACKED],
                           "b3": ns_ops.launches[ns_ops.WINDOW_SELECT]}


def same_result_on(a, b) -> bool:
    """``same_result`` without leaving the card: masks and bindings of two
    MatchResults on one device equal bit for bit."""
    import torch

    if not (torch.equal(a.vertex_mask, b.vertex_mask) and torch.equal(a.edge_mask, b.edge_mask)):
        return False
    ba, bb = a.bindings(), b.bindings()
    return set(ba) == set(bb) and all(torch.equal(ba[k], bb[k]) for k in ba)


def same_wire(w, r) -> bool:
    """A ``WireMatchResult`` (numpy) equals a MatchResult bit for bit."""
    rb, wb = r.bindings(), w.bindings()
    return (np.array_equal(w.vertex_mask, r.vertex_mask.cpu().numpy())
            and np.array_equal(w.edge_mask, r.edge_mask.cpu().numpy())
            and set(rb) == set(wb)
            and all(np.array_equal(wb[k], rb[k].cpu().numpy()) for k in rb))


def closed_loop(svc, workload):
    """``SERVICE_CLIENTS`` closed-loop client threads over ``workload``
    through ``Service.submit`` (pgserve's harness); returns its metrics and
    every (text, answer) pair, checked after the clock stops."""
    import threading

    from repro_torch.launch import pgserve

    answers, lock = [], threading.Lock()

    def make_session():
        def call(graph, text):
            res = svc.submit(graph, text).result(timeout=120)
            with lock:
                answers.append((text, res))
        return call, (lambda: None)

    return pgserve._run_closed_loop(make_session, workload, SERVICE_CLIENTS), answers


def service_phase(pg, reqs, results, seed: int, device: str, sync) -> dict:
    """Phase 3h (module docstring): the service and wire layer over ``pg``;
    ``reqs`` and ``results`` are phase 3's texts and answers on ``pg``."""
    import torch

    from repro_torch.launch import pgserve
    from repro_torch.obs import parse_prometheus
    from repro_torch.service import PGClient, PGServer, Service, ServiceConfig, wire

    t_phase = time.perf_counter()
    out = {"mem_before_gib": torch.cuda.memory_allocated() / 2**30 if device == "cuda" else None}
    if device == "cuda":
        torch.cuda.reset_peak_memory_stats()
    texts = [t for _, t in reqs]
    want = dict(zip(texts, results))
    workload = pgserve.synthetic_workload(["graph3"], texts, SERVICE_REQUESTS, seed=seed)
    b1 = b3 = 0
    b1_q = []

    def keep(rec):
        nonlocal b1, b3
        b1 += rec["launches"]["b1"]
        b3 += rec["launches"]["b3"]
        b1_q.extend(rec["b1_q"])

    # (1) the closed loop with both caches off: every request reaches the card
    cfg = ServiceConfig(plan_cache_size=0, result_cache_size=0)
    with Service(config=cfg) as svc:
        svc.add_graph("graph3", pg)
        with counting_launches() as rec:
            loop, answers = closed_loop(svc, workload)
        keep(rec)
        st = svc.stats()
    check(len(answers) == SERVICE_REQUESTS and all(same_result_on(r, want[t]) for t, r in answers),
          "3h caches off: every answer equals phase 3's bit for bit")
    del answers
    check(st.get("coalesced_launches", 0) > 0, "3h caches off: requests were coalesced")
    check(st.get("traversal_fallback_requests", 0) > 0,
          "3h caches off: the *1..3 and * kinds ran per request")
    if device == "cuda":
        check(rec["launches"]["b1"] > 0 and max(rec["b1_q"]) > 1,
              "3h caches off: B1 launched on the service path with Q > 1")
    out["caches_off"] = {**loop, **{k: st.get(k, 0) for k in (
        "coalesced_launches", "coalesced_masks", "traversal_fallback_requests", "batches",
        "batched_requests", "completed")},
        "coalesce_width": st.get("pg_sched_coalesce_width"),
        "b1_launches": rec["launches"]["b1"], "b1_max_q": max(rec["b1_q"], default=0)}
    out["sequential"] = pgserve.run_sequential({"graph3": pg}, workload)

    # (2) the same stream with the default caches
    with Service() as svc:
        svc.add_graph("graph3", pg)
        with counting_launches() as rec:
            loop, answers = closed_loop(svc, workload)
        keep(rec)
        st = svc.stats()
        svc.result_cache.clear()
    check(len(answers) == SERVICE_REQUESTS and all(same_result_on(r, want[t]) for t, r in answers),
          "3h caches on: every answer equals phase 3's bit for bit")
    del answers
    out["caches_on"] = {**loop, **{k: st.get(k, 0) for k in (
        "result_hits", "result_misses", "fastpath_hits", "dedup_hits", "coalesced_launches")},
        "b1_launches": rec["launches"]["b1"]}
    if device == "cuda":
        out["mem_peak_gib_caches"] = torch.cuda.max_memory_allocated() / 2**30

    # (3) coalesced sampling: 9 requests of 1,024 ids, one (fanouts, bucket) group
    nodes = pg.graph.node_map.cpu().numpy()
    rng = np.random.default_rng(seed + 11)
    specs = [(rng.choice(nodes, 1024, replace=False), i,
              GNN_FILTER if i == SERVICE_SAMPLES - 1 else None) for i in range(SERVICE_SAMPLES)]
    with Service() as svc:
        svc.add_graph("graph3", pg)
        n0 = svc.stats().get("sample_coalesced_launches", 0)
        with counting_launches() as rec:
            sync()
            t0 = time.perf_counter()
            batch = svc.sample_batch("graph3", specs, FANOUTS)
            sync()
            batch_ms = (time.perf_counter() - t0) * 1e3
        keep(rec)
        check(svc.stats()["sample_coalesced_launches"] == n0 + 1,
              "3h sample_batch: the 9 requests took one coalesced launch")
        if device == "cuda":
            check((16, 1024) in rec["b3_rows"],
                  "3h sample_batch: B3 launched with R = 9 (16 rows of 1,024) on the service path")
        with counting_launches() as rec2:
            sync()
            t0 = time.perf_counter()
            futs = [svc.submit_sample("graph3", ids, FANOUTS, seed=sv, pattern=filt)
                    for ids, sv, filt in specs]
            concurrent = [f.result(timeout=120) for f in futs]
            sync()
            concurrent_ms = (time.perf_counter() - t0) * 1e3
        keep(rec2)
        sample_stats = svc.stats()
    for (ids, sv, filt), a, b in zip(specs, batch, concurrent):
        solo = pg.sample(ids, FANOUTS, seed=sv, pattern=filt)
        check(same_blocks(a, solo) and same_blocks(b, solo),
              f"3h sample {sv}: coalesced blocks equal the solo sample bit for bit")
    out["samples"] = {"batch_ms": batch_ms, "concurrent_ms": concurrent_ms,
                      "b3_rows": rec["b3_rows"], "b3_rows_concurrent": rec2["b3_rows"],
                      "sample_coalesced_launches": sample_stats["sample_coalesced_launches"]}
    del batch, concurrent

    # (4) the wire at full size: a PGServer on 127.0.0.1 and the port's client
    kinds = reqs[:6]
    with Service() as svc:
        svc.add_graph("graph3", pg)
        server = PGServer(svc, host="127.0.0.1", port=0, device=device).start()
        try:
            with counting_launches() as rec, PGClient(port=server.port, timeout=300) as c:
                check(c.ping(), "3h wire: ping")
                for kind, text in kinds:
                    check(same_wire(c.query("graph3", text), want[text]),
                          f"3h wire {kind}: the answer equals phase 3's bit for bit")
                burst = texts[:24] + texts[:8]  # duplicates coalesce server-side
                for text, res in zip(burst, c.query_batch("graph3", burst)):
                    check(same_wire(res, want[text]), "3h wire burst: bitwise phase 3's")
                h = c.submit("graph3", kinds[0][1])
                h.result(timeout=300)
                check(h.trace is not None and h.trace["trace_id"] == h.trace_id,
                      "3h wire: the client's trace id came back in the span tree")
                lat = []
                for _, text in reqs:
                    t0 = time.perf_counter()
                    c.query("graph3", text)
                    lat.append((time.perf_counter() - t0) * 1e3)
                metrics = parse_prometheus(c.metrics())
                st = c.stats()
            keep(rec)
            check(metrics["pg_service_completed_total"] == st["completed"],
                  "3h wire: the metrics verb agrees with stats()")
        finally:
            server.close(timeout=30)
        meta, arrays = wire.result_to_wire(want[kinds[0][1]])
        sizes = [len(wire._pack_array(a)[1]) for a in arrays[:2]]
        check(sizes == [(pg.n_vertices + 7) // 8, (pg.n_edges + 7) // 8],
              f"3h wire: packed mask payloads are ceil(n/8) bytes ({sizes})")
        svc.result_cache.clear()
    out["wire"] = {"p50_ms": statistics.median(lat), "p95_ms": float(np.percentile(lat, 95)),
                   "vertex_mask_bytes": sizes[0], "edge_mask_bytes": sizes[1],
                   "completed": st["completed"]}

    # (5) EXPLAIN ANALYZE of the fused 1-hop text, twice; on the card the first
    # follows an emptied allocator cache, so its first call pays the first blocks
    if device == "cuda":
        torch.cuda.empty_cache()
    with counting_launches() as rec:
        rep1 = pg.explain_analyze(kinds[0][1])
        rep2 = pg.explain_analyze(kinds[0][1])
    keep(rec)
    for rep in (rep1, rep2):
        check(rep.total_first_ms >= rep.steady_ms >= 0, "3h explain_analyze: first ≥ steady ≥ 0")
    if device == "cuda":
        check(rep2.compile_ms <= rep1.compile_ms,
              "3h explain_analyze: the second report's first-call share is not above the first's")
    out["explain_analyze"] = [rep1.to_dict(), rep2.to_dict()]
    print("phase 3h explain_analyze", json.dumps(out["explain_analyze"]), flush=True)

    # (6) the CLI's gates as subprocesses on the device
    out["b1_launches"], out["b3_launches"], out["b1_max_q"] = b1, b3, max(b1_q, default=0)
    out["cli_s"] = {}
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src") + os.pathsep
           + os.environ.get("PYTHONPATH", "")}
    for mode, ok_line in ((["--smoke"], "PGSERVE SMOKE OK"),
                          (["--net", "--smoke"], "PGSERVE NET SMOKE OK")):
        t0 = time.perf_counter()
        proc = subprocess.run([sys.executable, "-m", "repro_torch.launch.pgserve", *mode,
                               "--device", device], capture_output=True, text=True, env=env,
                              timeout=SERVICE_CLI_TIMEOUT, cwd=ROOT)
        out["cli_s"][" ".join(mode)] = time.perf_counter() - t0
        lines = proc.stdout.strip().splitlines()
        check(proc.returncode == 0 and lines and lines[-1] == ok_line,
              f"3h pgserve {' '.join(mode)} exits 0 with {ok_line!r}: rc {proc.returncode}\n"
              f"{proc.stdout[-2000:]}\n{proc.stderr[-2000:]}")
    if device == "cuda":
        out["mem_peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
        out["mem_after_gib"] = torch.cuda.memory_allocated() / 2**30
    out["phase_s"] = time.perf_counter() - t_phase
    return out


# ---------------------------------------------------------------- sampling
def sample_requests(pg, seed: int):
    """Phase 3b's three requests: (kind, seeds or seed pattern, edge filter)."""
    nodes = pg.graph.node_map.cpu().numpy()
    ids = np.random.default_rng(seed + 4).choice(nodes, 1024, replace=False)
    return [("ids", ids, None),
            ("pattern", "(a:l0)", None),
            ("filtered", "(a:l0 {age > 50})", "(a)-[e {w < 0.5}]->(b)")]


@contextlib.contextmanager
def recording():
    """Record, in call order, every priority draw (key, shape, tensor), every
    layer's selection (seeds, valid, edge words, fanout and outputs) and
    every B3 call's inputs, of the sampling calls inside the block."""
    from repro_torch.kernels.neighbor_sample import ops

    rec = {"draws": [], "layers": [], "b3": []}
    saved = ops._draw_priorities, ops._window_select, ops.window_select

    def draw(key, shape, device):
        u = saved[0](key, shape, device)
        rec["draws"].append((key, tuple(shape), u))
        return u

    def layer(seg, dst, m, n, seeds, valid, ew_words, u, fanout):
        out = saved[1](seg, dst, m, n, seeds, valid, ew_words, u, fanout)
        rec["layers"].append((seeds, valid, ew_words, fanout, out))
        return out

    def b3(start, deg, dst, ew_words, pri, *, fanout):
        rec["b3"].append((start, deg, dst, ew_words, pri, fanout))
        return saved[2](start, deg, dst, ew_words, pri, fanout=fanout)

    ops._draw_priorities, ops._window_select, ops.window_select = draw, layer, b3
    try:
        yield rec
    finally:
        ops._draw_priorities, ops._window_select, ops.window_select = saved


@contextlib.contextmanager
def replaying(draws):
    """Hand the recorded priorities back, in order, to the sampling calls
    inside the block (on whatever device they run)."""
    from repro_torch.kernels.neighbor_sample import ops

    saved = ops._draw_priorities
    pending = iter(draws)

    def draw(key, shape, device):
        k, shp, u = next(pending)
        check(k == key and shp == tuple(shape), f"replayed draw {k}{shp} for {key}{shape}")
        return u.to(device)

    ops._draw_priorities = draw
    try:
        yield
    finally:
        ops._draw_priorities = saved


def check_layers(layers, seg, dst, m: int, seed: int) -> int:
    """Every recorded layer through ``check_sample`` (a random subset of
    ``CHECK_ROWS`` rows where it has more); returns the rows checked."""
    from repro_torch.core import bitplane
    from repro_torch.kernels.neighbor_sample.ref import check_sample

    rng = np.random.default_rng(seed)
    checked = 0
    for seeds, valid, ew, fanout, out in layers:
        keep = valid.cpu().numpy()
        sd = seeds.cpu().numpy()[keep]
        nb, ei, mk = (x.cpu().numpy()[keep] for x in out)
        rows = (np.sort(rng.choice(len(sd), CHECK_ROWS, replace=False))
                if len(sd) > CHECK_ROWS else np.arange(len(sd)))
        edge_ok = None if ew is None else bitplane.unpack_bits_host(ew.cpu().numpy(), m)
        check_sample(seg, dst, sd[rows], edge_ok, fanout, nb[rows], ei[rows], mk[rows])
        checked += len(rows)
    return checked


def same_blocks(a, b) -> bool:
    return len(a) == len(b) and all(
        getattr(x, f).dtype == getattr(y, f).dtype and np.array_equal(getattr(x, f), getattr(y, f))
        for x, y in zip(a, b)
        for f in ("src_nodes", "dst_nodes", "edge_src", "edge_dst", "edge_mask"))


def sampling_phase(pg, cpu_pg, seed: int, device: str, sync) -> dict:
    """Phase 3b (module docstring).  Returns per-kind results and the
    ``pattern`` request's layer-0 B3 inputs for phase 5."""
    from repro_torch.kernels.bitmap_query import ops as bq_ops
    from repro_torch.kernels.neighbor_sample import ops

    seg, dst = pg.graph.seg.cpu().numpy(), pg.graph.dst.cpu().numpy()
    out, b3_inputs = {}, None
    for kind, seeds, edge_filter in sample_requests(pg, seed):
        def request():
            return pg.sample(seeds, FANOUTS, seed=seed, pattern=edge_filter)

        ops.reset_launches()
        bq_ops.reset_launches()
        request()  # warm
        sync()
        runs = []
        for _ in range(5):
            t0 = time.perf_counter()
            request()
            sync()
            runs.append((time.perf_counter() - t0) * 1e3)
        launches = ops.launches[ops.WINDOW_SELECT]
        if device == "cuda":
            check(launches > 0, f"sample {kind}: the path launched B3")
            check(kind == "ids" or bq_ops.launches[bq_ops.PACKED] > 0,
                  f"sample {kind}: the seed pattern launched B1")
        with recording() as rec:
            blocks = request()
        sync()
        check(len(blocks) == len(FANOUTS) and len(rec["layers"]) == len(FANOUTS),
              f"sample {kind}: one block and one selection per layer")
        check(all(b.edge_mask.any() for b in blocks), f"sample {kind}: every layer sampled edges")
        checked = check_layers(rec["layers"], seg, dst, pg.n_edges, seed)
        with replaying(rec["draws"]):
            cpu_blocks = cpu_pg.sample(seeds, FANOUTS, seed=seed, pattern=edge_filter)
        check(same_blocks(blocks, cpu_blocks),
              f"sample {kind}: card blocks equal the CPU port's on the same priorities")
        if kind == "pattern":
            b3_inputs = rec["b3"][0]
        profiled = sample_profile(request) if device == "cuda" else None
        out[kind] = {"median_ms": statistics.median(runs), "runs_ms": runs,
                     "b3_launches": launches,
                     "seeds": int(blocks[-1].n_dst),
                     "layer_rows": [int(s.shape[-1]) for s, *_ in rec["layers"]],
                     "sampled_edges": [int(b.edge_mask.sum()) for b in blocks[::-1]],
                     "rows_checked": checked, "profile": profiled}
        del rec, blocks, cpu_blocks
    return {"requests": out, "b3_inputs": b3_inputs}


def sample_profile(request) -> dict:
    """One more run of a sample ``request`` under ``torch.profiler`` (the
    card's own time against the window: its busy share) and one under
    ``cProfile`` (where the host's time goes: the functions with the most
    time of their own, a synchronising call holding the wait for the card)."""
    import cProfile
    import pstats

    import torch

    events, wall_s = on_card(request)
    device_s = sum(e.self_device_time_total for e in events) / 1e6
    host = cProfile.Profile()
    host.enable()
    request()
    torch.cuda.synchronize()
    host.disable()
    stats = pstats.Stats(host).stats
    top = sorted(stats.items(), key=lambda kv: kv[1][2], reverse=True)[:10]
    return {"wall_ms": wall_s * 1e3, "device_ms": device_s * 1e3,
            "busy_share": device_s / wall_s if device_s else "not measured",
            "top_device_ms": [(e.key[:60], e.self_device_time_total / 1e3, e.count)
                              for e in events[:6]],
            "top_host_ms": [(f"{Path(f).name}:{line}({fn})", tt * 1e3, nc)
                            for (f, line, fn), (_cc, nc, tt, _ct, _callers) in top]}


# ----------------------------------------------------------- GNN serving
def subgraph_batch(blocks, seed_int, feats, labels):
    """Union-of-blocks compacted subgraph, as
    ``examples/gnn_sampled_training.py:57`` builds it: ``blocks[0].src_nodes``
    is the widest frontier, a sorted superset of every id in the chain, so
    renumbering is one ``searchsorted`` per block; edges sorted by source
    (DI order).  Block ids are the graph's internal ids, which index the
    ``feats`` (n, F) and ``labels`` (n,) tables on their device; the rows
    are gathered there.  ``seed_int``: the internal ids of the seeds (the
    nodes the loss and the answer are taken over)."""
    import torch

    from repro_torch.models.gnn_common import GraphBatch

    device = feats.device
    sub = np.asarray(blocks[0].src_nodes)
    es_l, ed_l = [], []
    for b in blocks:
        sn, dn = np.asarray(b.src_nodes), np.asarray(b.dst_nodes)
        s, d = np.asarray(b.edge_src), np.asarray(b.edge_dst)
        keep = np.asarray(b.edge_mask)
        es_l.append(np.searchsorted(sub, sn[s[keep]]))
        ed_l.append(np.searchsorted(sub, dn[d[keep]]))
    e_src = np.concatenate(es_l).astype(np.int32)
    e_dst = np.concatenate(ed_l).astype(np.int32)
    order = np.argsort(e_src, kind="stable")
    nmask = np.zeros(len(sub), bool)
    nmask[np.searchsorted(sub, seed_int)] = True
    rows = torch.from_numpy(sub.astype(np.int64)).to(device)
    t = lambda a: torch.from_numpy(a).to(device)  # noqa: E731
    return GraphBatch(
        x=feats[rows], pos=None, species=None,
        edge_src=t(e_src[order]), edge_dst=t(e_dst[order]), edge_attr=None,
        edge_mask=torch.ones(len(e_src), dtype=torch.bool, device=device),
        node_mask=t(nmask), labels=labels[rows],
        graph_ids=torch.zeros(len(sub), dtype=torch.int32, device=device),
        n_nodes=len(sub), n_edges=len(e_src), n_graphs=1)


@contextlib.contextmanager
def recording_seg_mm():
    """Record the inputs (x, src, dst, n, weights) of every B5 call made
    through ``spmm_di`` inside the block."""
    from repro_torch.kernels.seg_mm import ops

    calls = []
    saved = ops.seg_mm

    def seg_mm(x, src_idx, dst_idx, n_nodes, *, edge_weight=None):
        calls.append((x, src_idx, dst_idx, n_nodes, edge_weight))
        return saved(x, src_idx, dst_idx, n_nodes, edge_weight=edge_weight)

    ops.seg_mm = seg_mm
    try:
        yield calls
    finally:
        ops.seg_mm = saved


def check_logits(model, batch, logits, seed_int, kind: str) -> dict:
    """``logits`` (from the card) against the port on the CPU run on the
    same batch, at ``GNN_TOL``.  Every seed's class must agree, except
    where the CPU's two best logits lie within that tolerance of each
    other: there either class is an answer within it (counted)."""
    import torch

    from repro_torch.models import gcn

    cpu_params = {"layers": [{k: v.detach().cpu() for k, v in lp.items()}
                             for lp in model.params()["layers"]]}
    with torch.inference_mode():
        want = gcn.forward(cpu_params, batch.to("cpu"), model.cfg)
    got = logits.cpu()
    check(got.shape == want.shape == (batch.n_nodes, N_CLASSES), f"{kind}: logits shape")
    check(bool(torch.isfinite(got).all()), f"{kind}: logits finite")
    err = float((got - want).abs().max()) if got.numel() else 0.0
    check(torch.allclose(got, want, rtol=GNN_TOL, atol=GNN_TOL),
          f"{kind}: card logits within {GNN_TOL} of the CPU port's (max err {err})")
    seeds = torch.from_numpy(np.flatnonzero(batch.node_mask.cpu().numpy()))
    check(len(seeds) == len(seed_int), f"{kind}: one answer per seed")
    g, w = got[seeds], want[seeds]
    top2 = torch.topk(w, 2, dim=1).values
    tied = (top2[:, 0] - top2[:, 1]) <= GNN_TOL + GNN_TOL * top2[:, 0].abs()
    differ = g.argmax(dim=1) != w.argmax(dim=1)
    check(not bool((differ & ~tied).any()), f"{kind}: every seed's class equals the CPU port's")
    return {"max_abs_err": err, "seeds": len(seeds), "near_ties": int(tied.sum()),
            "classes_differing_in_ties": int(differ.sum())}


def forward_kernels(forward, what: str, kernel: str, banned: str) -> dict:
    """One more ``forward()`` under ``torch.profiler``: the kernels it ran
    on the card.  ``kernel`` (the path's own) must be among them, and none
    whose name matches the ``banned`` pattern (library or compiled kernels
    doing the path's work)."""
    import torch

    def run():
        with torch.inference_mode():
            forward()

    events, _ = on_card(run, want=kernel)
    names = sorted(e.key for e in events)
    check(any(kernel in k for k in names),
          f"the {what} ran {kernel} (the session recorded {len(names)} device events)")
    found = [k for k in names if re.search(banned, k, re.I)]
    check(not found, f"the {what} ran no kernel matching {banned}: {found}")
    return {"device_ms": sum(e.self_device_time_total for e in events) / 1e3,
            "kernels": [(e.key[:60], e.self_device_time_total / 1e3, e.count) for e in events]}


def seed_pool(pg) -> np.ndarray:
    """The original ids of the vertices ``GNN_SEED_POOL``'s first node
    binds (one ``match()``: B1 on the card)."""
    res = pg.match(GNN_SEED_POOL)
    mask = (res.node_masks[0] if res.node_masks else res.vertex_mask).cpu().numpy()
    return pg.graph.node_map.cpu().numpy()[np.flatnonzero(mask)]


def gnn_phase(pg, seed: int, device: str, sync) -> dict:
    """Phase 3c (module docstring), then phase 3j (a) on its feature table
    (``train_gnn_phase``, under "train").  Returns per-kind results and the
    population request's B5 inputs for phase 5."""
    import torch

    from repro_torch.configs import gcn_cora
    from repro_torch.kernels.seg_mm import ops
    from repro_torch.models import gcn

    check(torch.backends.cuda.matmul.allow_tf32 is False, "TF32 is off for float32 matmuls")
    n = pg.n_vertices
    out = {}
    if device == "cuda":  # the phase's own peak; the run's peak before it is kept
        out["peak_mem_gib_before"] = torch.cuda.max_memory_allocated() / 2**30
        torch.cuda.reset_peak_memory_stats()
    gen = torch.Generator(device=device).manual_seed(seed + 5)
    feats = torch.randn((n, D_FEAT), generator=gen, device=device)
    labels = torch.randint(0, N_CLASSES, (n,), generator=gen, device=device, dtype=torch.int32)
    cfg = gcn_cora.full_config(d_feat=D_FEAT, n_classes=N_CLASSES)  # spmm_di: B5 on the card
    model = gcn.GCN(cfg, gcn.init_params(gen, cfg, device=device))
    pool = seed_pool(pg)
    rng = np.random.default_rng(seed + 6)

    def serve(seeds, key):
        t0 = time.perf_counter()
        blocks = pg.sample(seeds, FANOUTS, seed=key, pattern=GNN_FILTER)
        sync()
        t1 = time.perf_counter()
        seed_int = blocks[-1].dst_nodes
        batch = subgraph_batch(blocks, seed_int, feats, labels)
        sync()
        t2 = time.perf_counter()
        with torch.inference_mode():
            logits = model(batch)
        sync()
        t3 = time.perf_counter()
        split = {"sample": (t1 - t0) * 1e3, "batch": (t2 - t1) * 1e3, "forward": (t3 - t2) * 1e3}
        return blocks, seed_int, batch, logits, split

    def summary(splits):
        return {k: statistics.median(s[k] for s in splits)
                for k in ("sample", "batch", "forward", "total")}

    b5_inputs = None
    ops.reset_launches()
    builds0 = ops.LAYOUTS.builds
    served = 0
    # minibatch: 8 requests of 1,024 original ids drawn from the seed pool
    picks = [rng.choice(pool, min(GNN_BATCH, len(pool)), replace=False)
             for _ in range(GNN_MINIBATCHES + 1)]
    splits = []
    for k, ids in enumerate(picks):  # request 0 warms and is not timed
        blocks, seed_int, batch, logits, split = serve(ids, k)
        served += 1
        split["total"] = sum(split.values())
        if k:
            splits.append(split)
        if k == 1:
            out_check = check_logits(model, batch, logits, seed_int, "minibatch")
        del blocks, batch, logits
    out["minibatch"] = {**summary(splits), "runs": splits, "check": out_check,
                        "seeds": out_check["seeds"]}
    # population: every seed of the label pattern, one warm run then 3
    splits = []
    for k in range(4):
        if k == 1:
            with recording_seg_mm() as calls:
                blocks, seed_int, batch, logits, split = serve(GNN_POPULATION, 100 + k)
            b5_inputs = calls
            out_check = check_logits(model, batch, logits, seed_int, "population")
            shape = {"n_sub": batch.n_nodes, "e_sub": batch.n_edges,
                     "sampled_edges": [int(b.edge_mask.sum()) for b in blocks[::-1]]}
        else:
            blocks, seed_int, batch, logits, split = serve(GNN_POPULATION, 100 + k)
        served += 1
        split["total"] = sum(split.values())
        if k:
            splits.append(split)
        del blocks, batch, logits
    out["population"] = {**summary(splits), "runs": splits, "check": out_check,
                         "seeds": out_check["seeds"], **shape}
    launches = ops.launches[ops.SEG_MM]
    out["b5_launches"] = launches
    out["requests"] = served
    out["layout_builds"] = ops.LAYOUTS.builds - builds0
    if device == "cuda":
        check(launches >= 2 * served, f"B5 launched {launches} times for {served} requests "
                                      "(one per GCN layer)")
        check(out["layout_builds"] == served, "one B5 layout per request, shared by both layers")
        # one more population request under the profilers (card busy share, host hot
        # spots), then one more forward alone (the kernels it ran)
        out["population"]["profile"] = sample_profile(lambda: serve(GNN_POPULATION, 104))
        batch = serve(GNN_POPULATION, 105)[2]
        out["population"]["forward_profile"] = forward_kernels(
            lambda: model(batch), "GCN forward", "seg_mm_kernel",
            r"indexFunc|index_add|sparse|csrmm|triton")
        del batch
        out["peak_mem_gib"] = torch.cuda.max_memory_allocated() / 2**30
    out["b5_inputs"] = b5_inputs
    # phase 3j (a): training on the same table, before it is freed
    out["train"] = train_gnn_phase(pg, pool, feats, labels, seed, device, sync)
    del feats, labels, model
    if device == "cuda":
        torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------- recsys serving
def held_rows(tables, idx):
    """The table rows a batch names, on the host, and the batch's indices
    into them: per field the sorted distinct rows, so the CPU port scores
    the batch without a host copy of every table.  Indices must lie in
    [0, V), as ``dlrm_batch`` draws them."""
    import torch

    f, v, d = tables.shape
    check(bool(((idx >= 0) & (idx < v)).all()), "held_rows: indices in [0, V)")
    cols, local = [], torch.empty_like(idx)
    for j in range(f):
        uniq, inv = torch.unique(idx[:, j], return_inverse=True)
        cols.append(tables[j, uniq.to(torch.int64)])
        local[:, j] = inv.to(torch.int32)
    rows = torch.zeros((f, max(c.shape[0] for c in cols), d), dtype=tables.dtype,
                       device=tables.device)
    for j, c in enumerate(cols):
        rows[j, :c.shape[0]] = c
    return rows.cpu(), local.cpu()


def cpu_params(params, tables) -> dict:
    """``params``' MLPs on the host beside the given host ``tables``."""
    return {"tables": tables,
            **{k: [{n: t.cpu() for n, t in lp.items()} for lp in params[k]]
               for k in ("bot", "top")}}


def check_close(got, want, tol: float, what: str, against: str = "the CPU port's") -> float:
    """``got`` (from the card) finite and within ``tol`` (atol = rtol) of
    ``want`` (on the host: by default the CPU port's); returns the largest
    difference."""
    import torch

    got = got.cpu()
    check(got.shape == want.shape, f"{what}: shape {tuple(got.shape)} vs {tuple(want.shape)}")
    check(bool(torch.isfinite(got).all()), f"{what}: finite")
    err = float((got - want).abs().max()) if got.numel() else 0.0
    check(torch.allclose(got, want, rtol=tol, atol=tol),
          f"{what}: within {tol} of {against} (max err {err})")
    return err


def check_topk(vals, ids, want_vals, want_ids, tol: float, what: str) -> int:
    """Top-k from the card against the CPU's top-(k+1), row by row: values
    within ``tol``; ids equal except where the CPU's score at that rank lies
    within ``tol`` of a neighbouring rank's (a near-tie either order
    answers).  Returns how many ranks differ."""
    k = vals.shape[-1]
    vals, ids = vals.cpu().reshape(-1, k), ids.cpu().reshape(-1, k).to(want_ids.dtype)
    want_vals, want_ids = want_vals.reshape(-1, k + 1), want_ids.reshape(-1, k + 1)
    check_close(vals, want_vals[:, :k], tol, f"{what} top-{k} values")
    gap = (want_vals[:, :-1] - want_vals[:, 1:]).abs() <= tol + tol * want_vals[:, 1:].abs()
    near = gap[:, :k].clone()  # rank r ties with r + 1 ...
    near[:, 1:] |= gap[:, :k - 1]  # ... or with r - 1
    differ = ids != want_ids[:, :k]
    check(not bool((differ & ~near).any()), f"{what} top-{k} ids equal the CPU's outside near-ties")
    return int(differ.sum())


def top_items(bags, items, k: int, block: int = ITEM_BLOCK):
    """The ``k`` best ``items`` rows for each bag by dot product, scoring
    ``block`` items at a time and merging the running best: no
    (bags, items) matrix is made.  Returns (values, item rows)."""
    import torch

    best_v = best_i = None
    for lo in range(0, items.shape[0], block):
        v, i = torch.topk(bags @ items[lo:lo + block].T, k, dim=1)
        i = i + lo
        if best_v is not None:
            v, j = torch.topk(torch.cat([best_v, v], dim=1), k, dim=1)
            i = torch.gather(torch.cat([best_i, i], dim=1), 1, j)
        best_v, best_i = v, i
    return best_v, best_i


def serve_dlrm(params, cfg, batch, device, sync):
    """One scoring request end to end: the host batch uploaded, scored
    (B4 on the card), the logits back on the host.  Returns (logits, ms)."""
    import torch

    from repro_torch.models import dlrm

    t0 = time.perf_counter()
    with torch.inference_mode():
        logits = dlrm.forward(params, batch["dense"].to(device), batch["sparse"].to(device),
                              cfg).cpu()
    sync()
    return logits, (time.perf_counter() - t0) * 1e3


def recsys_phase(seed: int, device: str, sync) -> dict:
    """Phase 3d's DLRM part (module docstring).  Returns per-kind results,
    the tables and the serve batches' indices on the device for phase 5."""
    import torch

    from repro_torch.configs import dlrm_rm2
    from repro_torch.configs.common import RECSYS_SHAPES
    from repro_torch.data import dlrm_batch
    from repro_torch.kernels.embedding_bag import ops
    from repro_torch.models import dlrm

    check(torch.backends.cuda.matmul.allow_tf32 is False, "TF32 is off for float32 matmuls")
    cfg = dlrm_rm2.full_config() if device == "cuda" else dlrm_rm2.smoke_config()
    out = {"config": cfg.name, "vocab": cfg.vocab_size, "embed_dim": cfg.embed_dim}
    if device == "cuda":  # the phase's own peak
        torch.cuda.reset_peak_memory_stats()
    gen = torch.Generator(device=device).manual_seed(seed + 8)
    t0 = time.perf_counter()
    params = dlrm.init_params(gen, cfg, device=device)
    sync()
    out["init_s"] = time.perf_counter() - t0
    out["table_gb"] = params["tables"].numel() * params["tables"].element_size() / 1e9

    def batch(step, rows):  # requests arrive from the host
        return dlrm_batch(step, batch=rows, vocab=cfg.vocab_size, seed=seed, device="cpu")

    def held(kind, b, logits):
        rows, local = held_rows(params["tables"], b["sparse"].to(device))
        with torch.inference_mode():
            want = dlrm.forward(cpu_params(params, rows), b["dense"], local, cfg)
        return {"max_abs_err": check_close(logits, want, RECSYS_TOL, f"{kind} logits"),
                "rows": len(logits)}

    def launched() -> int:  # B4 launches since the last call
        n = ops.launches[ops.EMBEDDING_BAG]
        ops.reset_launches()
        return n

    ops.reset_launches()
    served = {}
    # serve_p99: 16 requests after a warm one
    p99 = RECSYS_SHAPES["serve_p99"]["batch"]
    batches = [batch(k, p99) for k in range(P99_REQUESTS + 1)]
    runs = []
    for k, b in enumerate(batches):
        logits, ms = serve_dlrm(params, cfg, b, device, sync)
        if k:
            runs.append(ms)
        if k == 1:
            checked = held("serve_p99", b, logits)
    served["serve_p99"] = len(batches)
    out["serve_p99"] = {"median_ms": statistics.median(runs), "runs_ms": runs, "rows": p99,
                        "b4_launches": launched(), "check": checked}
    p99_idx = [b["sparse"].to(device) for b in batches[1:]]
    # serve_bulk: one request, three timed runs after a warm one
    bulk = RECSYS_SHAPES["serve_bulk"]["batch"]
    b = batch(1000, bulk)
    runs = [serve_dlrm(params, cfg, b, device, sync) for _ in range(4)]
    served["serve_bulk"] = len(runs)
    out["serve_bulk"] = {"median_ms": statistics.median(ms for _, ms in runs[1:]),
                         "runs_ms": [ms for _, ms in runs[1:]], "rows": bulk,
                         "b4_launches": launched(), "check": held("serve_bulk", b, runs[-1][0])}
    bulk_idx = b["sparse"].to(device)
    del runs
    # retrieval_cand: one query against 1,000,000 random candidates, top-100
    shape = RECSYS_SHAPES["retrieval_cand"]
    cands = torch.randn((shape["n_candidates"], cfg.embed_dim), generator=gen, device=device)
    q = batch(2000, shape["batch"])

    def retrieve():
        t0 = time.perf_counter()
        with torch.inference_mode():
            vals, ids = dlrm.retrieval_scores(params, q["dense"].to(device),
                                              q["sparse"].to(device), cands, cfg,
                                              top_k=RETRIEVAL_TOPK)
            vals, ids = vals.cpu(), ids.cpu()
        sync()
        return vals, ids, (time.perf_counter() - t0) * 1e3

    runs = [retrieve() for _ in range(4)]
    served["retrieval_cand"] = len(runs)
    vals, ids, _ = runs[-1]
    rows, local = held_rows(params["tables"], q["sparse"].to(device))
    with torch.inference_mode():
        want_v, want_i = dlrm.retrieval_scores(cpu_params(params, rows), q["dense"], local,
                                               cands.cpu(), cfg, top_k=RETRIEVAL_TOPK + 1)
    differ = check_topk(vals, ids, want_v, want_i, RECSYS_TOL, "retrieval_cand")
    out["retrieval_cand"] = {
        "median_ms": statistics.median(ms for *_, ms in runs[1:]),
        "runs_ms": [ms for *_, ms in runs[1:]],
        "candidates": shape["n_candidates"], "top_k": RETRIEVAL_TOPK,
        "b4_launches": launched(),
        "check": {"max_abs_err": float((vals - want_v[:RETRIEVAL_TOPK]).abs().max()),
                  "ids_differing_in_ties": differ}}
    out["b4_launches"] = sum(out[k]["b4_launches"] for k in served)
    out["requests"] = sum(served.values())
    if device == "cuda":
        for kind, n in served.items():
            check(out[kind]["b4_launches"] >= n,
                  f"{kind}: B4 launched {out[kind]['b4_launches']} times for {n} requests")
        out["serve_p99"]["profile"] = sample_profile(
            lambda: serve_dlrm(params, cfg, batches[1], device, sync))
        out["serve_bulk"]["profile"] = sample_profile(
            lambda: serve_dlrm(params, cfg, b, device, sync))
        out["retrieval_cand"]["profile"] = sample_profile(retrieve)
        dense, sparse = (batches[1][k].to(device) for k in ("dense", "sparse"))
        out["serve_p99"]["forward_profile"] = forward_kernels(
            lambda: dlrm.forward(params, dense, sparse, cfg), "DLRM forward",
            "embedding_bag_kernel", r"EmbeddingBag|embedding_bag_(?!kernel)|triton")
        out["peak_mem_gib"] = torch.cuda.max_memory_allocated() / 2**30
    del cands
    out["b4_calls"] = {"tables": params["tables"], "serve_p99": p99_idx, "serve_bulk": bulk_idx}
    out["model"] = (params, cfg)  # phase 3j (b) trains it after phase 5
    return out


def context_phase(pg, seed: int, device: str, sync) -> dict:
    """Phase 3d's graph-side user context (``examples/recsys_serving.py``'s
    second half on graph3): the first ``CONTEXT_USERS`` vertices of the
    seed pattern, their neighbourhoods sampled under the edge filter's
    packed mask and pooled from an (n, 64) table (``sample_embed``), then
    each user's top items over the table's last ``CONTEXT_ITEMS`` rows.
    Held as phase 3b holds sampling: the CPU port replayed on the card's
    priorities."""
    import torch

    from repro_torch.core import bitplane
    from repro_torch.kernels.neighbor_sample import ops, sample_embed

    g, n = pg.graph, pg.n_vertices
    res = pg.match(GNN_SEED_POOL)
    pool = (res.node_masks[0] if res.node_masks else res.vertex_mask).cpu().numpy()
    users = np.flatnonzero(pool)[:CONTEXT_USERS].astype(np.int32)
    words = bitplane.pack_mask(pg.match(GNN_FILTER).edge_mask)
    gen = torch.Generator(device=device).manual_seed(seed + 9)
    table = torch.randn((n, CONTEXT_DIM), generator=gen, device=device)
    lo = max(0, n - CONTEXT_ITEMS)
    key = seed + 10

    def embed(seg, dst, tab, ew):
        return sample_embed(seg, dst, n, pg.n_edges, users, key, tab, fanout=CONTEXT_FANOUT,
                            edge_words=ew, max_deg=int(g.max_deg))

    def request():
        t0 = time.perf_counter()
        bags, _nbrs, _eids, mask = embed(g.seg, g.dst, table, words)
        sync()
        t1 = time.perf_counter()
        vals, rows = top_items(bags[:len(users)], table[lo:], CONTEXT_TOPK)
        vals, rows = vals.cpu(), rows.cpu()
        t2 = time.perf_counter()
        return (bags, mask, vals, rows), {"sample_embed": (t1 - t0) * 1e3,
                                          "top_items": (t2 - t1) * 1e3,
                                          "total": (t2 - t0) * 1e3}

    ops.reset_launches()
    splits = [request()[1] for _ in range(6)][1:]  # the first warms
    launches = ops.launches[ops.WINDOW_SELECT]
    if device == "cuda":
        check(launches >= len(splits) + 1, "every context request launched B3")
    with recording() as rec:
        (bags, mask, vals, rows), _ = request()
    with replaying(rec["draws"]):
        cpu_bags, cpu_nbrs, cpu_eids, cpu_mask = embed(g.seg.cpu(), g.dst.cpu(), table.cpu(),
                                                       words.cpu())
    _seeds, _valid, _ew, _fanout, (nbrs, eids, ok) = rec["layers"][0]
    check(nbrs.cpu().equal(cpu_nbrs) and eids.cpu().equal(cpu_eids) and ok.cpu().equal(cpu_mask),
          "context: card nbrs/eids/mask equal the CPU port's on the same priorities")
    check(bool(mask.any()), "context: users sampled edges")
    bag_err = check_close(bags, cpu_bags, BAG_TOL, "context bags")
    # the blocked top items of the first 16 users with a non-empty context
    # (an empty bag scores every item 0) against an unblocked CPU top-k
    some = cpu_mask[:len(users)].any(dim=1)
    few = torch.nonzero(some).flatten()[:16]
    cpu_items = table[lo:].cpu()
    want_v, want_i = torch.topk(cpu_bags[few] @ cpu_items.T, CONTEXT_TOPK + 1, dim=1)
    tops = check_topk(vals[few], rows[few], want_v, want_i, RECSYS_TOL, "context items")
    out = {"users": len(users), "users_with_context": int(some.sum()), "fanout": CONTEXT_FANOUT,
           "items": n - lo, "sampled_edges": int(mask.sum()), "b3_launches": launches,
           **{k: statistics.median(s[k] for s in splits)
              for k in ("sample_embed", "top_items", "total")},
           "runs": splits, "check": {"bags_max_abs_err": bag_err, "items_checked": len(few),
                                     "items_differing_in_ties": tops}}
    if device == "cuda":
        out["profile"] = sample_profile(request)
    del table, cpu_items
    return out


# ---------------------------------------------------------------- phase 3j: training
def grads_of(loss, params, batch):
    """(loss, {leaf path: gradient}) of ``loss(params, batch)`` by autograd,
    the params left as they are."""
    import torch

    from repro_torch.optim.tree import flatten_with_paths, unflatten

    pairs, spec = flatten_with_paths(params)
    flat = [p.detach().requires_grad_(True) for _, p in pairs]
    value = loss(unflatten(spec, flat), batch)
    grads = torch.autograd.grad(value, flat)
    return value.detach(), {name: g for (name, _), g in zip(pairs, grads)}


def train_gnn_phase(pg, pool, feats, labels, seed: int, device: str, sync) -> dict:
    """Phase 3j (a), inside 3c while its feature table and seed pool live:
    ``gcn_cora.full_config()`` trained on ``minibatch_lg``-shaped batches
    (1,024 seeds of ``pool``, 3c's ``GNN_SEED_POOL``, drawn from (seed,
    step), 15-10 under ``GNN_FILTER``, whose mask the graph has cached
    since 3c, so the steps launch no B1) with the example's AdamW.  Step 0's
    loss and gradients against the CPU port on the same batch; 30 steps
    under the ``TrainController`` with a failure at 17, bitwise the
    unbroken run; 20 steps on one batch, whose loss must fall.  Returns the results and
    B5ᵀ's calls at a step's backward shapes for phase 5."""
    import torch

    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.configs import gcn_cora
    from repro_torch.ft import FailureInjector, TrainController
    from repro_torch.graph.segment_ops import degree_norm
    from repro_torch.kernels.bitmap_query import ops as bq_ops
    from repro_torch.kernels.neighbor_sample import ops as ns_ops
    from repro_torch.kernels.seg_mm import ops
    from repro_torch.launch.train import make_train_step
    from repro_torch.models import gcn
    from repro_torch.optim import AdamWConfig, init_state
    from repro_torch.optim.tree import leaves, tree_map

    t_phase = time.perf_counter()
    opt_cfg = AdamWConfig(**GNN_TRAIN_OPT)
    cfg = gcn_cora.full_config()
    check(cfg.d_in == feats.shape[1] and cfg.n_classes == N_CLASSES,
          "3j: gcn_cora.full_config() takes 3c's feature table and classes")
    gen = torch.Generator(device=device).manual_seed(seed + 30)
    params0 = gcn.init_params(gen, cfg, device=device)
    out = {"config": cfg.name, "d_in": cfg.d_in, "steps": TRAIN_STEPS}
    sampled = {}

    def batch_fn(step):  # step-addressed: the seeds and the sampler's key from (seed, step)
        ids = np.random.default_rng([seed, step]).choice(pool, min(GNN_BATCH, len(pool)),
                                                          replace=False)
        t0 = time.perf_counter()
        blocks = pg.sample(ids, FANOUTS, seed=seed * 100_003 + step, pattern=GNN_FILTER)
        sync()
        sampled["ms"] = (time.perf_counter() - t0) * 1e3
        return subgraph_batch(blocks, blocks[-1].dst_nodes, feats, labels)

    def loss(p, b):
        return gcn.loss_fn(p, b, cfg)

    def fresh():
        p = tree_map(lambda t: t.clone(), params0)
        return p, init_state(p)

    # (1) step 0's loss and every gradient against the CPU port on the same batch
    b0 = batch_fn(0)
    ops.reset_launches()
    builds0 = dict(ops.LAYOUTS.builds_by_orientation)
    card_loss, card_grads = grads_of(loss, params0, b0)
    sync()
    step_launches = dict(ops.launches)
    step_builds = {k: v - builds0[k] for k, v in ops.LAYOUTS.builds_by_orientation.items()}
    cpu_loss, cpu_grads = grads_of(loss, tree_map(lambda t: t.cpu(), params0), b0.to("cpu"))
    errs = [check_close(card_loss, cpu_loss, TRAIN_TOL, "3j GCN step-0 loss")]
    errs += [check_close(g, cpu_grads[k], TRAIN_TOL, f"3j GCN step-0 gradient {k}")
             for k, g in card_grads.items()]
    if device == "cuda":
        check(step_launches[ops.SEG_MM] == 4 and step_launches[ops.SEG_MM_T] == 2,
              f"3j: a GCN step launches B5 twice forward and B5ᵀ twice backward: {step_launches}")
        check(step_builds == {ops.FORWARD: 1, ops.TRANSPOSE: 1},
              f"3j: a step builds each B5 layout once: {step_builds}")
    out["step0"] = {"loss": float(card_loss), "max_abs_err": max(errs), "n_sub": b0.n_nodes,
                    "e_sub": b0.n_edges, "launches": step_launches, "layout_builds": step_builds}
    # phase 5's B5ᵀ calls at this step's backward shapes (x: a gradient of a layer's output)
    w = degree_norm(b0.edge_src, b0.edge_dst, b0.n_nodes) * b0.edge_mask.to(torch.float32)
    t_src, t_dst = ops.transposed_edges(b0.edge_dst, b0.n_nodes, b0.edge_src, b0.n_nodes)
    out["b5t_calls"] = [(torch.randn((b0.n_nodes, d), generator=gen, device=device), t_src,
                         t_dst, b0.n_nodes, w) for d in (cfg.n_classes, cfg.d_hidden)]

    # (2) 30 steps, checkpoints every 10, a failure at 17: bitwise the unbroken run
    ckpt_root = tempfile.mkdtemp(prefix="chip_smoke_ckpt_")

    def run(fail_at, where):
        logs = []

        def log(step, m):
            logs.append({"step": step, "loss": float(m["loss"]), "sample": sampled["ms"],
                         **m["ms"]})

        ctrl = TrainController(ckpt=CheckpointManager(os.path.join(ckpt_root, where), keep=2),
                               step_fn=make_train_step(loss, batch_fn, opt_cfg, sync=sync),
                               ckpt_every=TRAIN_CKPT_EVERY)
        t0 = time.perf_counter()
        state = ctrl.run(fresh(), TRAIN_STEPS, log=log,
                         injector=FailureInjector(fail_at) if fail_at else None)
        sync()
        return state, logs, time.perf_counter() - t0

    try:
        ops.reset_launches()
        ns_ops.reset_launches()
        bq_ops.reset_launches()
        builds0 = dict(ops.LAYOUTS.builds_by_orientation)
        whole, whole_logs, whole_s = run((), "whole")
        out["launches"] = {"b5": ops.launches[ops.SEG_MM], "b5t": ops.launches[ops.SEG_MM_T],
                           "b1": bq_ops.launches[bq_ops.PACKED],
                           "b3": ns_ops.launches[ns_ops.WINDOW_SELECT]}
        out["layout_builds"] = {k: v - builds0[k]
                                for k, v in ops.LAYOUTS.builds_by_orientation.items()}
        broken, broken_logs, broken_s = run((TRAIN_FAIL_AT,), "broken")
        check(all(torch.equal(a, b) for a, b in zip(leaves(whole), leaves(broken))),
              f"3j: {TRAIN_STEPS} steps with a failure at {TRAIN_FAIL_AT} (restored from step "
              f"{TRAIN_FAIL_AT // TRAIN_CKPT_EVERY * TRAIN_CKPT_EVERY}) end bitwise equal to the "
              "unbroken run")
        check(all(t.device.type == device for t in leaves(broken) if t.dim()),
              "3j: the restarted run stayed on its device")
        resumed = TRAIN_FAIL_AT // TRAIN_CKPT_EVERY * TRAIN_CKPT_EVERY
        check([x["loss"] for x in broken_logs[TRAIN_FAIL_AT:]]
              == [x["loss"] for x in whole_logs[resumed:]],
              "3j: the resumed steps' losses equal the unbroken run's")
        mgr = CheckpointManager(os.path.join(ckpt_root, "timed"), keep=1)
        t0 = time.perf_counter()
        mgr.save_sync(TRAIN_STEPS, whole)
        t1 = time.perf_counter()
        _, back = mgr.restore_latest(whole)
        sync()
        t2 = time.perf_counter()
        check(all(torch.equal(a, b) for a, b in zip(leaves(whole), leaves(back))),
              "3j: a checkpoint restores bit for bit")
    finally:
        shutil.rmtree(ckpt_root, ignore_errors=True)
    steps = whole_logs[1:]  # step 0 pays the first layout builds and allocations
    out["step_ms"] = {k: statistics.median(x[k] for x in steps)
                      for k in ("sample", "batch", "forward", "backward", "update")}
    out["step_ms"]["batch"] -= out["step_ms"]["sample"]  # the host's renumbering and uploads
    out["step_ms"]["total"] = statistics.median(
        sum(x[k] for k in ("batch", "forward", "backward", "update")) for x in steps)
    out.update(losses=[x["loss"] for x in whole_logs], run_s=whole_s, restarted_run_s=broken_s,
               checkpoint_ms=(t1 - t0) * 1e3, restore_ms=(t2 - t1) * 1e3)
    if device == "cuda":
        launches, builds = out["launches"], out["layout_builds"]
        check(launches["b5"] >= 4 * TRAIN_STEPS and launches["b5t"] >= 2 * TRAIN_STEPS,
              f"3j: B5 launched >= 4 a step, B5ᵀ >= 2: {launches}")
        check(builds == {ops.FORWARD: TRAIN_STEPS, ops.TRANSPOSE: TRAIN_STEPS},
              f"3j: one layout per orientation a step: {builds}")
        check(launches["b3"] >= TRAIN_STEPS, f"3j: every step launched B3: {launches}")
        check(launches["b1"] == 0, "3j: the steps launched no B1 (the seed pool is 3c's, the "
                                   f"edge filter's mask the graph's cached one): {launches}")

    # (3) 20 steps on one batch: the loss must fall
    step_fn = make_train_step(loss, lambda step: b0, opt_cfg)
    state, fixed = fresh(), []
    for step in range(TRAIN_FIXED_STEPS):
        state, m = step_fn(state, step)
        fixed.append(float(m["loss"]))
    check(fixed[-1] < fixed[0], f"3j: the loss falls on one batch: {fixed[0]} -> {fixed[-1]}")
    out["fixed_batch_losses"] = fixed
    out["phase_s"] = time.perf_counter() - t_phase
    return out


def train_dlrm_phase(params, cfg, seed: int, device: str, sync) -> dict:
    """Phase 3j (b), after phase 5 on 3d's model (at full width on the card:
    26 × 1,000,000 × 64 f32 tables): ``RECSYS_SHAPES["train_batch"]`` rows
    from ``dlrm_batch``.  Step 0's loss, MLP gradients and the gradient rows
    the batch names against the CPU port fed only those rows; every other
    row's gradient exactly 0; the gradients bitwise equal across two calls;
    one ``sparse_table_update`` against ``dense_rowwise_update``; then 3
    dense AdamW steps (written into ``params``)."""
    import torch

    from repro_torch.configs.common import RECSYS_SHAPES
    from repro_torch.data import dlrm_batch
    from repro_torch.kernels.embedding_bag import ops as eb_ops
    from repro_torch.kernels.seg_mm import ops as sm_ops
    from repro_torch.launch.train import make_train_step
    from repro_torch.models import dlrm
    from repro_torch.optim import AdamWConfig, init_state
    from repro_torch.optim.sparse_tables import (dense_rowwise_update, init_rowwise_state,
                                                 sparse_table_update)

    t_phase = time.perf_counter()
    rows = RECSYS_SHAPES["train_batch"]["batch"]
    tables = params["tables"]
    f, v, d = tables.shape
    out = {"config": cfg.name, "rows": rows, "vocab": v}
    if device == "cuda":
        torch.cuda.reset_peak_memory_stats()

    def host_batch(step):
        return dlrm_batch(step, batch=rows, vocab=cfg.vocab_size, seed=seed + 40, device="cpu")

    def batch_fn(step):  # requests arrive from the host
        return {k: t.to(device) for k, t in host_batch(step).items()}

    def loss(p, b):
        return dlrm.loss_fn(p, b["dense"], b["sparse"], b["labels"], cfg)

    eb_ops.reset_launches()
    sm_ops.reset_launches()
    hb = host_batch(0)
    b = {k: t.to(device) for k, t in hb.items()}
    t0 = time.perf_counter()
    card_loss, grads = grads_of(loss, params, b)
    sync()
    out["grad_ms"] = (time.perf_counter() - t0) * 1e3
    if device == "cuda":  # B4's backward on B5 sums in one order (the CPU's plain one need not)
        _, again = grads_of(loss, params, b)
        check(all(torch.equal(g, again[k]) for k, g in grads.items()),
              "3j DLRM: the step's gradients are bitwise equal across two calls")
        del again
    # against the CPU port fed only the rows the batch names (3d's held_rows)
    held, local = held_rows(tables, b["sparse"])
    cpu_loss, cpu_grads = grads_of(loss, cpu_params(params, held),
                                   {"dense": hb["dense"], "sparse": local, "labels": hb["labels"]})
    errs = [check_close(card_loss, cpu_loss, TRAIN_TOL, "3j DLRM step-0 loss")]
    errs += [check_close(g, cpu_grads[k], TRAIN_TOL, f"3j DLRM step-0 gradient {k}")
             for k, g in grads.items() if k != "tables"]
    touched = torch.zeros((f, v), dtype=torch.bool, device=tables.device)
    for j in range(f):
        named = torch.unique(b["sparse"][:, j]).to(torch.int64)
        touched[j, named] = True
        errs.append(check_close(grads["tables"][j, named], cpu_grads["tables"][j, :len(named)],
                                TRAIN_TOL, f"3j DLRM step-0 gradient of table {j}'s named rows"))
    check(not bool(((grads["tables"] != 0).any(dim=-1) & ~touched).any()),
          "3j DLRM: every row the batch does not name has gradient exactly 0")
    out["step0"] = {"loss": float(card_loss), "max_abs_err": max(errs),
                    "rows_named": int(touched.sum())}

    # one sparse rowwise update against the dense one on the same gradient
    captured = {}
    lookup = dlrm._embedding_bag

    def leaf_bags(t, idx, c):  # the bags as a leaf: their gradient is what the sparse update pulls
        captured["bags"] = lookup(t, idx, c).detach().requires_grad_(True)
        return captured["bags"]

    dlrm._embedding_bag = leaf_bags
    try:
        (g_bags,) = torch.autograd.grad(loss(params, b), captured["bags"])
    finally:
        dlrm._embedding_bag = lookup
    mh = b["sparse"].shape[2]
    pulled = (g_bags.unsqueeze(2).expand(-1, -1, mh, -1)
              / torch.full((), float(mh), device=g_bags.device))
    acc = init_rowwise_state(tables)
    t0 = time.perf_counter()
    t_sp, a_sp = sparse_table_update(tables, acc, b["sparse"], pulled, lr=SPARSE_LR)
    sync()
    t1 = time.perf_counter()
    t_dn, a_dn = dense_rowwise_update(tables, acc, grads["tables"], lr=SPARSE_LR)
    sync()
    t2 = time.perf_counter()
    for what, t_new, a_new in (("sparse", t_sp, a_sp), ("dense", t_dn, a_dn)):
        check(not bool(((t_new != tables).any(dim=-1) & ~touched).any())
              and not bool(((a_new != 0) & ~touched).any()),
              f"3j DLRM: the {what} update leaves every untouched row bitwise unchanged")
    err_t = float((t_sp - t_dn).abs().max())
    err_a = float((a_sp - a_dn).abs().max())
    check(err_t <= SPARSE_UPDATE_TOL and err_a <= SPARSE_UPDATE_TOL,
          f"3j DLRM: sparse and dense updates within {SPARSE_UPDATE_TOL} on touched rows "
          f"(tables {err_t}, accumulators {err_a})")
    out["sparse_update"] = {"sparse_ms": (t1 - t0) * 1e3, "dense_ms": (t2 - t1) * 1e3,
                            "max_abs_err_tables": err_t, "max_abs_err_acc": err_a}
    del t_sp, a_sp, t_dn, a_dn, acc, pulled, g_bags, grads, cpu_grads, held

    # 3 dense AdamW steps, written into ``params`` (the reference's jit donates them)
    step_fn = make_train_step(loss, batch_fn, AdamWConfig(**DLRM_TRAIN_OPT), sync=sync)
    state, logs = (params, init_state(params)), []
    for step in range(DLRM_TRAIN_STEPS):
        state, m = step_fn(state, step)
        logs.append({"loss": float(m["loss"]), "grad_norm": float(m["grad_norm"]), **m["ms"]})
    check(all(np.isfinite(x["loss"]) for x in logs), "3j DLRM: finite losses")
    del state
    out["steps"] = logs
    out["step_ms"] = {k: statistics.median(x[k] for x in logs[1:])
                      for k in ("batch", "forward", "backward", "update")}
    out["launches"] = {"b4": eb_ops.launches[eb_ops.EMBEDDING_BAG],
                       "b4_backward": eb_ops.launches[eb_ops.EMBEDDING_BAG_BACKWARD],
                       "b5": sm_ops.launches[sm_ops.SEG_MM]}
    if device == "cuda":
        calls = DLRM_TRAIN_STEPS + 3  # the steps, two gradient calls and the bags' gradient
        check(out["launches"]["b4"] >= calls and out["launches"]["b4_backward"]
              >= DLRM_TRAIN_STEPS + 2, f"3j DLRM: B4 forward and backward launched on every "
                                       f"step: {out['launches']}")
        out["peak_mem_gib"] = torch.cuda.max_memory_allocated() / 2**30
        torch.cuda.empty_cache()
    out["phase_s"] = time.perf_counter() - t_phase
    return out


def train_cli_phase(device: str) -> dict:
    """Phase 3j (c) and 3k (iv): ``python -m repro_torch.launch.train`` for
    GCN, DLRM and Gemma-2 (smoke configs; 12 steps, checkpoints every 4, a
    failure at 6) as subprocesses on ``device``; each must exit 0 and print
    ``done``."""
    out = {}
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src") + os.pathsep
           + os.environ.get("PYTHONPATH", "")}
    for arch in ("gcn-cora", "dlrm-rm2", "gemma2-9b"):
        ckpt_dir = tempfile.mkdtemp(prefix="chip_smoke_train_")
        t0 = time.perf_counter()
        try:
            proc = subprocess.run([sys.executable, "-m", "repro_torch.launch.train", "--arch", arch,
                                   "--steps", "12", "--ckpt-every", "4", "--fail-at", "6",
                                   "--ckpt-dir", ckpt_dir, "--device", device],
                                  capture_output=True, text=True, env=env, cwd=ROOT,
                                  timeout=TRAIN_CLI_TIMEOUT)
        finally:
            shutil.rmtree(ckpt_dir, ignore_errors=True)
        lines = proc.stdout.strip().splitlines()
        check(proc.returncode == 0 and lines and lines[-1].startswith("done"),
              f"3j train --arch {arch} exits 0 with 'done': rc {proc.returncode}\n"
              f"{proc.stdout[-2000:]}\n{proc.stderr[-4000:]}")
        out[arch] = {"s": time.perf_counter() - t0, "done": lines[-1]}
    return out


def train_lm_phase(seed: int, device: str, sync) -> dict:
    """Phase 3k (module docstring): Gemma-2-9B training at its published
    widths on the card (on the CPU, a rehearsal: the smoke config at short
    lengths).  (i) two layers in f32 at ``LM_CHECK_SEQ`` tokens: step 0's
    loss and every gradient with B6 forward and backward against the same
    under ``plain_attention("chunked")``; (ii) ``LM_TRAIN_LAYERS`` layers in
    bf16 at train_4k's 4,096 tokens, with ``remat`` on and off: step 0's
    loss and gradients equal bit for bit under both, then
    ``LM_TRAIN_STEPS`` AdamW steps on one batch (split batch, forward,
    backward, update), whose loss must fall, and each run's peak memory;
    (iii) ``examples/train_lm_torch.py`` as a subprocess (a failure mid-run,
    the restart bitwise the unbroken run, ``OK``).  Returns the results and
    the B6 launches of (ii), the training path, by kernel (the forward's by
    layer kind); (i)'s launches, made to compare B6 with the plain path, are
    kept apart under ``grad_check``."""
    import torch

    from repro_torch.configs import gemma2_9b
    from repro_torch.configs.common import LM_SHAPES
    from repro_torch.data import lm_batch
    from repro_torch.kernels.flash_attention import ops
    from repro_torch.launch.train import make_train_step
    from repro_torch.models import transformer as T
    from repro_torch.optim import AdamWConfig, init_state

    t_phase = time.perf_counter()
    full = device == "cuda"
    train_4k = LM_SHAPES["train_4k"]
    base = (gemma2_9b.full_config() if full else
            dataclasses.replace(gemma2_9b.smoke_config(), dtype=torch.bfloat16,
                                attn_impl="auto"))
    out = {"config": base.name, "seq": train_4k["seq_len"] if full else 48,
           "reduced": {"n_layers": f"{base.n_layers} -> {LM_TRAIN_LAYERS}",
                       "batch": f"{train_4k['global_batch']} -> 1"}}
    kernels = {**ops.COUNTERS, **ops.BWD_COUNTERS}
    launches = {"sm90": {"local": 0, "global": 0}, "bwd_sm90": 0}  # (ii)'s, the training path

    def launched():  # B6 launches by kernel since the last call
        n = {name: ops.launches[counter] for name, counter in kernels.items()}
        ops.reset_launches()
        return n

    def only(n, **want):  # exactly these kernels launched, these many times
        return n == {name: want.get(name, 0) for name in kernels}

    def peak_gib():
        return torch.cuda.max_memory_allocated() / 2**30 if full else None

    def fresh_peak():
        if full:
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()

    # (i) two full-width layers in f32 past the window: B6 against the plain chunked path
    cfg2 = dataclasses.replace(base, n_layers=2, dtype=torch.float32)
    seq2 = LM_CHECK_SEQ if full else 40
    fresh_peak()
    p2 = T.init_params(torch.Generator(device=device).manual_seed(seed + 12), cfg2,
                       device=device)
    b2 = lm_batch(0, batch=1, seq=seq2, vocab=cfg2.vocab, seed=seed + 12, device=device)

    def loss2(p, b):
        return T.loss_fn(p, b["tokens"], b["labels"], cfg2)

    ops.reset_launches()
    got_l, got = grads_of(loss2, p2, b2)
    n_check = launched()
    with plain_attention("chunked"):
        want_l, want = grads_of(loss2, p2, b2)
    check(only(launched()), "3k (i): the plain attention path launches no B6")
    if full:  # remat: each layer's forward twice (the recompute), its backward once
        check(only(n_check, simt=2 * cfg2.n_layers, bwd_simt=cfg2.n_layers),
              f"3k (i): B6 launched {n_check} for 2 f32 layers")
    check(bool(torch.isclose(got_l, want_l, rtol=LM_GRAD_TOL, atol=0)),
          f"3k (i): step-0 loss {float(got_l)} against the plain path's {float(want_l)}")
    shares = {}
    for name, w in want.items():
        ok, shares[name] = grads_within(got[name], w, LM_GRAD_TOL)
        check(ok, f"3k (i): gradient {name} within {LM_GRAD_TOL} of the plain path's "
                  f"(share {shares[name]:.3g})")
    worst = max(shares, key=shares.get)
    out["grad_check"] = {"seq": seq2, "n_layers": 2, "dtype": "float32",
                         "loss": float(got_l), "loss_plain": float(want_l),
                         "largest_share": shares[worst], "largest_share_leaf": worst,
                         "b6_launches": n_check, "peak_gib": peak_gib()}
    del p2, b2, got, want

    # (ii) LM_TRAIN_LAYERS bf16 layers at train_4k's length, remat on and off
    cfg8 = dataclasses.replace(base, n_layers=LM_TRAIN_LAYERS)

    def book(n, by_layer, remat, passes, what):  # (ii)'s launches onto the training path's
        if full:  # remat: each layer's forward twice (the recompute), its backward once
            fwd, bwd = (2 if remat else 1) * cfg8.n_layers * passes, cfg8.n_layers * passes
            check(only(n, sm90=fwd, bwd_sm90=bwd) and sum(by_layer.values()) == fwd,
                  f"3k (ii) remat={remat}, {what}: B6 launched {n} (calls by layer "
                  f"{dict(by_layer)}); want {fwd} sm90 and {bwd} bwd_sm90")
        for kind, calls in by_layer.items():
            launches["sm90"][kind] += calls
        launches["bwd_sm90"] += n["bwd_sm90"]

    batch = lm_batch(0, batch=1, seq=out["seq"], vocab=cfg8.vocab, seed=seed + 13,
                     device=device)
    runs, first = {}, None
    for remat in (True, False):
        cfg = dataclasses.replace(cfg8, remat=remat)

        def loss(p, b, cfg=cfg):
            return T.loss_fn(p, b["tokens"], b["labels"], cfg)

        fresh_peak()
        params = T.init_params(torch.Generator(device=device).manual_seed(seed + 13), cfg,
                               device=device)
        ops.reset_launches()
        t0 = time.perf_counter()
        with counting_flash() as (_, by_layer):
            l0, g0 = grads_of(loss, params, batch)
            sync()
        grad_ms = (time.perf_counter() - t0) * 1e3
        n = launched()
        book(n, by_layer, remat, 1, "step 0's gradient")
        run = {"grad_ms": grad_ms, "grad_peak_gib": peak_gib(), "b6_launches": n,
               "b6_launches_by_layer": dict(by_layer), "loss0": float(l0)}
        if first is None:
            first = (l0, g0)
        else:
            check(bool(l0.equal(first[0])) and all(g0[k].equal(first[1][k]) for k in g0),
                  "3k (ii): step 0's loss and gradients equal bit for bit with remat on and off")
            first = None
        del g0
        step_fn = make_train_step(loss, lambda step: batch, AdamWConfig(**LM_TRAIN_OPT),
                                  sync=sync)
        state = (params, init_state(params))
        del params
        logs = []
        with counting_flash() as (_, by_layer):
            for step in range(LM_TRAIN_STEPS):
                state, m = step_fn(state, step)
                logs.append({"loss": float(m["loss"]), "grad_norm": float(m["grad_norm"]),
                             **m.get("ms", {})})
        del state
        n = launched()
        book(n, by_layer, remat, LM_TRAIN_STEPS, "the steps")
        check(all(np.isfinite(x["loss"]) for x in logs) and logs[-1]["loss"] < logs[0]["loss"],
              f"3k (ii) remat={remat}: the loss falls on a fixed batch: "
              f"{[x['loss'] for x in logs]}")
        run.update({"steps": logs, "peak_gib": peak_gib(), "step_b6_launches": n,
                    "step_b6_launches_by_layer": dict(by_layer)})
        if full:
            run["step_ms"] = {k: statistics.median(x[k] for x in logs[1:])
                              for k in ("batch", "forward", "backward", "update")}
        runs["remat" if remat else "no_remat"] = run
    out["steps"] = runs
    fresh_peak()

    # (iii) the example: a failure mid-run, the restart bitwise the unbroken run
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src") + os.pathsep
           + os.environ.get("PYTHONPATH", "")}
    args = LM_EXAMPLE_ARGS if full else ("--steps", "3", "--ckpt-every", "2", "--check-restart")
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, str(ROOT / "examples" / "train_lm_torch.py"), *args,
                           "--device", device], capture_output=True, text=True, env=env,
                          cwd=ROOT, timeout=TRAIN_CLI_TIMEOUT)
    lines = proc.stdout.strip().splitlines()
    check(proc.returncode == 0 and lines and lines[-1] == "OK"
          and any(x.startswith("restart: bitwise") for x in lines),
          f"3k (iii) examples/train_lm_torch.py exits 0 with a bitwise restart and 'OK': rc "
          f"{proc.returncode}\n{proc.stdout[-2000:]}\n{proc.stderr[-4000:]}")
    out["example"] = {"s": time.perf_counter() - t0, "args": list(args), "lines": lines[-5:]}
    out["launches"] = launches
    out["phase_s"] = time.perf_counter() - t_phase
    return out


def train_backward_checks(device) -> None:
    """Phase 2's backward passes: B5ᵀ (``seg_mm``'s backward) against the
    plain version's autograd over ragged shapes with src ids outside
    [-N, N), dst outside [0, n), a node count unlike N_src, empty rows and a
    hub, weighted and not; B4's backward (on B5) against the plain
    version's over ragged shapes with ids outside [-V, V) and MH = 0, in f32
    and bf16 (held to the f32 plain backward cast to bf16).  Sums within
    ``SUM_RTOL`` of Σ|terms|, and bitwise run to run."""
    import torch

    from repro_torch.kernels.embedding_bag import ops as eb_ops
    from repro_torch.kernels.embedding_bag import ref as eb_ref
    from repro_torch.kernels.seg_mm import ops, ref

    gen = torch.Generator(device="cpu").manual_seed(4)

    def grad_x(fn, x, cot):
        xg = x.detach().requires_grad_(True)
        (g,) = torch.autograd.grad(fn(xg), xg, cot)
        return g

    for d in (1, 7, 16, 64):
        for n_src, n, e in ((1, 1, 3), (37, 23, 91), (5000, 3000, 40_000),
                            (20_000, 20_000, 60_000)):
            src = torch.randint(-n_src - 3, n_src + 3, (e,), dtype=torch.int32, generator=gen)
            dst = torch.randint(-2, n + 2, (e,), dtype=torch.int32, generator=gen)
            if n_src >= 5000:
                src[: e // 4] = 3  # a hub source of degree >= 10,000
            x = torch.randn((n_src, d), generator=gen)
            cot = torch.randn((n, d), generator=gen)
            w = torch.rand(e, generator=gen)
            x, src, dst, cot, w = (t.to(device) for t in (x, src, dst, cot, w))
            for ew in (None, w):
                got = grad_x(lambda t: ops.seg_mm(t, src, dst, n, edge_weight=ew), x, cot)
                want = grad_x(lambda t: ref.seg_mm_ref(t, src, dst, n, edge_weight=ew), x, cot)
                scale = grad_x(lambda t: ref.seg_mm_ref(
                    t, src, dst, n, edge_weight=None if ew is None else ew.abs()), x, cot.abs())
                what = f"B5ᵀ D={d} N_src={n_src} n={n} E={e} weighted={ew is not None}"
                check(sums_close(got, want, scale), what)
                check(got.equal(grad_x(lambda t: ops.seg_mm(t, src, dst, n, edge_weight=ew),
                                       x, cot)), what + " run to run")
    for b, f, mh, v, d in ((8, 4, 3, 100, 16), (16, 26, 1, 500, 64), (37, 5, 2, 40, 7),
                           (512, 26, 1, 100_000, 64), (4, 2, 0, 10, 8), (0, 26, 1, 10, 64)):
        tables = torch.randn((f, v, d), generator=gen)
        idx = torch.randint(-v - 3, v + 3, (b, f, mh), dtype=torch.int32, generator=gen)
        cot = torch.randn((b, f, d), generator=gen)
        tables, idx, cot = (t.to(device) for t in (tables, idx, cot))
        plain = eb_ref.embedding_bag_ref(tables.requires_grad_(True), idx)
        want = (torch.autograd.grad(plain, tables, cot)[0] if plain.requires_grad
                else torch.zeros_like(tables))
        scale = (torch.autograd.grad(eb_ref.embedding_bag_ref(tables, idx), tables, cot.abs())[0]
                 if plain.requires_grad else torch.zeros_like(tables))
        tables = tables.detach()
        for dtype in (torch.float32, torch.bfloat16):
            t = tables.to(dtype).requires_grad_(True)
            what = f"B4 backward B={b} F={f} MH={mh} V={v} D={d} {dtype}"
            got = torch.autograd.grad(eb_ops.embedding_bag_fields(t, idx), t, cot.to(dtype))[0]
            again = torch.autograd.grad(eb_ops.embedding_bag_fields(t, idx), t, cot.to(dtype))[0]
            check(got.dtype == dtype and got.equal(again), what + " run to run")
            if dtype == torch.float32:
                check(sums_close(got, want, scale), what)
            else:  # f32 sums of the bf16 cotangent, cast once: within a bf16 rounding
                t32 = tables.clone().requires_grad_(True)
                plain = eb_ref.embedding_bag_ref(t32, idx)
                want16 = (torch.autograd.grad(plain, t32, cot.to(dtype).float())[0]
                          if plain.requires_grad else torch.zeros_like(tables))
                check(bool(((got.float() - want16).abs()
                            <= 2.0**-8 * want16.abs() + SUM_RTOL * scale + 1e-6).all()), what)


# ------------------------------------------------------------ LM serving
@contextlib.contextmanager
def plain_attention(path: str):
    """Inside the block the transformer's prefill attention runs the
    port's plain ``_chunked`` (or ``_direct``) path on the card instead of
    B6: a check, not a path of the package."""
    from repro_torch.models import transformer
    from repro_torch.nn import attention as attn

    saved = transformer.attention

    def attention(q, k, v, *, causal, window, cap, impl, chunk):
        del impl
        if path == "chunked":
            return attn._chunked(q, k, v, causal=causal, window=window, cap=cap, q_offset=0,
                                 chunk=min(chunk, k.shape[1]))
        return attn._direct(q, k, v, causal=causal, window=window, cap=cap, q_offset=0)

    transformer.attention = attention
    try:
        yield
    finally:
        transformer.attention = saved


@contextlib.contextmanager
def checking_flash(errs: list):
    """Every B6 call inside the block is held, on its own inputs, to the
    port's plain chunked attention on the card at ``B6_TOL``; ``errs``
    gets each call's largest difference."""
    from repro_torch.kernels.flash_attention import ops
    from repro_torch.nn import attention as attn

    saved = ops.flash_attention

    def flash_attention(q, k, v, **kw):
        o = saved(q, k, v, **kw)
        want = attn._chunked(q, k, v, causal=kw["causal"], window=kw["window"], cap=kw["cap"],
                             q_offset=kw["q_offset"])
        errs.append(attention_close(o, want, f"B6 layer {len(errs)} against chunked"))
        return o

    ops.flash_attention = flash_attention
    try:
        yield
    finally:
        ops.flash_attention = saved


@contextlib.contextmanager
def counting_flash(limit: int = 0):
    """Count the B6 calls inside the block by layer kind (a call with a
    window is a local layer's) and record the inputs (q, k, v, keyword
    arguments) of the first ``limit``."""
    from repro_torch.kernels.flash_attention import ops

    calls, by_layer = [], {"local": 0, "global": 0}
    saved = ops.flash_attention

    def flash_attention(q, k, v, **kw):
        by_layer["local" if kw["window"] is not None else "global"] += 1
        if len(calls) < limit:
            calls.append((q, k, v, kw))
        return saved(q, k, v, **kw)

    ops.flash_attention = flash_attention
    try:
        yield calls, by_layer
    finally:
        ops.flash_attention = saved


def moved(tree, device):
    """A params tree (dicts and lists of tensors) on ``device``."""
    if isinstance(tree, dict):
        return {k: moved(v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [moved(v, device) for v in tree]
    return tree.to(device)


def lm_phase(seed: int, device: str, sync) -> dict:
    """Phase 3e (module docstring).  Returns per-kind results and the first
    two B6 calls of ``prefill_8k`` (a local and a global layer) for
    phase 5."""
    import torch

    from repro_torch.configs import gemma2_9b
    from repro_torch.data import lm_batch
    from repro_torch.kernels.flash_attention import ops
    from repro_torch.launch import serve
    from repro_torch.models import transformer as T

    full = device == "cuda"
    # on the CPU (a rehearsal) the smoke config in bf16 at short lengths
    cfg = (gemma2_9b.full_config() if full else
           dataclasses.replace(gemma2_9b.smoke_config(), dtype=torch.bfloat16, attn_impl="auto"))
    shapes = LM_REQUESTS if full else {"prefill_8k": (1, 64), "prefill_batch": (2, 32)}
    out = {"config": cfg.name, "n_params": cfg.n_params, "n_layers": cfg.n_layers,
           "reduced": {"batch": "32 -> 1", "seq": "32,768 -> 8,192"}}
    if full:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    gen = torch.Generator(device=device).manual_seed(seed + 9)
    t0 = time.perf_counter()
    params = T.init_params(gen, cfg, device=device)
    sync()
    out["init_s"] = time.perf_counter() - t0
    out["weights_gb"] = sum(t.numel() * t.element_size() for _, t in T._flatten(params, "")) / 1e9

    def request(tokens):  # a prompt batch from the host, the last logits back to it
        t0 = time.perf_counter()
        with torch.inference_mode():
            lg = T.prefill(params, tokens.to(device), cfg).cpu()
        sync()
        return lg, (time.perf_counter() - t0) * 1e3

    def launched() -> int:  # B6 launches since the last call
        n = ops.launches[ops.FLASH_ATTENTION]
        ops.reset_launches()
        return n

    batches, b6_calls = {}, []
    ops.reset_launches()
    for step, (kind, (b, s)) in enumerate(shapes.items()):
        toks = lm_batch(step, batch=b, seq=s, vocab=cfg.vocab, seed=seed, device="cpu")["tokens"]
        batches[kind] = toks
        # a warm run (for prefill_8k it records a local and a global layer's B6 inputs),
        # then 3 timed ones
        with counting_flash(2 if kind == "prefill_8k" else 0) as (calls, by_layer):
            runs = [request(toks) for _ in range(4)]
        n_sm90 = ops.launches[ops.COUNTERS["sm90"]]
        n = launched()
        check(sum(by_layer.values()) == n, f"{kind}: B6 launches {n} = calls by layer {by_layer}")
        if kind == "prefill_8k":
            b6_calls = calls
        if full:
            check(n == len(runs) * cfg.n_layers,
                  f"{kind}: B6 launched {n} times for {len(runs)} requests of "
                  f"{cfg.n_layers} layers")
            check(n_sm90 == n, f"{kind}: {n_sm90} of {n} B6 launches on the wgmma/TMA kernel")
        lg = runs[-1][0]
        check(lg.shape == (b, 1, cfg.vocab) and bool(torch.isfinite(lg.float()).all()),
              f"{kind}: logits shape and finite")
        med = statistics.median(ms for _, ms in runs[1:])
        out[kind] = {"median_ms": med, "runs_ms": [ms for _, ms in runs[1:]], "batch": b,
                     "seq": s, "tokens_per_s": b * s / med * 1e3, "b6_launches": n,
                     "b6_sm90_launches": n_sm90,
                     "b6_launches_by_layer": dict(by_layer), "b6_per_request": n // len(runs)}
    if full:  # on the CPU attention takes the reference's plain branch: no B6 call
        check(len(b6_calls) == 2 and b6_calls[0][3]["window"] == cfg.window
              and b6_calls[1][3]["window"] is None, "recorded a local and a global layer's B6 call")
        out["prefill_8k"]["profile"] = sample_profile(lambda: request(batches["prefill_8k"]))
        ops.reset_launches()

    # (b) full depth, bf16: every layer's B6 output against the plain chunked path on
    # that layer's inputs; the logits against a prefill on the plain path, reported
    # (bf16 rounding differences grow with depth to the logits' scale: PERF.md, PR 15)
    t8k = batches["prefill_8k"].to(device)
    layer_errs = []
    with torch.inference_mode():
        with checking_flash(layer_errs):
            lg = T.prefill(params, t8k, cfg).float()
        b6_in_check = launched()
        with plain_attention("chunked"):
            lg_chunked = T.prefill(params, t8k, cfg).float()
        check(launched() == 0, "the plain attention path launches no B6")
    if full:
        check(len(layer_errs) == cfg.n_layers, f"{len(layer_errs)} of {cfg.n_layers} layers held")
    check(bool(torch.isfinite(lg_chunked).all()), "plain logits finite")
    out["check_b"] = {"layer_max_abs_err": max(layer_errs, default=0.0),
                      "layer_errs": layer_errs, "b6_launches": b6_in_check,
                      "bf16_logits_max_abs_err": float((lg - lg_chunked).abs().max()),
                      "bf16_logit_absmax": float(lg.abs().max()),
                      "greedy_b6": lg.argmax(-1).flatten().tolist(),
                      "greedy_chunked": lg_chunked.argmax(-1).flatten().tolist()}
    del lg, lg_chunked

    # generate: launch/serve.py at full width and depth, decode in plain torch
    res = serve.serve_demo(gemma2_9b.ARCH_ID, seed=seed, device=device, cfg=cfg, params=params,
                           **LM_GENERATE)
    n_dec = launched()
    check(n_dec == 0, f"decode attends in plain torch (B6 launched {n_dec} times)")
    check(bool(torch.isfinite(res["logits"].float()).all()), "decode logits finite")
    steps = res["step_ms"]
    out["generate"] = {"median_step_ms": statistics.median(steps[1:]), "steps": len(steps),
                       "first_step_ms": steps[0], **{k: v for k, v in LM_GENERATE.items()},
                       "tokens_per_s": LM_GENERATE["batch"] / statistics.median(steps[1:]) * 1e3,
                       "b6_launches": n_dec}
    out["peak_mem_gib_served"] = (torch.cuda.max_memory_allocated() / 2**30) if full else None
    del params, res

    # (c) full width, two layers (local, global), f32: the card against the CPU port;
    # (d) on the same model, decode's logits at every position against the forward's
    cfg2 = dataclasses.replace(cfg, n_layers=2, dtype=torch.float32)
    check(torch.backends.cuda.matmul.allow_tf32 is False, "TF32 is off for float32 matmuls")
    seq2 = LM_CHECK_SEQ if full else 40
    p2 = T.init_params(torch.Generator(device=device).manual_seed(seed + 10), cfg2, device=device)
    toks = lm_batch(99, batch=1, seq=seq2, vocab=cfg2.vocab, seed=seed, device="cpu")["tokens"]
    ops.reset_launches()
    with torch.inference_mode():
        got = T.prefill(p2, toks.to(device), cfg2).cpu()
        n = launched()
        res = serve.serve_demo(gemma2_9b.ARCH_ID, seed=seed, device=device, cfg=cfg2, params=p2,
                               **LM_GENERATE)
        check(launched() == 0, "f32 decode launches no B6")
        seq = torch.cat([res["prompts"], res["tokens"]], dim=1)
        h, _ = T.forward(p2, seq[:, :-1], cfg2)
        fwd = T._logits(p2, h, cfg2).cpu()
        n_fwd = launched()
        if full:
            check(n == 2 and n_fwd == 2, f"checks (c), (d): B6 launched {n}, {n_fwd} times "
                                         "for 2 layers")
        p2 = moved(p2, "cpu")
        t0 = time.perf_counter()
        want = T.prefill(p2, toks, cfg2)
    out["check_c"] = {"max_abs_err": check_close(got, want, LM_F32_TOL, "f32 two-layer logits"),
                      "share_of_tolerance": tolerance_share(got, want, LM_F32_TOL),
                      "seq": seq2, "cpu_s": time.perf_counter() - t0, "b6_launches": n}
    dec = res["logits"]
    err = check_close(dec, fwd, LM_F32_TOL, "f32 two-layer decode logits", "the forward's")
    p0 = LM_GENERATE["prompt_len"] - 1
    top2 = torch.topk(fwd[:, p0:], 2, dim=-1).values
    # each side is within the tolerance of the other: a pick may differ only where
    # the forward's two best logits lie within twice the tolerance
    near = (top2[..., 0] - top2[..., 1]) <= 2 * LM_F32_TOL * (1 + top2[..., 0].abs())
    differ = fwd[:, p0:].argmax(-1) != res["tokens"].cpu().to(torch.int64)
    check(not bool((differ & ~near).any()),
          "generate: greedy tokens equal the forward's outside near-ties")
    out["check_d"] = {"max_abs_err": err,
                      "share_of_tolerance": tolerance_share(dec.cpu(), fwd, LM_F32_TOL),
                      "positions": int(dec.shape[1]), "greedy_tokens": int(differ.numel()),
                      "near_ties": int(near.sum()), "tokens_differing": int(differ.sum()),
                      "b6_launches_forward": n_fwd}
    del p2, res, dec, fwd

    # (b) full depth in f32 at LM_CHECK_SEQ tokens: B6's logits against the plain chunked
    # path's, the plain direct path's against them too, and the window turned off must fail
    cfg32 = dataclasses.replace(cfg, dtype=torch.float32)
    p32 = T.init_params(torch.Generator(device=device).manual_seed(seed + 11), cfg32,
                        device=device)
    t32 = toks.to(device)
    with torch.inference_mode():
        lg = T.prefill(p32, t32, cfg32).float()
        n = launched()
        with plain_attention("chunked"):
            lg_chunked = T.prefill(p32, t32, cfg32).float()
        with plain_attention("direct"):
            lg_direct = T.prefill(p32, t32, cfg32).float()
        check(launched() == 0, "the plain attention paths launch no B6")
        lg_nowin = T.prefill(p32, t32, dataclasses.replace(cfg32, window=None)).float()
        ops.reset_launches()
    if full:
        check(n == cfg.n_layers, f"check (b) f32: B6 launched {n} times")

    def depth_within(a, b) -> bool:
        return bool(torch.allclose(a, b, rtol=LM_DEPTH_TOL, atol=LM_DEPTH_TOL))

    check(bool(torch.isfinite(lg).all()), "f32 full-depth logits finite")
    check(depth_within(lg, lg_chunked), "f32 full depth: B6 logits within "
          f"{LM_DEPTH_TOL} of the chunked path's")
    check(depth_within(lg_direct, lg_chunked), "f32 full depth: the direct path's logits within "
          f"{LM_DEPTH_TOL} of the chunked path's")
    check(not depth_within(lg_nowin, lg_chunked), "f32 full depth: the check fails the logits "
          "of the model with its window off")
    out["check_b"]["f32"] = {"seq": seq2, "b6_launches": n, "logit_absmax": float(lg.abs().max()),
                             "b6_vs_chunked": float((lg - lg_chunked).abs().max()),
                             "direct_vs_chunked": float((lg_direct - lg_chunked).abs().max()),
                             "window_off_vs_chunked": float((lg_nowin - lg_chunked).abs().max()),
                             "share_of_tolerance": {
                                 name: tolerance_share(a, lg_chunked, LM_DEPTH_TOL)
                                 for name, a in (("b6", lg), ("direct", lg_direct),
                                                 ("window_off", lg_nowin))},
                             "greedy_b6": lg.argmax(-1).flatten().tolist(),
                             "greedy_chunked": lg_chunked.argmax(-1).flatten().tolist()}
    del p32, lg, lg_chunked, lg_direct, lg_nowin
    if full:
        out["peak_mem_gib"] = torch.cuda.max_memory_allocated() / 2**30
    out["b6_calls"] = b6_calls
    return out


def attention_pairs(sq: int, skv: int, *, causal: bool = True, window=None, cap=None,
                    q_offset: int = 0) -> int:
    """The (q, k) pairs the masks keep, per batch row and head."""
    del cap
    i = np.arange(sq, dtype=np.int64) + q_offset
    hi = np.minimum(skv - 1, i) if causal else np.full(sq, skv - 1)
    lo = np.maximum(0, i - window + 1) if window is not None else np.zeros(sq, np.int64)
    return int(np.maximum(hi - lo + 1, 0).sum())


def flash_attention_entry(name: str, call, launches: int) -> dict:
    """Phase 5's B6 line for one recorded prefill call (q, k, v, keywords),
    on the kernel the main path ran (``kernel.variant``: the wgmma/TMA
    kernel at these shapes), with the mma.sync kernel it replaced timed
    beside it at the same shape (``ms_mma_sync_kernel``, launched by name;
    not counted).
    The bound counts what these masks keep: 4·D FLOP per kept (q, k) pair
    and query head (two products) at the dense bf16 rate, against q, k, v
    read once and o written once.  The yardsticks are
    ``scaled_dot_product_attention`` with GQA and a boolean mask of the
    same causal window (``library_ms``) and, on the global layer, with
    ``is_causal=True`` and no mask (``library_causal_ms``, which may take
    the flash backend), both without the softcap: not the same function,
    as no PyTorch call softcaps attention scores."""
    import torch

    from repro_torch.kernels.flash_attention import kernel, ops, ref

    q, k, v, kw = call
    b, sq, hq, d = q.shape
    skv = k.shape[1]
    which = kernel.variant(q, k, v)
    got = ops.flash_attention(q, k, v, **kw)
    want = ref.flash_attention_ref(q, k, v, **kw)
    err = attention_close(got, want, f"timed {name}")
    o_mma = torch.empty_like(q)

    def mma_sync():
        kernel.launch_flash_attention(q, k, v, o_mma, variant="mma", **kw)

    mma_sync()
    err_mma = attention_close(o_mma, want, f"timed {name} on the mma.sync kernel")
    del want
    pairs = attention_pairs(sq, skv, **kw)
    flops = 4 * d * hq * b * pairs
    moved_bytes = (2 * q.numel() + k.numel() + v.numel()) * q.element_size()
    rate = BF16_FLOP_PER_S if q.dtype == torch.bfloat16 else F32_FLOP_PER_S
    i = torch.arange(sq, device=q.device)[:, None] + kw.get("q_offset", 0)
    j = torch.arange(skv, device=q.device)[None, :]
    mask = i >= j
    if kw.get("window") is not None:
        mask &= (i - j) < kw["window"]
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))

    def library():
        return torch.nn.functional.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask,
                                                                enable_gqa=True)

    def library_causal():
        return torch.nn.functional.scaled_dot_product_attention(qt, kt, vt, is_causal=True,
                                                                enable_gqa=True)

    entry = {"name": name, "route": "cuda",
             "source": SOURCES["flash_attention_sm90" if which == "sm90" else "flash_attention"],
             "replaces": "src/repro/kernels/flash_attention/kernel.py:73", "kernel": which,
             "launches": launches, "max_abs_err": err,
             "ms": time_ms(lambda: ops.flash_attention(q, k, v, **kw), 10),
             "device_ms": kernel_device_ms(lambda: ops.flash_attention(q, k, v, **kw),
                                           f"flash_attention_{which}_kernel", 10)["ms"],
             "ms_with_lse": time_ms(lambda: ops._forward(q, k, v, kw, want_lse=True), 10),
             "ms_mma_sync_kernel": time_ms(mma_sync, 10), "mma_sync_kernel_max_abs_err": err_mma,
             "plain_ms": time_ms(lambda: ref.flash_attention_ref(q, k, v, **kw), 2),
             "bound_ms": max(flops / rate, moved_bytes / HBM_BYTES_PER_S) * 1e3,
             "bound_by": "operations" if flops / rate >= moved_bytes / HBM_BYTES_PER_S
             else "bytes",
             "library_ms": time_ms(library, 10),
             "library_note": "not the same function: no softcap",
             "library_causal_ms": (time_ms(library_causal, 10) if kw.get("window") is None
                                   and kw.get("q_offset", 0) == 0 and sq == skv else None),
             "library_causal_note": "not the same function: no softcap; is_causal, no mask",
             "shape": {"B": b, "Sq": sq, "Skv": skv, "Hq": hq, "Hkv": k.shape[2], "D": d,
                       "dtype": str(q.dtype), **{kk: vv for kk, vv in kw.items()},
                       "pairs": pairs, "flop": flops}}
    entry["tflop_per_s"] = flops / entry["ms"] / 1e9
    entry["tflop_per_s_mma_sync_kernel"] = flops / entry["ms_mma_sync_kernel"] / 1e9
    return entry


def flash_attention_bwd_entries(device) -> list:
    """Phase 5's lines for B6's backward at the LM's layer shapes, on seeded
    bf16 inputs (the work depends on shapes and masks alone): q (1, 8192,
    16, 256), k and v (1, 8192, 8, 256) as prefill_8k's layers (q and k
    entries of std 0.3, v of std 1); train_4k's layer is their first 4,096
    tokens (there the 4,096 window masks nothing), then prefill_8k's local
    (window 4,096) and global layers, cap 50."""
    import torch

    from repro_torch.configs.common import LM_SHAPES

    gen = torch.Generator(device=device).manual_seed(19)
    b, s, hq, hkv, d = LM_REQUESTS["prefill_8k"][0], LM_REQUESTS["prefill_8k"][1], 16, 8, 256
    q = (torch.randn((b, s, hq, d), generator=gen, device=device) * 0.3).to(torch.bfloat16)
    k = (torch.randn((b, s, hkv, d), generator=gen, device=device) * 0.3).to(torch.bfloat16)
    v = torch.randn((b, s, hkv, d), generator=gen, device=device).to(torch.bfloat16)
    local = dict(causal=True, window=4096, cap=50.0, q_offset=0)
    n = LM_SHAPES["train_4k"]["seq_len"]
    calls = (("train_4k layer", (q[:, :n], k[:, :n], v[:, :n], local)),
             ("prefill_8k local layer", (q, k, v, local)),
             ("prefill_8k global layer", (q, k, v, {**local, "window": None})))
    return [flash_attention_bwd_entry(f"flash_attention backward (B6) {what}", call)
            for what, call in calls]


def flash_attention_bwd_entry(name: str, call) -> dict:
    """Phase 5's line for B6's backward (``bwd_sm90``,
    ``flash_attention_bwd_sm90.cu``: Dᵢ, dK/dV and dQ, one launch call) at a
    call's (q, k, v, keywords) with a random bf16 cotangent, from the sm90
    forward's output and log-sum-exp; its ``launches`` are set where the
    training path's are read.  ``device_ms`` sums the three kernels' own
    time a call (``device_ms_by_kernel`` each).  ``flash_attention_bwd.cu``'s
    ``bwd_mma``, the kernel it replaced, is launched by name on the same
    inputs and timed beside it in turns (bwd_mma, bwd_sm90, bwd_sm90,
    bwd_mma; ``turns_ms``): ``earlier_ms`` its best turn, ``ms`` the new
    kernel's, ``earlier_share_of_tol`` its distance from the new kernel's
    gradients as a share of ``B6_GRAD_TOL``.  The
    bound counts what these masks keep: five products (S, dP, dV, dK, dQ)
    of 2·D FLOP per kept (q, k) pair and query head at the dense bf16
    rate, against q, k, v, o, dO read once and dq, dk, dv written once.  The plain version (``ref.flash_attention_bwd_ref``,
    f32) runs one KV head's group at a time: all heads' (Sq, Skv) f32
    intermediates at 8,192 tokens would take ~35 GB.  The yardstick is
    ``scaled_dot_product_attention``'s backward with GQA and a boolean mask
    of the same causal window (``library_ms``) and, where the window masks
    nothing, with ``is_causal=True`` (``library_causal_ms``, which may take
    the flash backend), both without the softcap: not the same function."""
    import torch

    from repro_torch.kernels.flash_attention import kernel, ops, ref

    q, k, v, kw = call
    kw = {**dict(window=None, cap=None, q_offset=0), **kw}
    b, sq, hq, d = q.shape
    skv, hkv = k.shape[1], k.shape[2]
    g = hq // hkv
    gen = torch.Generator(device=q.device).manual_seed(17)
    do = torch.randn(q.shape, generator=gen, device=q.device).to(q.dtype)
    o, lse, forward = ops._forward(q, k, v, kw, want_lse=True)
    dq, dk, dv = (torch.empty(t.shape, dtype=t.dtype, device=t.device) for t in (q, k, v))
    delta = torch.empty(lse.shape, dtype=torch.float32, device=q.device)
    which = kernel.bwd_variant(q, forward)
    check(which == "bwd_sm90", f"timed {name}: the backward after {forward} is {which}")
    old_grads = tuple(torch.empty(t.shape, dtype=t.dtype, device=t.device) for t in (q, k, v))
    old_delta = torch.empty(lse.shape, dtype=torch.float32, device=q.device)

    def backward():
        kernel.launch_flash_attention_bwd(q, k, v, o, lse, do, delta, dq, dk, dv, variant=which,
                                          forward=forward, **kw)

    def earlier():  # the kernel bwd_sm90 replaced, launched by name: not counted
        kernel.launch_flash_attention_bwd(q, k, v, o, lse, do, old_delta, *old_grads,
                                          variant="bwd_mma", forward=forward, **kw)

    backward()
    earlier()
    again = [t.clone() for t in (dq, dk, dv)]
    backward()
    check(all(a.equal(b_) for a, b_ in zip(again, (dq, dk, dv))),
          f"timed {name}: bwd_sm90 bitwise run to run")
    earlier_share = max(grads_within(a, b_.float(), B6_GRAD_TOL["bfloat16"])[1]
                        for a, b_ in zip(old_grads, (dq, dk, dv)))
    del again
    err = 0.0
    for h in range(hkv):  # the plain backward, one KV head's group at a time
        heads = slice(h * g, (h + 1) * g)
        qh, kh, vh, oh, doh = (t.float() for t in (q[:, :, heads], k[:, :, h:h + 1],
                                                   v[:, :, h:h + 1], o[:, :, heads],
                                                   do[:, :, heads]))
        want = ref.flash_attention_bwd_ref(qh, kh, vh, oh, lse[:, heads], doh, **kw)
        for got, w in zip((dq[:, :, heads], dk[:, :, h:h + 1], dv[:, :, h:h + 1]), want):
            ok, share = grads_within(got, w, B6_GRAD_TOL["bfloat16"])
            check(ok, f"timed {name}: KV head {h} within {B6_GRAD_TOL['bfloat16']} "
                      f"({share:.3g})")
            err = max(err, float((got.float() - w).abs().max()))
        del want

    def plain():
        for h in range(hkv):
            heads = slice(h * g, (h + 1) * g)
            ref.flash_attention_bwd_ref(*(t.float() for t in (
                q[:, :, heads], k[:, :, h:h + 1], v[:, :, h:h + 1], o[:, :, heads])),
                lse[:, heads], do[:, :, heads].float(), **kw)

    pairs = attention_pairs(sq, skv, **kw)
    flops = 10 * d * hq * b * pairs
    moved_bytes = 2 * (q.numel() + k.numel() + v.numel()) * q.element_size() \
        + 2 * q.numel() * q.element_size() + lse.numel() * 4
    i = torch.arange(sq, device=q.device)[:, None] + kw["q_offset"]
    j = torch.arange(skv, device=q.device)[None, :]
    mask = i >= j
    if kw["window"] is not None:
        mask &= (i - j) < kw["window"]
    qt, kt, vt = (t.transpose(1, 2).detach().requires_grad_(True) for t in (q, k, v))
    dot = do.transpose(1, 2)
    masks_nothing = kw["window"] is None or kw["window"] >= sq + kw["q_offset"]

    def library_backward(**opts):
        out = torch.nn.functional.scaled_dot_product_attention(qt, kt, vt, enable_gqa=True,
                                                               **opts)
        return lambda: torch.autograd.grad(out, (qt, kt, vt), dot, retain_graph=True)

    lib = library_backward(attn_mask=mask)
    lib_causal = (library_backward(is_causal=True) if masks_nothing and kw["q_offset"] == 0
                  and sq == skv else None)
    timing = kernel_device_ms(backward, "flash_attention_bwd", 10)
    turns = {"bwd_mma": [], "bwd_sm90": []}
    for kind in ("bwd_mma", "bwd_sm90", "bwd_sm90", "bwd_mma"):
        turns[kind].append(time_ms(earlier if kind == "bwd_mma" else backward, 5))
    entry = {"name": name, "route": "cuda",
             "source": "src/repro_torch/kernels/flash_attention/csrc/flash_attention_bwd_sm90.cu",
             "replaces": "src/repro/kernels/flash_attention/kernel.py:73",
             "replaces_note": "B6's backward: the reference differentiates B6's callers "
                              "(nn/attention.py _direct, _chunked) by XLA's autodiff; "
                              "flash_attention_pallas has no gradient",
             "kernel": which, "forward_kernel": forward, "max_abs_err": err,
             "ms": min(turns["bwd_sm90"]), "device_ms": timing["ms"],
             "device_ms_by_kernel": timing.get("by_kernel"),
             "earlier_ms": min(turns["bwd_mma"]), "earlier_kernel": "bwd_mma",
             "earlier_source": "src/repro_torch/kernels/flash_attention/csrc/"
                               "flash_attention_bwd.cu",
             "earlier_share_of_tol": earlier_share, "turns_ms": turns,
             "plain_ms": time_ms(plain, 1),
             "bound_ms": max(flops / BF16_FLOP_PER_S, moved_bytes / HBM_BYTES_PER_S) * 1e3,
             "bound_by": "operations" if flops / BF16_FLOP_PER_S >= moved_bytes / HBM_BYTES_PER_S
             else "bytes",
             "library_ms": time_ms(lib, 5),
             "library_note": "not the same function: SDPA's backward, no softcap",
             "library_causal_ms": time_ms(lib_causal, 5) if lib_causal else None,
             "library_causal_note": "not the same function: no softcap; is_causal, no mask",
             "shape": {"B": b, "Sq": sq, "Skv": skv, "Hq": hq, "Hkv": hkv, "D": d,
                       "dtype": str(q.dtype), **kw, "pairs": pairs, "flop": flops}}
    entry["tflop_per_s"] = flops / entry["device_ms"] / 1e9
    return entry


def embedding_bag_entry(name: str, tables, idxs, launches: int) -> dict:
    """Phase 5's B4 line at one request kind's shape, timed over that
    kind's batches in turn (``idxs``: 16 serve_p99 batches, about 54 MB of
    rows, past the 50 MB L2; one serve_bulk batch, 1.5 GB).  The bound
    counts what a batch needs: each distinct (field, row) it names read
    once, its indices, its output written once (mean over ``idxs``).
    The yardstick is ``F.embedding_bag`` over the flattened table stack.
    ``device_ms`` beside ``ms``: the kernel's own time per launch, which at
    serve_p99 is shorter than the host's time to launch it."""
    import itertools

    import torch

    from repro_torch.kernels.embedding_bag import ops, ref

    f, v, d = tables.shape
    esize = tables.element_size()
    field = torch.arange(f, device=tables.device).view(1, f, 1) * v
    flat = [(idx.to(torch.int64) + field).view(-1, idx.shape[2]) for idx in idxs]
    needed = statistics.mean(torch.unique(x).numel() * d * esize + idx.numel() * 4
                             + idx.shape[0] * f * d * esize for x, idx in zip(flat, idxs))
    got = ops.embedding_bag_fields(tables, idxs[0])
    want = ref.embedding_bag_ref(tables, idxs[0])
    check(same_bits(got, want), f"timed {name} equals its plain version")
    table_rows = tables.view(f * v, d)
    lib = torch.nn.functional.embedding_bag(flat[0], table_rows, mode="mean").view(got.shape)

    def cycling(fn):
        pending = itertools.cycle(range(len(idxs)))
        return lambda: fn(next(pending))

    reps = 50 if len(idxs) > 1 else 20
    b, _, mh = idxs[0].shape
    kernel_call = cycling(lambda i: ops.embedding_bag_fields(tables, idxs[i]))
    return {"name": name, "route": "cuda", "source": SOURCES["embedding_bag"],
            "replaces": "src/repro/kernels/embedding_bag/kernel.py:42",
            "launches": launches,
            "max_abs_err": float((got.float() - want.float()).abs().max()),
            "ms": time_ms(kernel_call, reps),
            "plain_ms": time_ms(cycling(lambda i: ref.embedding_bag_ref(tables, idxs[i])), 10),
            "bound_ms": needed / HBM_BYTES_PER_S * 1e3, "bound_by": "bytes",
            "library_ms": time_ms(cycling(lambda i: torch.nn.functional.embedding_bag(
                flat[i], table_rows, mode="mean")), reps),
            "device_ms": kernel_device_ms(kernel_call, "embedding_bag_kernel")["ms"],
            "library_max_abs_err": float((lib.float() - want.float()).abs().max()),
            "shape": {"B": b, "F": f, "MH": mh, "V": v, "D": d, "batches_cycled": len(idxs),
                      "distinct_rows": torch.unique(flat[0]).numel()}}


def embedding_bag_backward_entry(name: str, tables, idx, launches: int) -> dict:
    """Phase 5's line for B4's backward (``embedding_bag_ops.bag_gradient``:
    B5 over the (field, row) layout) at phase 3j (b)'s shape: the batch's
    indices, a cotangent of the bags drawn at random.  The plain version is
    autograd's backward through B4's plain version, the library call
    ``F.embedding_bag(mode="mean")``'s backward over the flattened table
    stack (each timed on a graph built once).  The bound counts the
    bytes the function must move: the bags' gradient and the indices read
    once and the dense (F, V, D) gradient written once."""
    import torch

    from repro_torch.kernels.embedding_bag import ops, ref

    f, v, d = tables.shape
    b, _, mh = idx.shape
    gen = torch.Generator(device=tables.device).manual_seed(17)
    cot = torch.randn((b, f, d), generator=gen, device=tables.device)

    def call():  # keeps no output: the profiled calls' 6.66 GB results are not held together
        ops.bag_gradient(cot, idx, tables.shape, tables.dtype)

    got = ops.bag_gradient(cot, idx, tables.shape, tables.dtype)
    t = tables.detach().requires_grad_(True)  # aliases: no copies of the 6.66 GB tables
    plain_out = ref.embedding_bag_ref(t, idx)
    want = torch.autograd.grad(plain_out, t, cot, retain_graph=True)[0]
    scale = torch.autograd.grad(plain_out, t, cot.abs(), retain_graph=True)[0]
    check(sums_close(got, want, scale), f"timed {name} agrees with its plain version")
    field = torch.arange(f, device=idx.device).view(1, f, 1) * v
    flat = (idx.to(torch.int64) + field).view(-1)
    offsets = torch.arange(0, flat.numel(), max(mh, 1), device=idx.device)
    rows = tables.view(f * v, d).detach().requires_grad_(True)
    lib_out = torch.nn.functional.embedding_bag(flat, rows, offsets, mode="mean")
    lib_cot = cot.view(b * f, d)
    lib = torch.autograd.grad(lib_out, rows, lib_cot, retain_graph=True)[0].view(f, v, d)
    needed = cot.numel() * 4 + idx.numel() * 4 + f * v * d * tables.element_size()
    entry = {"name": name, "route": "cuda", "source": SOURCES["seg_mm"],
             "replaces": "src/repro/kernels/embedding_bag/kernel.py:42",
             "launches": launches,
             "max_abs_err": float((got - want).abs().max()),
             "ms": time_ms(call),
             "device_ms": kernel_device_ms(call, "seg_mm_kernel")["ms"],
             "plain_ms": time_ms(lambda: torch.autograd.grad(plain_out, t, cot,
                                                             retain_graph=True), 10),
             "bound_ms": needed / HBM_BYTES_PER_S * 1e3, "bound_by": "bytes",
             "library_ms": time_ms(lambda: torch.autograd.grad(lib_out, rows, lib_cot,
                                                               retain_graph=True), 10),
             "layout_ms": time_ms(lambda: ops.backward_layout(idx, v), 10),
             "library_max_abs_err": float((lib - want).abs().max()),
             "shape": {"B": b, "F": f, "MH": mh, "V": v, "D": d}}
    del got, want, scale, lib, plain_out, lib_out, t, rows
    return entry


def selected_rows_bytes(table, masks) -> int:
    """Bytes a bitmap query must move: the rows that some query selects
    (each read once), the masks, and the output written once."""
    q, k = masks.shape
    rows = int(masks.any(dim=0).sum())
    row_bytes = table.shape[1] * table.element_size()  # the output's rows are as wide
    return rows * row_bytes + q * k + q * row_bytes


def bitmap_query_entry(name: str, table, masks, launches: int) -> dict:
    """Phase 5's B1 (int32 ``table``, the packed plane) or B2 (int8, the
    byte plane) line at the fused 1-hop request's masks.  ``bound_ms``
    counts the rows the masks select (``selected_rows_bytes``);
    ``bound_all_rows_ms`` the whole plane, the first design's bound.  Both
    are also timed with every row selected (``*_all_rows``: the dense case,
    and ``bitplane.or_reduce``'s for B1).  ``device_ms`` is L2-warm (the
    selected rows can stay in L2 over the timed calls); ``*_cold_l2``
    flushes L2 before every call."""
    import torch

    from repro_torch.kernels.bitmap_query import ops, ref

    packed = table.dtype == torch.int32
    call, plain, kname = ((ops.bitmap_query_batched_packed, ref.bitmap_query_batched_packed_ref,
                           B1_KERNEL) if packed else
                          (ops.bitmap_query_batched, ref.bitmap_query_batched_ref, B2_KERNEL))
    q, k = masks.shape
    full = torch.ones_like(masks)
    entry = {"name": name, "route": "cuda", "source": SOURCES["bitmap_query"],
             "replaces": "src/repro/kernels/bitmap_query/kernel.py:" + ("118" if packed else "72"),
             "launches": launches,
             "max_abs_err": max_abs_err(call(table, masks), plain(table, masks)),
             "ms": time_ms(lambda: call(table, masks)),
             "device_ms": kernel_device_ms(lambda: call(table, masks), kname)["ms"],
             "device_ms_cold_l2": kernel_device_ms(lambda: call(table, masks), kname,
                                                   cold_l2=True)["ms"],
             "plain_ms": time_ms(lambda: plain(table, masks), 10),
             "bound_ms": selected_rows_bytes(table, masks) / HBM_BYTES_PER_S * 1e3,
             "bound_by": "bytes",
             "library_ms": None if packed else time_ms(
                 lambda: (masks.half() @ table.half()) > 0.5, 10),
             "bound_all_rows_ms": selected_rows_bytes(table, full) / HBM_BYTES_PER_S * 1e3,
             "shape": {"Q": q, "K": k, "W" if packed else "N": table.shape[1],
                       "rows_selected": int(masks.any(dim=0).sum())}}
    check(call(table, full).equal(plain(table, full)), f"{name} exact with every row selected")
    entry["ms_all_rows"] = time_ms(lambda: call(table, full))
    entry["device_ms_all_rows"] = kernel_device_ms(lambda: call(table, full), kname)["ms"]
    entry["device_ms_all_rows_cold_l2"] = kernel_device_ms(lambda: call(table, full), kname,
                                                           cold_l2=True)["ms"]
    return entry


def window_select_entry(b3_inputs, launches: int) -> dict:
    """Phase 5's B3 line at the ``pattern`` request's layer-0 shape.  The
    bound counts what these inputs need: start and degree of every seed,
    the priority and edge word of every lane inside a window, the DST entry
    of every selected lane, and the three outputs."""
    import torch

    from repro_torch.core import bitplane
    from repro_torch.kernels.neighbor_sample import ops, ref

    start, deg, dst, ew, pri, fanout = b3_inputs
    got = ops.window_select(start, deg, dst, ew, pri, fanout=fanout)
    want = ref.window_select_ref(start, deg, dst, ew, pri, fanout=fanout)
    t, w = start.numel(), pri.shape[-1]
    lanes = torch.minimum(deg.clamp(min=0), torch.full_like(deg, w)).to(torch.int64)
    n_words = bitplane.n_words(dst.numel())
    touched = torch.zeros(n_words + 1, dtype=torch.bool, device=start.device)
    first = start.to(torch.int64) >> 5
    last = (start.to(torch.int64) + lanes - 1) >> 5
    live = lanes > 0
    for j in range(w // 32 + 2):
        idx = first + j
        touched[torch.where(live & (idx <= last), idx, n_words)] = True
    words_bytes = 4 * int(touched[:n_words].sum()) if ew is not None else 0
    out_bytes = t * fanout * 9
    needed = 8 * t + 4 * int(lanes.sum()) + words_bytes + 4 * int(got[2].sum()) + out_bytes
    dense = 8 * t + 4 * t * w + words_bytes + 4 * int(got[2].sum()) + out_bytes

    def call():
        return ops.window_select(start, deg, dst, ew, pri, fanout=fanout)

    entry = {"name": "window_select (B3)", "route": "cuda", "source": SOURCES["neighbor_sample"],
             "replaces": "src/repro/kernels/neighbor_sample/kernel.py:81",
             "launches": launches,
             "max_abs_err": max(max_abs_err(a, b) for a, b in zip(got, want)),
             "ms": time_ms(call),
             "device_ms": kernel_device_ms(call, B3_KERNEL)["ms"],
             "plain_ms": time_ms(lambda: ref.window_select_ref(start, deg, dst, ew, pri,
                                                               fanout=fanout), 10),
             "bound_ms": needed / HBM_BYTES_PER_S * 1e3, "bound_by": "bytes",
             "library_ms": None,
             "bound_all_lanes_ms": dense / HBM_BYTES_PER_S * 1e3,
             "shape": {"S": t, "W": w, "fanout": fanout, "m": dst.numel(),
                       "window_lanes": int(lanes.sum()), "edge_words": ew is not None}}
    return entry


def seg_mm_entry(name: str, call, launches: int) -> dict:
    """Phase 5's B5 line for one recorded call (x, src, dst, n, weights):
    the kernel with its layout cached (``layout_ms`` beside it), the plain
    version, and cuSPARSE's CSR product (``torch.sparse.mm``, a CSR built
    once) as the library yardstick.  The bound counts the bytes a CSR
    segment sum must move: per edge a column index and a weight, the row
    pointers, once each row of x that some edge reads, and the output
    written once; ``bound_design_ms`` counts this design's own traffic:
    the row pointers, per kept edge (dst in [0, n)) its src and weight
    entries and a row of x, and the output.  ``layout_ms`` is the layout
    build a batch pays once (sort, row pointers, src into dst order); the
    weights' gather into dst order runs on every call, inside ``ms``.
    ``device_ms_cold_l2`` flushes L2 before every call."""
    import torch

    from repro_torch.kernels.seg_mm import ops, ref

    x, src, dst, n, w = call
    got = ops.seg_mm(x, src, dst, n, edge_weight=w)
    want = ref.seg_mm_ref(x, src, dst, n, edge_weight=w)
    scale = ref.seg_mm_ref(x.abs(), src, dst, n, edge_weight=None if w is None else w.abs())
    check(sums_close(got, want, scale), f"timed {name} agrees with its plain version")
    layout = ops.get_layout(dst, n, src)
    perm = layout.order.to(torch.int64)
    values = torch.ones_like(src, dtype=torch.float32) if w is None else w
    csr = torch.sparse_csr_tensor(layout.row_ptr.to(torch.int64), src.to(torch.int64)[perm],
                                  values[perm], size=(n, x.shape[0]))
    lib = torch.sparse.mm(csr, x)
    e, d = src.numel(), x.shape[1]
    x_rows = torch.unique(src).numel()
    edge_bytes = 4 + (0 if w is None else 4)
    needed = e * edge_bytes + (n + 1) * 4 + x_rows * d * 4 + n * d * 4
    kept = int(layout.row_ptr[-1] - layout.row_ptr[0])
    design = (n + 1) * 4 + kept * (edge_bytes + d * 4) + n * d * 4

    def call_kernel():
        return ops.seg_mm(x, src, dst, n, edge_weight=w)

    return {"name": name, "route": "cuda", "source": SOURCES["seg_mm"],
            "replaces": "src/repro/kernels/seg_mm/kernel.py:98",
            "launches": launches,
            "max_abs_err": float((got - want).abs().max()) if got.numel() else 0.0,
            "ms": time_ms(call_kernel),
            "device_ms": kernel_device_ms(call_kernel, "seg_mm_kernel")["ms"],
            "device_ms_cold_l2": kernel_device_ms(call_kernel, "seg_mm_kernel",
                                                  cold_l2=True)["ms"],
            "plain_ms": time_ms(lambda: ref.seg_mm_ref(x, src, dst, n, edge_weight=w), 10),
            "bound_ms": needed / HBM_BYTES_PER_S * 1e3, "bound_by": "bytes",
            "library_ms": time_ms(lambda: torch.sparse.mm(csr, x), 10),
            "layout_ms": time_ms(lambda: ops.build_layout(dst, n, src), 10),
            "bound_design_ms": design / HBM_BYTES_PER_S * 1e3,
            "library_max_abs_err": float((lib - want).abs().max()) if lib.numel() else 0.0,
            "shape": {"N_src": int(x.shape[0]), "x_rows_read": x_rows, "n": int(n), "E": int(e),
                      "D": int(d)}}


def transposed_call(call, seed: int):
    """B5ᵀ's call for a recorded B5 call (x, src, dst, n, weights): a random
    (n, D) gradient of the forward's output, read over the transposed edges
    (``transposed_edges``) into x's N_src rows."""
    import torch

    from repro_torch.kernels.seg_mm import ops

    x, src, dst, n, w = call
    gen = torch.Generator(device=x.device).manual_seed(seed + 41)
    t_src, t_dst = ops.transposed_edges(dst, n, src, x.shape[0])
    return torch.randn((n, x.shape[1]), generator=gen, device=x.device), t_src, t_dst, \
        x.shape[0], w


def full_graph_call(pg, seed: int):
    """Phase 5's full-graph B5 shape: graph3's whole DI edge list with
    ``degree_norm`` weights over a random (n, 16) x on the card."""
    import torch

    from repro_torch.graph.segment_ops import degree_norm

    g = pg.graph
    gen = torch.Generator(device=g.device).manual_seed(seed + 7)
    x = torch.randn((g.n, 16), generator=gen, device=g.device)
    src, dst = g.src.to(torch.int32).contiguous(), g.dst.to(torch.int32).contiguous()
    return x, src, dst, g.n, degree_norm(src, dst, g.n)


def run(edges: int, seed: int, device: str, n_requests: int = 32) -> dict:
    import torch

    from repro_torch.configs.common import LM_SHAPES, RECSYS_SHAPES
    from repro_torch.core import PropGraph, bitplane
    from repro_torch.data import dlrm_batch
    from repro_torch.graph.generators import random_uniform_graph
    from repro_torch.kernels.bitmap_query import kernel, ops, ref
    from repro_torch.kernels.embedding_bag import kernel as eb_kernel
    from repro_torch.kernels.flash_attention import kernel as fa_kernel
    from repro_torch.kernels.neighbor_sample import kernel as ns_kernel
    from repro_torch.kernels.seg_mm import kernel as sm_kernel

    out = {"device": device}
    # --- phase 1: build the kernels, one nvcc per source, all at once
    t0 = time.perf_counter()
    if device == "cuda":
        with ThreadPoolExecutor(len(SOURCES)) as pool:
            list(pool.map(lambda build: build(), (kernel.build, ns_kernel.build, sm_kernel.build,
                                                  eb_kernel.build, fa_kernel.build,
                                                  fa_kernel.build_sm90, fa_kernel.build_bwd,
                                                  fa_kernel.build_bwd_sm90)))
    out["kernel_build_s"] = time.perf_counter() - t0

    # --- phase 2: kernels against their plain versions
    if device == "cuda":
        out["b6_tolerance_share"] = kernel_checks(device)
    print("phase 2 ok: kernels equal their plain versions", json.dumps(
        {"b6_largest_tolerance_share": max((v["kernel"] for v in
                                            out.get("b6_tolerance_share", {}).values()),
                                           default=None)}), flush=True)
    # phase 5's B6 backward lines, timed while the process is young: the card host's
    # profiler loses more device records the older the process (on_card)
    if device == "cuda":
        b6b = flash_attention_bwd_entries(device)
        print("phase 5 (early) B6 backward", json.dumps(
            [{k: e[k] for k in ("name", "device_ms", "device_ms_by_kernel", "ms", "earlier_ms",
                                "bound_ms", "plain_ms", "library_ms", "library_causal_ms")}
             for e in b6b]), flush=True)

    # --- phase 3: the main path (packed layout)
    src, dst = random_uniform_graph(edges, seed=seed)
    ops.reset_launches()
    sync = torch.cuda.synchronize if device == "cuda" else (lambda: None)
    t0 = time.perf_counter()
    pg, out["build_steps_s"] = build_graph(src, dst, seed, device, sync)
    out["build_s"] = time.perf_counter() - t0
    out["n"], out["m"] = pg.n_vertices, pg.n_edges
    reqs = requests(n_requests)
    for _, text in requests(6):  # warm: one request of each kind, untimed
        pg.match(text)
    lat, results, total = answer(pg, reqs, sync)
    main_launches = dict(ops.launches)
    if device == "cuda":
        check(main_launches[ops.PACKED] > 0, "the main path launched the packed kernel")
    out["requests"] = len(reqs)
    out["p50_ms"] = statistics.median(lat)
    out["p95_ms"] = float(np.percentile(lat, 95))
    out["qps"] = len(reqs) / total
    out["per_kind_ms"] = {k: statistics.median([t for (kk, _), t in zip(reqs, lat) if kk == k])
                          for k, _ in requests(6)}
    out["matched_vertices"] = {k: r.n_vertices() for (k, _), r in zip(reqs[:6], results[:6])}
    print("phase 3 timings", json.dumps({k: out[k] for k in
                                        ("build_s", "n", "m", "p50_ms", "p95_ms", "qps")}),
          flush=True)

    if device == "cuda":
        out["profile"] = device_profile(pg, reqs)

    # correctness at full size: each request kind against the port on the CPU
    cpu_pg = PropGraph.from_arrays(pg.to_arrays(), device="cpu")
    for (kind, text), res in zip(reqs[:6], results[:6]):
        check(res.vertex_mask.shape == (pg.n_vertices,) and res.edge_mask.shape == (pg.n_edges,),
              f"{kind}: result shapes")
        check(same_result(res, cpu_pg.match(text)), f"{kind}: card result equals CPU result")
    check(all(r.n_vertices() > 0 for r in results[:6]), "every request kind matched something")
    print("phase 3 ok: every request kind equals the CPU port bit for bit", flush=True)

    # --- phase 3a: the other two stores and persistence, from the same graph
    out["stores"] = stores_phase(pg, reqs, results[:6], seed, device, sync)
    saved = out["stores"].pop("path")
    print("phase 3a timings", json.dumps({
        **{k: out["stores"][k] for k in ("phase_s", "save_s", "linked_walk_s")},
        **{b: {k: out["stores"][b].get(k) for k in ("load_s", "seal_s", "p50_ms", "p95_ms")}
           for b in ("list", "listd", "arr")}}), flush=True)
    print("phase 3a ok: list, listd and the reloaded arr graph equal phase 3 bit for bit;",
          "the linked walk equals the inverted answer; the listd sample equals arr's",
          json.dumps({"b3_launches": out["stores"]["b3_launches"]}), flush=True)

    # --- phase 3b: sampling on the same graph
    sampled = sampling_phase(pg, cpu_pg, seed, device, sync)
    out["sample"] = sampled["requests"]
    print("phase 3b timings", json.dumps({k: (v["median_ms"], v["b3_launches"])
                                          for k, v in out["sample"].items()}), flush=True)
    print("phase 3b ok: every layer passes check_sample and equals the CPU port bit for bit",
          flush=True)

    # --- phase 3c: GNN serving on the same graph
    out["gnn"] = gnn_phase(pg, seed, device, sync)
    b5_calls = out["gnn"].pop("b5_inputs")
    print("phase 3c timings", json.dumps({
        k: {p: out["gnn"][k][p] for p in ("total", "sample", "batch", "forward")}
        for k in ("minibatch", "population")}), flush=True)
    print("phase 3c ok: logits equal the CPU port's within", GNN_TOL,
          json.dumps({k: out["gnn"][k]["check"] for k in ("minibatch", "population")}),
          flush=True)
    train_gnn = out["gnn"].pop("train")
    b5t_calls = train_gnn.pop("b5t_calls")
    print("phase 3j (a) timings", json.dumps({
        k: train_gnn[k] for k in ("phase_s", "step_ms", "run_s", "restarted_run_s",
                                  "checkpoint_ms", "restore_ms")}), flush=True)
    print("phase 3j (a) ok: GCN step-0 loss and gradients within", TRAIN_TOL, "of the CPU port;",
          f"{TRAIN_STEPS} steps with a failure at {TRAIN_FAIL_AT} bitwise the unbroken run;",
          "the loss falls on one batch", json.dumps({
              "step0": train_gnn["step0"], "launches": train_gnn["launches"],
              "layout_builds": train_gnn["layout_builds"],
              "fixed_batch_loss": [train_gnn["fixed_batch_losses"][i] for i in (0, -1)]}),
          flush=True)

    # --- phase 3d: recsys serving (DLRM-RM2), then the graph-side user context
    out["recsys"] = recsys_phase(seed, device, sync)
    b4_calls = out["recsys"].pop("b4_calls")
    dlrm_model = out["recsys"].pop("model")
    out["context"] = context_phase(pg, seed, device, sync)
    print("phase 3d timings", json.dumps({
        **{k: (out["recsys"][k]["median_ms"], out["recsys"][k]["b4_launches"])
           for k in ("serve_p99", "serve_bulk", "retrieval_cand")},
        "context": (out["context"]["total"], out["context"]["b3_launches"])}), flush=True)
    print("phase 3d ok: logits and top-k equal the CPU port's within", RECSYS_TOL,
          "and the context equals it on the same priorities",
          json.dumps({**{k: out["recsys"][k]["check"]
                         for k in ("serve_p99", "serve_bulk", "retrieval_cand")},
                      "context": out["context"]["check"]}), flush=True)

    # --- phase 3e: LM serving (Gemma-2-9B), after 3d's request batches are gone
    out["lm"] = lm_phase(seed, device, sync)
    b6_calls = out["lm"].pop("b6_calls")
    print("phase 3e timings", json.dumps({
        **{k: (out["lm"][k]["median_ms"], out["lm"][k]["tokens_per_s"],
               out["lm"][k]["b6_per_request"]) for k in LM_REQUESTS},
        "generate_step_ms": out["lm"]["generate"]["median_step_ms"]}), flush=True)
    print("phase 3e ok: B6 within", B6_TOL["bfloat16"], "of the plain path at every layer;",
          "f32 full-depth logits of B6 and the direct path within", LM_DEPTH_TOL,
          "of the chunked path's; f32 two-layer logits within", LM_F32_TOL,
          "of the CPU port's (prefill) and of the forward's (decode)",
          json.dumps({"b": out["lm"]["check_b"], "c": out["lm"]["check_c"],
                      "d": out["lm"]["check_d"]}), flush=True)

    # --- phase 3f: the frontier and semiring analytics, on the same graph and its CPU twin.
    # It runs after 3e: placed before 3b it aged the process by its minute or two, and on
    # the card's host the profiler loses more device records the older the process
    # (on_card), enough that phase 3d's DLRM session lost B4's kernel in 6 of 9 runs on an
    # H100 (PERF.md §7).
    out["analytics"] = analytics_phase(pg, cpu_pg, seed, device, sync)
    print("phase 3f timings", json.dumps({
        "phase_s": out["analytics"]["phase_s"],
        **{k: (v["median_ms"], v["rounds"], v["capped"], v.get("busy_share"))
           for k, v in out["analytics"]["requests"].items()}}), flush=True)
    print("phase 3f ok: k-hop (both impls) and communities equal the CPU port bit for bit;",
          "components and shortest paths hold their certificates and equal the CPU port over",
          CPU_PROBE_ROUNDS, "rounds (in full where it takes at most", CPU_FULL_S, "s);",
          "PageRank within", PR_L1_TOL, "(L1); graph1 at the full caps equals the CPU port",
          json.dumps({"b1_launches": out["analytics"]["b1_launches"],
                      "checks": {k: out["analytics"]["requests"][k]["check"]
                                 for k in ("components", "components_filtered", "shortest_paths",
                                           "shortest_paths_filtered")},
                      "graph1": out["analytics"]["graph1"]}), flush=True)

    # --- phase 3g: the overlay on a fork of the same graph and of its CPU twin
    out["overlay"] = overlay_phase(pg, cpu_pg, results, seed, device, sync)
    ovl = out["overlay"]
    print("phase 3g timings", json.dumps({
        **{k: ovl[k] for k in ("phase_s", "stream_s", "cpu_stream_s", "write_ms_per_batch",
                               "read_under_writes_p50_ms", "p50_ms", "p95_ms", "qps",
                               "sampling_view_ms", "sample_ms", "snapshot_ms", "fork_ms",
                               "compact_s", "first_requests_after_compact_s", "khop_ms",
                               "components_ms", "pagerank_ms")},
        "phase3_p50_ms": out["p50_ms"]}), flush=True)
    print("phase 3g ok: under 12 write batches, deletes, revivals and updates every request",
          "kind, k-hop, sampled blocks equal the CPU fork bit for bit, components hold their",
          "certificate, PageRank within", PR_L1_TOL, "(L1); compaction kept every answer, the",
          "snapshot and the parent answer as before; graph1's compaction equals the CPU port's",
          "and a from-scratch build", json.dumps(
              {k: ovl[k] for k in ("b1_launches", "b3_launches", "delta_stats", "pagerank_l1",
                                   "graph1")}), flush=True)
    del cpu_pg

    # --- phase 4: the byte layout
    ops.reset_launches()
    with bitplane.byte_masks():
        pgb, _ = build_graph(src, dst, seed, device)
    check(not pgb._vstore.packed, "byte_masks() built a byte store")
    text = reqs[0][1]
    resb = pgb.match(text)
    sync()
    byte_launches = dict(ops.launches)
    if device == "cuda":
        check(byte_launches[ops.BYTE] > 0, "the byte path launched the byte kernel")
    check(same_result(resb, results[0]), "byte layout equals packed layout")
    byte_ms = []
    for _ in range(5):  # the same request again, warm
        t0 = time.perf_counter()
        pgb.match(text)
        sync()
        byte_ms.append((time.perf_counter() - t0) * 1e3)
    out["byte_request_ms"] = statistics.median(byte_ms)
    print("phase 4 ok: byte layout equals packed layout;", json.dumps(
        {"byte_request_ms": out["byte_request_ms"]}), flush=True)

    # --- phase 5: kernel times at the main path's shapes
    if device == "cuda":
        fused = pg.explain(reqs[0][1])
        plan_q = 2  # the fused 1-hop request batches its two node masks
        check("node slots [0, 1]" in fused, "fused 1-hop plan batches both node masks")
        masks = torch.zeros((plan_q, pg._vstore.k), dtype=torch.bool)
        masks[0, :2] = True
        masks[1, 2] = True
        masks = masks.to(device)
        plane = pg._vstore.finalize().bitmap
        bitmap = pgb._vstore.finalize().bitmap
        b1_paths = {"match": main_launches[ops.PACKED],
                    "analytics": out["analytics"]["b1_launches"],
                    "overlay": out["overlay"]["b1_launches"]}
        b1 = bitmap_query_entry("bitmap_query_packed (B1)", plane, masks, sum(b1_paths.values()))
        b1["launches_by_path"] = b1_paths
        b2 = bitmap_query_entry("bitmap_query_byte (B2)", bitmap, masks,
                                byte_launches[ops.BYTE])
        check(b1["max_abs_err"] == 0 and b2["max_abs_err"] == 0, "timed kernels exact")
        # the edge plane, at the Q of a lone mask and of a fused edge batch
        eplane = pg._estore.finalize().bitmap
        for q in (1, 2):
            em = masks[:q].contiguous()
            out[f"b1_edge_plane_q{q}_ms"] = time_ms(
                lambda: ops.bitmap_query_batched_packed(eplane, em))
            out[f"b1_edge_plane_q{q}_device_ms"] = kernel_device_ms(
                lambda: ops.bitmap_query_batched_packed(eplane, em), B1_KERNEL)["ms"]
            out[f"b1_edge_plane_q{q}_bound_ms"] = selected_rows_bytes(
                eplane, em) / HBM_BYTES_PER_S * 1e3
        b3_paths = {"sample": sum(v["b3_launches"] for v in out["sample"].values()),
                    "overlay": out["overlay"]["b3_launches"]}
        b3 = window_select_entry(sampled["b3_inputs"], sum(b3_paths.values()))
        b3["launches_by_path"] = b3_paths
        check(b3["max_abs_err"] == 0, "timed B3 exact")
        b5_launches = out["gnn"]["b5_launches"]
        b5 = [seg_mm_entry(f"seg_mm (B5) population layer {i + 1}", call, b5_launches)
              for i, call in enumerate(b5_calls)]
        b5.append(seg_mm_entry("seg_mm (B5) graph3 full propagation", full_graph_call(pg, seed),
                               b5_launches))
        b4 = [embedding_bag_entry(f"embedding_bag (B4) {kind}", b4_calls["tables"],
                                  idxs if isinstance(idxs, list) else [idxs],
                                  out["recsys"][kind]["b4_launches"])
              for kind, idxs in (("serve_p99", b4_calls["serve_p99"]),
                                 ("serve_bulk", b4_calls["serve_bulk"]))]
        check(all(e["max_abs_err"] == 0 for e in b4), "timed B4 exact")
        b5t = [seg_mm_entry(f"seg_mm transposed (B5ᵀ) 3j GCN backward, layer {2 - i}", call,
                            train_gnn["launches"]["b5t"])
               for i, call in enumerate(b5t_calls)]
        b5t.append(seg_mm_entry("seg_mm transposed (B5ᵀ) population layer 1 backward",
                                transposed_call(b5_calls[0], seed),
                                train_gnn["launches"]["b5t"]))
        train_idx = dlrm_batch(0, batch=RECSYS_SHAPES["train_batch"]["batch"],
                               vocab=dlrm_model[1].vocab_size, seed=seed + 40,
                               device="cpu")["sparse"].to(device)  # 3j (b)'s step 0
        b4b = embedding_bag_backward_entry("embedding_bag backward (B4 on B5) 3j train_batch",
                                           b4_calls["tables"], train_idx, 0)
        del train_idx
        b6 = [flash_attention_entry(f"flash_attention (B6) prefill_8k {kind} layer", call,
                                    out["lm"]["prefill_8k"]["b6_launches_by_layer"][kind])
              for kind, call in zip(("local", "global"), b6_calls)]
        check(all(e["kernel"] == "sm90" for e in b6), "prefill_8k's layers ran the wgmma/TMA kernel")
        out["kernels"] = [b1, b2, b3, *b4, b4b, *b5, *b5t, *b6, *b6b]
        for entry in out["kernels"]:  # on the kernel's own time
            entry["share_of_bound"] = entry["bound_ms"] / entry["device_ms"]
            if "device_ms_cold_l2" in entry:
                entry["share_of_bound_cold_l2"] = entry["bound_ms"] / entry["device_ms_cold_l2"]
    del b4_calls, b6_calls, b5t_calls

    # --- phase 3j (b): DLRM training on 3d's model, after phase 5 so that phase 5's
    # profiler sessions keep the age they had (on_card)
    out["train_dlrm"] = train_dlrm_phase(*dlrm_model, seed, device, sync)
    del dlrm_model
    tr = out["train_dlrm"]
    print("phase 3j (b) timings", json.dumps({
        k: tr[k] for k in ("phase_s", "grad_ms", "step_ms", "sparse_update")}), flush=True)
    print("phase 3j (b) ok: DLRM step-0 loss, MLP gradients and the named rows' gradients",
          "within", TRAIN_TOL, "of the CPU port; other rows exactly 0;",
          "on the card bitwise run to run;",
          "the sparse update within", SPARSE_UPDATE_TOL, "of the dense one", json.dumps(
              {"step0": tr["step0"], "launches": tr["launches"],
               "losses": [x["loss"] for x in tr["steps"]]}), flush=True)

    # --- phase 3k: LM training (Gemma-2-9B at its published widths), after 3j (b) freed
    # its state and after phase 5, whose profiler sessions keep their age (on_card)
    out["train_lm"] = train_lm_phase(seed, device, sync)
    tl = out["train_lm"]
    print("phase 3k timings", json.dumps({
        "phase_s": tl["phase_s"], "example_s": tl["example"]["s"],
        **{k: {x: v.get(x) for x in ("grad_ms", "step_ms", "grad_peak_gib", "peak_gib")}
           for k, v in tl["steps"].items()}}), flush=True)
    print("phase 3k ok: two full-width f32 layers' step-0 loss and gradients within",
          LM_GRAD_TOL, "of the plain chunked path's;", LM_TRAIN_LAYERS, "bf16 layers' step-0",
          "loss and gradients bitwise equal with remat on and off and the loss falling;",
          "the example's restart bitwise", json.dumps(
              {"grad_check": tl["grad_check"], "launches": tl["launches"],
               "losses": {k: [x["loss"] for x in v["steps"]] for k, v in tl["steps"].items()},
               "example": tl["example"]["lines"]}), flush=True)
    if device == "cuda":
        check(tl["launches"]["bwd_sm90"] > 0 and min(tl["launches"]["sm90"].values()) > 0,
              "3k: the LM's training launched B6's backward and its forward at both layer kinds")

    # --- phase 3h: the service and wire layer over the same graph.  It runs after phase 5:
    # placed after 3g it aged the process by its 40 s and two subprocesses, and phase 5's
    # profiler sessions then lost every B1 record of a timing (on_card; PERF.md §6).
    out["service"] = service_phase(pg, reqs, results, seed, device, sync)
    svc_out = out["service"]
    print("phase 3h timings", json.dumps({
        "phase_s": svc_out["phase_s"],
        **{k: {m: svc_out[k][m] for m in ("p50_ms", "p95_ms", "qps")}
           for k in ("caches_off", "caches_on")},
        "sequential_qps": svc_out["sequential"]["qps"],
        "sample_batch_ms": svc_out["samples"]["batch_ms"],
        "sample_concurrent_ms": svc_out["samples"]["concurrent_ms"],
        "wire_p50_ms": svc_out["wire"]["p50_ms"], "cli_s": svc_out["cli_s"],
        **{k: svc_out.get(k) for k in ("mem_before_gib", "mem_peak_gib", "mem_after_gib")}}),
        flush=True)
    print("phase 3h ok: every service and wire answer equals phase 3's bit for bit, coalesced",
          "samples equal their solo runs, both pgserve gates passed", json.dumps({
              "b1_launches": svc_out["b1_launches"], "b1_max_q": svc_out["b1_max_q"],
              "b3_launches": svc_out["b3_launches"],
              "coalesce_width": svc_out["caches_off"]["coalesce_width"],
              "result_hits": svc_out["caches_on"]["result_hits"],
              "dedup_hits": svc_out["caches_on"]["dedup_hits"]}), flush=True)
    if device == "cuda":
        torch.cuda.empty_cache()

    # --- phase 3i: the entity mesh: graph3 reopened from phase 3a's save, sharded
    out["mesh"] = mesh_phase(pg, reqs, results, saved, seed, device, sync)
    mesh_out = out["mesh"]
    one = mesh_out["one_card"]
    print("phase 3i timings", json.dumps({
        "phase_s": mesh_out["phase_s"],
        **{b: {k: one[b][k] for k in ("load_s", "seal_s", "p50_ms", "p95_ms", "qps")}
           for b in ("arr", "list", "listd")},
        "analytics_ms": {k: v for k, v in one["arr"]["analytics"].items() if k.endswith("_ms")},
        "service_ms": one["arr"]["service_ms"]}), flush=True)
    print(f"phase 3i ok: on {MESH_SHARDS} shards", "(and every card)" if "all_cards" in mesh_out
          else "of one card", "every request, k-hop, shortest paths, components, communities,",
          "the sample and the service's answers equal the single-device graph's bit for bit,",
          "PageRank within", PR_L1_TOL, "(L1); no dense store kept", json.dumps({
              "launches": mesh_out["launches"],
              "sharded_queries": {b: one[b]["sharded_queries"] for b in ("arr", "byte")},
              "shard_bytes": {b: one[b]["shard_bytes"] for b in ("arr", "list", "listd")},
              "pagerank_l1": one["arr"]["analytics"]["pagerank_l1"]}), flush=True)

    # --- phase 3j (c), 3k (iv): the training CLI on the card
    out["train_cli"] = train_cli_phase(device)
    print("phase 3j (c), 3k (iv) ok: the training CLI exits 0 with 'done' for GCN, DLRM and",
          "Gemma-2", json.dumps({"cli": out["train_cli"]}), flush=True)

    if device == "cuda":
        train = {"gnn": train_gnn["launches"], "dlrm": out["train_dlrm"]["launches"]}
        for entry, launches in ((b1, train["gnn"]["b1"]), (b3, train["gnn"]["b3"])):
            entry["launches_by_path"]["train"] = launches
            entry["launches"] += launches
        for entry in b4:
            entry["launches_by_path"] = {"serve": entry["launches"], "train": train["dlrm"]["b4"]}
            entry["launches"] += train["dlrm"]["b4"]
        b4b["launches"] = train["dlrm"]["b4_backward"]
        b4b["launches_by_path"] = {"train": b4b["launches"]}
        for entry in b5:  # B5 in training: the GCN's forward and B5ᵀ, and B4's backward
            entry["launches_by_path"] = {"gnn": entry["launches"],
                                         "train": train["gnn"]["b5"] + train["dlrm"]["b5"]}
            entry["launches"] += entry["launches_by_path"]["train"]
        for entry in b5t:
            entry["launches_by_path"] = {"train": entry["launches"]}
        for entry, launches in ((b1, svc_out["b1_launches"]), (b3, svc_out["b3_launches"])):
            entry["launches_by_path"]["service"] = launches
            entry["launches"] += launches
        train_b6 = out["train_lm"]["launches"]  # 3k (ii)'s, by kernel
        for entry, kind in zip(b6, ("local", "global")):  # sm90 at this entry's layer kind
            entry["launches_by_path"] = {"serve": entry["launches"],
                                         "train": train_b6["sm90"][kind]}
            entry["launches"] += train_b6["sm90"][kind]
        for entry in b6b:  # bwd_sm90, every launch at train_4k's 4,096 tokens
            entry["launches"] = train_b6["bwd_sm90"]
            entry["launches_by_path"] = {"train": train_b6["bwd_sm90"]}
        b2["launches_by_path"] = {"byte": b2["launches"]}
        for entry, kernel in ((b1, ops.PACKED), (b2, ops.BYTE)):
            entry["launches_by_path"]["mesh"] = mesh_out["launches"][kernel]
            entry["launches"] += mesh_out["launches"][kernel]
        out["peak_mem_gib"] = max(torch.cuda.max_memory_allocated() / 2**30,
                                  out["gnn"]["peak_mem_gib"], out["gnn"]["peak_mem_gib_before"],
                                  out["recsys"]["peak_mem_gib"], out["lm"]["peak_mem_gib"],
                                  out["train_dlrm"]["peak_mem_gib"], svc_out["mem_peak_gib"],
                                  out["train_lm"]["grad_check"]["peak_gib"],
                                  *(v["peak_gib"] for v in out["train_lm"]["steps"].values()))
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--edges", type=int, default=10_000_000, help="graph3 of Tab. I")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()

    import torch

    import repro_torch  # noqa: F401  (fails outside a checkout of the repository)

    if not torch.cuda.is_available():
        print("chip_smoke: torch sees no CUDA card", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    print(json.dumps({"python": sys.version.split()[0], "torch": torch.__version__,
                      "cuda": torch.version.cuda}), flush=True)
    out = run(args.edges, args.seed, "cuda")
    kernels = out.pop("kernels")
    out["device_ms_by_cuda_events"] = DEVICE_MS_BY_EVENTS
    print("summary", json.dumps(out), flush=True)
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
