"""The partitioned dry run (``launch/dryrun.trace_partitioned``): each LM
cell as one device's program on a device mesh, through DTensor over a fake
process group, against the reference's partitioned program on the CPU.

* Placements: every traced LM cell's arguments on a (2, 4) mesh, each
  rank's shard (``sharding.named``, ``local_shard``) at the offsets and of
  the shape jax's ``NamedSharding.devices_indices_map`` gives its device
  (eight host devices in a subprocess); on both production meshes the
  DTensors ``tree_named`` makes have ``sharding.shard_shape``'s local
  shapes.
* The ring model: hand-built collectives, booked by the counter on a fake
  mesh, cost what the reference's ``analyze_hlo`` charges the same HLO.
* Against the reference: at smoke cells on (2, 4), the port's per-device
  matmul FLOPs within 5% of ``analyze_hlo`` of the reference's compiled
  per-device program (attention stands aside, as in
  ``test_torch_dryrun.py``: the reference's is a dot-free stand-in, the
  port's is B6's charge, checked apart as the whole step's charge split
  over the mesh).  Every collective kind either side issues is tabled
  with the ratio; a gap over 25% must be logged in ROADMAP §C.
* Hints: the sequence-parallel carry and the MoE constraints on plain
  tensors change nothing, bit for bit.
"""
import dataclasses
import json
import os
import re
import subprocess
import sys
from pathlib import Path

import jax  # noqa: F401  (the reference's analyzer below; jax stays on the CPU)
import numpy as np
import pytest
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh
from torch.testing._internal.distributed.fake_pg import FakeStore

from repro.launch.hlo_analysis import analyze_hlo
from repro_torch.configs import registry
from repro_torch.configs.common import sds
from repro_torch.launch import sharding
from repro_torch.launch.dryrun import trace_partitioned, trace_step
from repro_torch.launch.hlo_analysis import CostCounter, ring_bytes
from repro_torch.launch.mesh import AbstractMesh, fake_device_mesh, make_production_mesh
from repro_torch.launch.steps import build_cell, leaf_specs
from repro_torch.models import transformer as T
from repro_torch.nn import moe

ROOT = Path(__file__).resolve().parents[1]
MESH24 = AbstractMesh((2, 4), ("data", "model"))
LM_CELLS = [(a, s) for a, s, skip in registry.list_cells()
            if registry.get_arch(a).FAMILY == "lm" and not skip]
KINDS = ("all-gather", "all-reduce", "all-to-all", "collective-permute", "reduce-scatter")


def _xla8(script: str, payload) -> dict:
    """``script`` run by a fresh interpreter with eight host devices (jax's
    ``--xla_force_host_platform_device_count=8``), ``payload`` on its
    stdin as JSON; its last stdout line, as JSON."""
    env = {**os.environ, "XLA_FLAGS": "--xla_force_host_platform_device_count=8",
           "JAX_PLATFORMS": "cpu", "PYTHONPATH": str(ROOT / "src")}
    proc = subprocess.run([sys.executable, "-c", script], input=json.dumps(payload), env=env,
                          capture_output=True, text=True, timeout=600, cwd=ROOT)
    assert proc.returncode == 0, proc.stderr[-4000:]
    return json.loads(proc.stdout.strip().splitlines()[-1])


# ------------------------------------------------------------------ placements
_INDICES = r"""
import json, sys
import jax, numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec
mesh = Mesh(np.array(jax.devices()[:8]).reshape(2, 4), ("data", "model"))
out = []
for shape, spec in json.load(sys.stdin):
    spec = [tuple(d) if isinstance(d, list) else d for d in spec]
    m = NamedSharding(mesh, PartitionSpec(*spec)).devices_indices_map(tuple(shape))
    out.append([[[s.start or 0, n if s.stop is None else s.stop]
                 for s, n in zip(m[d], shape)] for d in mesh.devices.flat])
print(json.dumps(out))
"""


def _jsonable(spec):
    return [list(d) if isinstance(d, tuple) else d for d in spec]


def test_every_lm_cells_shards_sit_where_jax_puts_them():
    pairs = {}
    for arch, shape in LM_CELLS:
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


@pytest.mark.parametrize("multi_pod", [False, True])
def test_dtensor_shards_have_the_spec_rules_local_shapes(multi_pod):
    from torch._subclasses.fake_tensor import FakeTensorMode

    mesh = make_production_mesh(multi_pod=multi_pod)
    with fake_device_mesh(mesh, "cpu") as dmesh, FakeTensorMode():
        for arch, shape in LM_CELLS:
            _, _, args, in_specs, _, _ = build_cell(arch, shape, mesh)
            dargs = sharding.tree_named(dmesh, in_specs, args)
            for (t, spec), (d, _) in zip(leaf_specs(args, in_specs),
                                         leaf_specs(dargs, in_specs)):
                assert tuple(d.shape) == tuple(t.shape)
                assert tuple(d.to_local().shape) == sharding.shard_shape(t.shape, spec, mesh), \
                    (arch, shape, spec)


def test_an_axis_group_out_of_the_meshs_order_is_refused():
    with fake_device_mesh(MESH24, "cpu") as dmesh:
        with pytest.raises(ValueError, match="not in the mesh's order"):
            sharding.named(dmesh, (("model", "data"),))


# --------------------------------------------------------------- the ring model
_HLO = """HloModule m

ENTRY %main (p0: f32[8,16]) -> f32[{out}] {{
  %p0 = f32[8,16]{{1,0}} parameter(0)
  ROOT %c = f32[{out}]{{1,0}} {op}(%p0), replica_groups={{{{0,1,2,3}}}}{extra}
}}
"""
_CASES = {  # kind: (output shape, extra attributes, the port's collective on a (8, 16) f32 input)
    "all-gather": ("32,16", ", dimensions={0}",
                   lambda f, x, g: f.all_gather_tensor(x, 0, g)),
    "all-reduce": ("8,16", ", to_apply=%add", lambda f, x, g: f.all_reduce(x, "sum", g)),
    "reduce-scatter": ("2,16", ", dimensions={0}, to_apply=%add",
                       lambda f, x, g: f.reduce_scatter_tensor(x, "sum", 0, g)),
    "all-to-all": ("8,16", ", dimensions={0}",
                   lambda f, x, g: f.all_to_all_single(x, None, None, g)),
    "collective-permute": ("8,16", "", None),
}


@pytest.mark.parametrize("kind", sorted(_CASES))
def test_ring_model_charges_what_the_reference_charges(kind):
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed import _functional_collectives as funcol

    out, extra, issue = _CASES[kind]
    hlo = _HLO.format(out=out, op=kind, extra=extra)
    want = analyze_hlo(hlo)["coll_by_kind"][kind]
    out_bytes = 4 * np.prod([int(n) for n in out.split(",")])
    assert ring_bytes(kind, 4, out_bytes) == pytest.approx(want)
    if issue is None:  # DTensor issues no permute
        return
    with fake_device_mesh(AbstractMesh((4,), ("model",)), "cpu") as dmesh, FakeTensorMode():
        x = torch.empty((8, 16))
        with CostCounter() as counter:
            y = issue(funcol, x, (dmesh, 0))
            y = funcol.wait_tensor(y) if isinstance(y, torch.Tensor) else y
    tot = counter.totals()
    assert tot["coll_by_kind"] == {kind: pytest.approx(want)}
    assert tot["coll_count"] == {kind: 1} and tot["coll_bytes"] == pytest.approx(want)


def test_a_cpu_meshs_all_to_all_is_booked_as_the_cards():
    """DTensor moves Shard(0) → Shard(1) on a CPU mesh by all-gather and
    chunk (gloo has no all-to-all); on tensors without data the counter runs
    and books the card's all-to-all."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed.tensor import DTensor, Shard

    with fake_device_mesh(AbstractMesh((4,), ("model",)), "cpu") as dmesh, FakeTensorMode():
        x = DTensor.from_local(torch.empty((2, 16)), dmesh, [Shard(0)], run_check=False)
        with CostCounter() as counter:
            y = x.redistribute(dmesh, [Shard(1)])
        assert tuple(y.to_local().shape) == (8, 4)
    tot = counter.totals()
    assert tot["coll_count"] == {"all-to-all": 1}
    assert tot["coll_bytes"] == pytest.approx(ring_bytes("all-to-all", 4, 8 * 4 * 4))


def test_a_dtensor_matmul_counts_the_local_product_only():
    """DTensor works out each operation's output on fake tensors of the
    global shapes; the counter books only the rank's local product."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed.tensor import DTensor, Replicate, Shard

    m, k, n = 64, 32, 48
    with fake_device_mesh(MESH24, "cpu") as dmesh, FakeTensorMode():
        x = DTensor.from_local(torch.empty((m // 2, k)), dmesh, [Shard(0), Replicate()],
                               run_check=False)
        w = DTensor.from_local(torch.empty((k, n // 4)), dmesh, [Replicate(), Shard(1)],
                               run_check=False)
        with CostCounter() as counter:
            y = x @ w
        assert tuple(y.to_local().shape) == (m // 2, n // 4)
    tot = counter.totals()
    assert tot["flops"] == 2 * (m // 2) * k * (n // 4)
    assert tot["coll_count"] == {} and tot["coll_bytes"] is None


@pytest.mark.parametrize("owner, name", [
    ("torch.distributed.tensor._sharding_prop.ShardingPropagator",
     "_propagate_tensor_meta_non_cached"),
    ("torch.distributed.tensor.placement_types", "shard_dim_alltoall")])
def test_the_counter_refuses_a_torch_without_what_it_patches(monkeypatch, owner, name):
    import importlib

    module, _, cls = owner.rpartition(".")
    target = (getattr(importlib.import_module(module), cls) if cls[0].isupper()
              else importlib.import_module(owner))
    monkeypatch.delattr(target, name)
    with pytest.raises(RuntimeError, match=name):
        with CostCounter():
            pass


# ---------------------------------------------------------- against the reference
SMOKE_SHAPES = {"train_4k": (8, 64), "prefill_32k": (8, 64), "decode_32k": (8, 64)}
SMOKE_CELLS = [("gemma2-9b", "train_4k"), ("gemma2-9b", "prefill_32k"),
               ("gemma2-9b", "decode_32k"), ("qwen2-72b", "train_4k"),
               ("starcoder2-7b", "train_4k"), ("dbrx-132b", "train_4k"),
               ("mixtral-8x22b", "train_4k")]

_REFERENCE = r"""
import json, sys
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import Mesh
from repro.configs import common, registry
from repro.launch import steps
from repro.launch.hlo_analysis import analyze_hlo
from repro.launch.sharding import tree_named
from repro.models import transformer as T

cells, shapes = json.load(sys.stdin)
for name, (b, s) in shapes.items():
    common.LM_SHAPES[name] = {**common.LM_SHAPES[name], "global_batch": b, "seq_len": s}
T.attention = lambda q, k, v, **kw: q + (jnp.mean(k, axis=(1, 2))
                                         + jnp.mean(v, axis=(1, 2)))[:, None, None, :]
mesh = Mesh(np.array(jax.devices()[:8]).reshape(2, 4), ("data", "model"))
out = {}
for arch, shape in cells:
    mod = registry.get_arch(arch)
    mod.full_config = mod.smoke_config
    _, step, args, in_specs, out_specs, _ = steps.build_cell(arch, shape, mesh)
    with mesh:
        jitted = jax.jit(step, in_shardings=tree_named(mesh, in_specs),
                         out_shardings=None if out_specs is None else tree_named(mesh, out_specs))
        tot = analyze_hlo(jitted.lower(*args).compile().as_text())
    out[arch + " " + shape] = {"flops": tot["flops"], "coll_by_kind": dict(tot["coll_by_kind"])}
print(json.dumps(out))
"""


def smoke_cell(arch: str, shape: str, mesh):
    """``build_cell`` of ``arch``'s smoke config at ``SMOKE_SHAPES``' batch
    and length."""
    cfg = registry.get_arch(arch).smoke_config()
    b, s = SMOKE_SHAPES[shape]
    i32 = torch.int32
    kind = registry.common.LM_SHAPES[shape]["kind"]
    if kind == "train":
        specs = {"tokens": sds((b, s), i32), "labels": sds((b, s), i32)}
    elif kind == "prefill":
        specs = {"tokens": sds((b, s), i32)}
    else:
        specs = {"tokens": sds((b, 1), i32), "cache": T.init_cache(cfg, b, s, device="meta")}
    return build_cell(arch, shape, mesh, cfg=cfg, specs=specs)


@pytest.fixture(scope="module")
def reference_per_device():
    return _xla8(_REFERENCE, [SMOKE_CELLS, SMOKE_SHAPES])


def collective_table(reference_per_device):
    """{cell: {kind: (reference bytes, port bytes, port / reference)}} and
    the port's per-device totals, at the smoke cells on (2, 4)."""
    table, port = {}, {}
    for arch, shape in SMOKE_CELLS:
        _, step, args, in_specs, _, _ = smoke_cell(arch, shape, MESH24)
        port[(arch, shape)] = got = trace_partitioned(step, args, in_specs, MESH24, "cpu")
        ref = reference_per_device[f"{arch} {shape}"]["coll_by_kind"]
        table[(arch, shape)] = {
            k: (ref.get(k, 0.0), got["coll_by_kind"].get(k, 0.0),
                got["coll_by_kind"].get(k, 0.0) / ref[k] if ref.get(k) else None)
            for k in KINDS if ref.get(k) or got["coll_by_kind"].get(k)}
    return table, port


def test_per_device_flops_and_collectives_against_the_reference(reference_per_device):
    table, port = collective_table(reference_per_device)
    roadmap = (ROOT / "ROADMAP.md").read_text()
    entry = re.search(r"^30\. \*\*.*?(?=^\S)", roadmap, re.M | re.S)  # §C's C.30
    for (arch, shape), rows in table.items():
        got = port[(arch, shape)]
        want = reference_per_device[f"{arch} {shape}"]["flops"]
        assert got["flops"] == pytest.approx(want, rel=0.05), (arch, shape)
        if shape != "decode_32k":  # B6's charge: the whole step's, split over the mesh
            _, step, args, _, _, _ = smoke_cell(arch, shape, AbstractMesh((1, 1),
                                                                          ("data", "model")))
            whole = trace_step(step, args, "cpu")["kernels"]
            for name, k in whole.items():
                assert got["kernels"][name]["calls"] == k["calls"]
                assert got["kernels"][name]["flops"] == pytest.approx(k["flops"] / MESH24.size)
        for kind, (ref_b, port_b, ratio) in rows.items():
            if ratio is None or not 0.75 <= ratio <= 1.25:  # a gap ROADMAP C.30 logs
                assert entry and kind in entry.group(0), (arch, shape, kind, ref_b, port_b)


# ---------------------------------------------------------------------- hints
def test_hints_on_plain_tensors_change_nothing():
    g = torch.Generator().manual_seed(0)
    x = torch.randn(64, 32, generator=g)
    assert sharding.constrain(x, ("data", None)) is x
    p = moe.init_moe(g, 32, 48, 4, virtual_split=2)
    axes = {"dp": ("data",), "expert": "model", "tp": None}
    plain = moe.moe_ffn(p, x, top_k=2, n_groups=2, virtual_split=2)
    hinted = moe.moe_ffn(p, x, top_k=2, n_groups=2, virtual_split=2, shard_axes=axes)
    for a, b in zip(plain, hinted):
        assert torch.equal(a, b)
    cfg = registry.get_arch("gemma2-9b").smoke_config()
    params = T.init_params(torch.Generator().manual_seed(1), cfg, device="cpu")
    tokens = torch.randint(0, cfg.vocab, (2, 16), generator=g)
    sp = dataclasses.replace(cfg, seq_shard_axis="model", batch_shard_axes=("data",))
    for a, b in zip(T.forward(params, tokens, cfg), T.forward(params, tokens, sp)):
        assert torch.equal(a, b)
    assert torch.equal(T.loss_fn(params, tokens, tokens, cfg),
                       T.loss_fn(params, tokens, tokens, sp))


if __name__ == "__main__":  # the table behind ROADMAP C.30 and PERF.md §5
    ref = _xla8(_REFERENCE, [SMOKE_CELLS, SMOKE_SHAPES])
    table, port = collective_table(ref)
    for cell, rows in table.items():
        print(" × ".join(cell), "flops/dev", port[cell]["flops"], ref[" ".join(cell)]["flops"])
        for kind, (r, p, ratio) in rows.items():
            print(f"  {kind:20s} reference {r:12.0f}  port {p:12.0f}  ratio "
                  f"{'—' if ratio is None else f'{ratio:.3f}'}")
