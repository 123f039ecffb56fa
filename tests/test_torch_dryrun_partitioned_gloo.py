"""The partitioned LM programs give the reference's partitioned answers:
eight CPU ranks over gloo on a (2, 4) ("data", "model") mesh
(``torch.multiprocessing``, spawned) against the reference's step jitted
with its specs on a (2, 4) mesh of eight host devices (GSPMD, in a
subprocess of its own), the smoke configs in f32.  Each argument leaf is
drawn from a numpy generator seeded by its case and its path in the
argument tree, so both sides draw the same values; the port's are placed
by the cell's specs (``sharding.tree_named``) and run as every rank's
program (``steps.run_partitioned``).  Cases: dense training with the
sequence-parallel carry (Gemma-2: sliding window, softcaps, tied
embeddings, half a KV head a rank), MoE training with expert parallelism
(DBRX, E = 4 over 4; Mixtral with E = 2, two F-slices a virtual expert,
the buffers' all-to-all), prefill, and decode on the ring and linear
caches (the sequence split over ``model``) for Gemma-2 and Mixtral.  The
loss, the gradient norm, every updated parameter and moment, the logits
and the written caches agree with the reference's within 1e-5, and with
the single-process port's step on the same arguments within 1e-5.
"""
import os
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

ROOT = Path(__file__).resolve().parents[1]
TOL = 1e-5

_COMMON = r'''
import dataclasses, json, sys, zlib
import numpy as np

CASES = [
    ("gemma2-9b train", "gemma2-9b", "train_4k", {}),
    ("dbrx-132b train", "dbrx-132b", "train_4k", {}),
    ("mixtral-8x22b E=2 train", "mixtral-8x22b", "train_4k", {"n_experts": 2}),
    ("gemma2-9b prefill", "gemma2-9b", "prefill_32k", {}),
    ("gemma2-9b decode", "gemma2-9b", "decode_32k", {}),
    ("mixtral-8x22b E=2 decode", "mixtral-8x22b", "decode_32k", {"n_experts": 2}),
]
B, S, CUR = 8, 64, 40


def draw(case, path, shape, floating, train):
    """The value of the argument leaf at ``path``: a float normal · 0.1
    (f32; a second moment's magnitude), an integer array uniform in
    [0, 512) (ids in the smoke vocabularies), an integer scalar 0."""
    rng = np.random.default_rng([case, zlib.crc32(path.encode())])
    if floating:
        x = rng.standard_normal(tuple(shape), dtype=np.float32) * np.float32(0.1)
        return np.abs(x) if train and path.startswith("/1/v/") else x
    if not shape:
        return np.zeros((), np.int64)
    return rng.integers(0, 512, tuple(shape))


def map_paths(fn, tree, prefix=""):
    """``tree`` with each leaf replaced by ``fn(path, leaf)``; a path joins
    dict keys and list or tuple positions with "/"."""
    if isinstance(tree, dict):
        return {k: map_paths(fn, v, f"{prefix}/{k}") for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(map_paths(fn, v, f"{prefix}/{i}") for i, v in enumerate(tree))
    return fn(prefix, tree)


def leaves(tree, prefix=""):
    """(path, leaf) pairs of ``tree``, the paths as ``map_paths`` writes them."""
    out = []
    map_paths(lambda p, x: out.append((p, x)), tree, prefix)
    return out
'''

_WORKER = _COMMON + r'''
import torch
import torch.distributed as dist
import torch.multiprocessing as mp


def run(rank, port, out_dir):
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import DTensor

    from repro_torch.configs import registry
    from repro_torch.configs.common import sds
    from repro_torch.launch.mesh import AbstractMesh
    from repro_torch.launch.sharding import tree_named
    from repro_torch.launch.steps import build_cell, map_tensors, run_partitioned
    from repro_torch.models.transformer import init_cache

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}", rank=rank,
                            world_size=8)
    dmesh = init_device_mesh("cpu", (2, 4), mesh_dim_names=("data", "model"))
    mesh = AbstractMesh((2, 4), ("data", "model"))
    single, partitioned = {}, {}
    for case, (name, arch, shape, over) in enumerate(CASES):
        cfg = dataclasses.replace(registry.get_arch(arch).smoke_config(), **over)
        kind = registry.common.LM_SHAPES[shape]["kind"]
        if kind == "train":
            specs = {"tokens": sds((B, S), torch.int32), "labels": sds((B, S), torch.int32)}
        elif kind == "prefill":
            specs = {"tokens": sds((B, S), torch.int32)}
        else:
            specs = {"tokens": sds((B, 1), torch.int32),
                     "cache": init_cache(cfg, B, S, device="meta")}
        _, step, abstract, in_specs, _, _ = build_cell(arch, shape, mesh, cfg=cfg, specs=specs)

        def leaf(path, t):
            if not torch.is_tensor(t):
                return t
            v = torch.from_numpy(draw(case, path, t.shape, t.is_floating_point(),
                                      kind == "train"))
            return v if t.is_floating_point() else v.to(t.dtype)

        args = map_paths(leaf, abstract)
        if kind == "decode":
            args[1]["cur"] = CUR
        copy = lambda a: map_tensors(torch.clone, a)  # noqa: E731  (a step writes in place)
        want = step(*copy(args))
        got = run_partitioned(step, tree_named(dmesh, in_specs, copy(args)))
        for path, g in leaves(got):
            g = g.full_tensor() if isinstance(g, DTensor) else g
            partitioned[f"{case}{path}"] = g.numpy() if torch.is_tensor(g) else np.asarray(g)
        for path, w in leaves(want):
            single[f"{case}{path}"] = w.numpy() if torch.is_tensor(w) else np.asarray(w)
    if rank == 0:
        np.savez(f"{out_dir}/partitioned.npz", **partitioned)
        np.savez(f"{out_dir}/single.npz", **single)
    dist.destroy_process_group()


if __name__ == "__main__":
    port, out_dir = int(sys.argv[1]), sys.argv[2]
    mp.start_processes(run, args=(port, out_dir), nprocs=8, start_method="spawn")
'''

_REFERENCE = _COMMON + r'''
import jax
import jax.numpy as jnp
from jax.sharding import Mesh

from repro.configs import common, registry
from repro.launch import steps
from repro.launch.sharding import tree_named

out_dir = sys.argv[1]
mesh = Mesh(np.array(jax.devices()[:8]).reshape(2, 4), ("data", "model"))
for name in ("train_4k", "prefill_32k", "decode_32k"):
    common.LM_SHAPES[name] = {**common.LM_SHAPES[name], "global_batch": B, "seq_len": S}
out = {}
for case, (name, arch, shape, over) in enumerate(CASES):
    mod = registry.get_arch(arch)
    mod.full_config = lambda mod=mod, over=over: dataclasses.replace(mod.smoke_config(), **over)
    kind, step, abstract, in_specs, out_specs, _ = steps.build_cell(arch, shape, mesh)

    def leaf(path, sds):
        floating = jnp.issubdtype(sds.dtype, jnp.floating)
        v = draw(case, path, sds.shape, floating, kind == "train")
        return v if floating else v.astype(sds.dtype)

    args = map_paths(leaf, abstract)
    if kind == "decode":
        args[1]["cur"] = np.int32(CUR)
    with mesh:
        jitted = jax.jit(step, in_shardings=tree_named(mesh, in_specs),
                         out_shardings=None if out_specs is None else tree_named(mesh, out_specs))
        result = jitted(*args)
    for path, x in leaves(result):
        out[f"{case}{path}"] = np.asarray(x)
np.savez(f"{out_dir}/reference.npz", **out)
'''


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def outputs(tmp_path_factory):
    """{"partitioned", "single", "reference"}: {case index: {path: array}}
    of the gloo ranks' partitioned steps, the single-process port's and the
    reference's partitioned program (both runs at once)."""
    out = tmp_path_factory.mktemp("partitioned")
    (out / "worker.py").write_text(_WORKER)
    (out / "reference.py").write_text(_REFERENCE)
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src"), "OMP_NUM_THREADS": "1"}
    ref_env = {**env, "XLA_FLAGS": "--xla_force_host_platform_device_count=8",
               "JAX_PLATFORMS": "cpu"}
    procs = [subprocess.Popen([sys.executable, "worker.py", str(_free_port()), str(out)],
                              env=env, cwd=out, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True),
             subprocess.Popen([sys.executable, "reference.py", str(out)], env=ref_env, cwd=out,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)]
    try:
        for proc in procs:
            _, err = proc.communicate(timeout=600)
            assert proc.returncode == 0, err[-6000:]
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    result = {}
    for name in ("partitioned", "single", "reference"):
        with np.load(out / f"{name}.npz") as f:
            by_case = {}
            for key in f.files:
                case, _, path = key.partition("/")
                by_case.setdefault(int(case), {})["/" + path] = f[key]
            result[name] = by_case
    return result


def worst_gaps(got: dict, want: dict) -> dict:
    """{case: (path, largest |got - want|)}; every output of one is an
    output of the other, of the same shape."""
    gaps = {}
    for case, w in want.items():
        g = got[case]
        assert set(g) == set(w), (case, set(g) ^ set(w))
        diffs = {}
        for path in w:
            a, b = np.asarray(g[path], np.float64), np.asarray(w[path], np.float64)
            assert a.shape == b.shape, (case, path, a.shape, b.shape)
            finite = bool(np.isfinite(b).all())
            diffs[path] = float(np.abs(a - b).max()) if finite and a.size else (
                0.0 if a.size == 0 else float("inf"))
        gaps[case] = max(diffs.items(), key=lambda kv: kv[1])
    return gaps


def test_partitioned_steps_on_eight_gloo_ranks_give_the_references_answers(outputs):
    assert sorted(outputs["reference"]) == list(range(6))
    for case, (path, gap) in worst_gaps(outputs["partitioned"], outputs["reference"]).items():
        assert gap <= TOL, (case, path, gap)
    train = outputs["reference"][0]
    assert {"/2/loss", "/2/grad_norm"} <= set(train)  # the metrics, beside every parameter
    assert any(k.startswith("/0/groups") for k in train)
    assert any(k.startswith("/1/pos0") for k in outputs["reference"][4])


def test_partitioned_steps_on_eight_gloo_ranks_give_the_single_process_answers(outputs):
    assert sorted(outputs["single"]) == list(range(6))
    for case, (path, gap) in worst_gaps(outputs["partitioned"], outputs["single"]).items():
        assert gap <= TOL, (case, path, gap)


if __name__ == "__main__":
    pytest.main([__file__, "-q"])
