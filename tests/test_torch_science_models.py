"""The port's science models (``models/dimenet.py``, ``mace.py``,
``graphcast.py``), their configs and batch builders against the reference
package on the CPU.

At each smoke config, on the reference's smoke batches (``launch/train.py``:
64 atoms, 256 edges, 4 molecules; GraphCast 128 grid nodes, 512 edges) built
by both packages from the same seed, the reference's params go through
``params_from_reference``; ``forward``, ``loss_fn`` and the gradients by
autograd agree with the reference's and ``jax.grad``'s within 1e-5 at f32
(rtol, and atol 1e-5 of each leaf's largest |value|: f32 sums in another
order than XLA's) and within 3e-2 for GraphCast in its bf16 config (one
bf16 rounding of activations of magnitude ~2.5 is 0.0156).  The same holds
with edge ids outside [0, n), which the reference's gathers clamp or wrap
and its ``segment_sum`` drops.  ``synthetic_gc_batch`` and
``graphcast_sizes`` equal the reference's bit for bit, and so do the GNN
shape tables.  Then the reference's ``test_models_equivariance.py``
properties on the port, as seeded cases: MACE and DimeNet energies invariant
under rotations and translations, MACE forces equivariant, MACE energies
invariant under a relabelling of the atoms.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import common as ref_common
from repro.configs import dimenet_cfg as ref_dimenet_cfg
from repro.configs import graphcast_cfg as ref_graphcast_cfg
from repro.configs import mace_cfg as ref_mace_cfg
from repro.data import graph as ref_graph
from repro.models import dimenet as ref_dimenet
from repro.models import graphcast as ref_graphcast
from repro.models import mace as ref_mace
from repro_torch.configs import common, dimenet_cfg, graphcast_cfg, mace_cfg
from repro_torch.data import graph
from repro_torch.models import dimenet, graphcast, mace
from repro_torch.optim.tree import flatten_with_paths, unflatten

TOL = {torch.float32: 1e-5, torch.bfloat16: 3e-2}
MODELS = {"dimenet": (ref_dimenet, dimenet, ref_dimenet_cfg, dimenet_cfg),
          "mace": (ref_mace, mace, ref_mace_cfg, mace_cfg),
          "graphcast": (ref_graphcast, graphcast, ref_graphcast_cfg, graphcast_cfg)}
JAX_DTYPE = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}


def close(got, want, tol):
    want = np.asarray(want, np.float32)
    np.testing.assert_allclose(np.asarray(got, np.float32), want, rtol=tol,
                               atol=tol * max(1e-3, float(np.abs(want).max())))


def _batches(name, cfg, seed=0, edit=None):
    """The reference's smoke batch for ``name`` from both packages (same
    seed, so the same arrays), with ``edit(field, array)`` applied to both."""
    if name == "graphcast":
        kw = dict(n_nodes=128, n_edges=512, n_vars=cfg.n_vars, seed=seed)
        ref_b, b = ref_graph.synthetic_gc_batch(**kw), graph.synthetic_gc_batch(**kw, device="cpu")
    else:
        kw = dict(n_nodes=64, n_edges=256, with_pos=True, n_species=cfg.n_species, n_graphs=4,
                  with_triplets=name == "dimenet", seed=seed)
        ref_b = ref_graph.synthetic_graph_batch(**kw)
        b = graph.synthetic_graph_batch(**kw, device="cpu")
    if edit is not None:
        for field, fn in edit.items():
            a = fn(np.array(getattr(ref_b, field)))
            ref_b = dataclasses.replace(ref_b, **{field: jnp.asarray(a)})
            b = dataclasses.replace(b, **{field: torch.from_numpy(a)})
    return ref_b, b


def _models(name, dtype=None, seed=0):
    ref_m, m, ref_cfg_mod, cfg_mod = MODELS[name]
    ref_cfg, cfg = ref_cfg_mod.smoke_config(), cfg_mod.smoke_config()
    if dtype is not None:
        ref_cfg = dataclasses.replace(ref_cfg, dtype=JAX_DTYPE[dtype])
        cfg = dataclasses.replace(cfg, dtype=dtype)
    ref_p = ref_m.init_params(jax.random.PRNGKey(seed), ref_cfg)
    p = m.params_from_reference(jax.tree.map(np.asarray, ref_p), cfg, "cpu")
    return ref_m, m, ref_cfg, cfg, ref_p, p


def _port_grads(m, params, batch, cfg):
    pairs, spec = flatten_with_paths(params)
    flat = [t.detach().requires_grad_(True) for _, t in pairs]
    value = m.loss_fn(unflatten(spec, flat), batch, cfg)
    grads = torch.autograd.grad(value, flat, allow_unused=True)
    # a parameter the loss does not reach (MACE's l=1, l=2 mixers: the energy
    # reads only the scalars) has gradient 0, as jax.grad gives it
    return value.detach(), [torch.zeros_like(f) if g is None else g for f, g in zip(flat, grads)]


def _check_against_reference(name, dtype, edit=None):
    ref_m, m, ref_cfg, cfg, ref_p, p = _models(name, dtype)
    ref_b, b = _batches(name, cfg, edit=edit)
    tol = TOL[cfg.dtype]
    close(m.forward(p, b, cfg).detach().numpy(), ref_m.forward(ref_p, ref_b, ref_cfg), tol)
    want_l, want = jax.value_and_grad(ref_m.loss_fn)(ref_p, ref_b, ref_cfg)
    got_l, got = _port_grads(m, p, b, cfg)
    close(float(got_l), float(want_l), tol)
    want_pairs, _ = flatten_with_paths(jax.tree.map(np.asarray, want))
    assert len(want_pairs) == len(got)
    for g, (path, w) in zip(got, want_pairs):
        close(g.float().numpy(), w, tol)


@pytest.mark.parametrize("name,dtype", [("dimenet", None), ("mace", None),
                                        ("graphcast", torch.float32), ("graphcast", None)])
def test_forward_loss_and_gradients_match_jax_grad(name, dtype):
    """graphcast's smoke config is bf16 (``dtype=None``); at f32 it is held at 1e-5."""
    _check_against_reference(name, dtype)


def _out_of_range(n):
    def edit(a):
        a = a.copy()
        a[::7] = n + 3   # past the last segment: dropped from the sums, clamped in gathers
        a[3::11] = -1    # wraps in gathers, dropped from the sums
        a[5::13] = -n - 2
        return a
    return edit


@pytest.mark.parametrize("name,fields", [
    ("dimenet", ("edge_dst",)), ("mace", ("edge_dst", "edge_src")),
    ("graphcast", ("g2m_dst", "mesh_dst", "m2g_dst"))])
def test_out_of_range_ids_in_the_segment_sums(name, fields):
    _, _, _, cfg, _, _ = _models(name)
    n = {"edge_dst": 64, "edge_src": 64, "g2m_dst": 32, "mesh_dst": 32, "m2g_dst": 128}
    _check_against_reference(name, torch.float32 if name == "graphcast" else None,
                             edit={f: _out_of_range(n[f]) for f in fields})


def test_dimenet_triplets_outside_the_edge_range():
    """Triplet ids past the edge count: their messages drop from the sum
    over k, their gathers clamp, as the reference's."""
    def edit(a):
        a = a.copy()
        a[::5, 1] = 256 + 4
        a[2::9, 0] = -3
        return a

    _check_against_reference("dimenet", None, edit={"edge_attr": edit})


@pytest.mark.parametrize("n,e,n_vars,seed", [(128, 512, 8, 0), (64, 100, 227, 3),
                                             (10, 7, 4, 5), (3000, 9000, 16, 11)])
def test_gc_batch_and_sizes_are_the_references(n, e, n_vars, seed):
    assert graph.graphcast_sizes(n, e) == ref_graph.graphcast_sizes(n, e)
    got = graph.synthetic_gc_batch(n_nodes=n, n_edges=e, n_vars=n_vars, seed=seed, device="cpu")
    want = ref_graph.synthetic_gc_batch(n_nodes=n, n_edges=e, n_vars=n_vars, seed=seed)
    for f in dataclasses.fields(want):
        a, b = getattr(got, f.name), getattr(want, f.name)
        if isinstance(b, int):
            assert a == b, f.name
        else:
            assert a.dtype == torch.from_numpy(np.asarray(b)).dtype, f.name
            np.testing.assert_array_equal(a.numpy(), np.asarray(b), err_msg=f.name)


def test_gnn_shape_tables_are_the_references():
    assert common.GNN_SHAPES == ref_common.GNN_SHAPES
    assert common.TRIPLET_CAP_FACTOR == ref_common.TRIPLET_CAP_FACTOR
    for name in common.GNN_SHAPES:
        assert common._gnn_sizes(name) == ref_common._gnn_sizes(name)
        n, e, _ = common._gnn_sizes(name)
        assert graph.graphcast_sizes(n, e) == ref_graph.graphcast_sizes(n, e)
    assert common.MINIBATCH_SUBGRAPH(1024, (15, 10)) == ref_common.MINIBATCH_SUBGRAPH(
        1024, (15, 10)) == (180224, 179200)


@pytest.mark.parametrize("name", sorted(MODELS))
def test_configs_are_the_references(name):
    _, _, ref_cfg_mod, cfg_mod = MODELS[name]
    for which in ("full_config", "smoke_config"):
        ref_cfg, cfg = getattr(ref_cfg_mod, which)(), getattr(cfg_mod, which)()
        for f in dataclasses.fields(ref_cfg):
            if f.name != "dtype":
                assert getattr(cfg, f.name) == getattr(ref_cfg, f.name), (name, f.name)
    assert cfg_mod.ARCH_ID == ref_cfg_mod.ARCH_ID and cfg_mod.MODEL == ref_cfg_mod.MODEL
    assert graphcast_cfg.full_config().dtype == torch.bfloat16


@pytest.mark.parametrize("name", sorted(MODELS))
def test_init_params_mirror_the_reference_tree(name):
    _, m, _, cfg, ref_p, _ = _models(name)
    p = m.init_params(torch.Generator().manual_seed(0), cfg, device="cpu")
    shapes = jax.tree.map(lambda t: tuple(t.shape), p, is_leaf=torch.is_tensor)
    assert shapes == jax.tree.map(lambda a: tuple(a.shape), ref_p)
    tree = jax.tree.map(np.asarray, ref_p)
    head = "out_mlp" if name == "graphcast" else "readout"
    tree[head][0]["w"] = tree[head][0]["w"][:, :-1]
    with pytest.raises(ValueError, match=rf"{head}\[0\].w"):
        m.params_from_reference(tree, cfg, "cpu")
    del tree[head]
    with pytest.raises(ValueError, match="keys"):
        m.params_from_reference(tree, cfg, "cpu")


def test_graphcast_remat_changes_no_bit():
    _, _, _, cfg, _, p = _models("graphcast", torch.float32)
    _, b = _batches("graphcast", cfg)
    on = _port_grads(graphcast, p, b, cfg)
    off = _port_grads(graphcast, p, b, dataclasses.replace(cfg, remat=False))
    assert torch.equal(on[0], off[0]) and all(torch.equal(a, c) for a, c in zip(on[1], off[1]))


# ---- the reference's equivariance properties, on the port, as seeded cases
def _rotation(seed):
    rng = np.random.default_rng(seed)
    a, b, c = rng.uniform(0, 2 * np.pi, 3)
    rz = np.array([[np.cos(a), -np.sin(a), 0], [np.sin(a), np.cos(a), 0], [0, 0, 1]])
    rx = np.array([[1, 0, 0], [0, np.cos(b), -np.sin(b)], [0, np.sin(b), np.cos(b)]])
    ry = np.array([[np.cos(c), 0, np.sin(c)], [0, 1, 0], [-np.sin(c), 0, np.cos(c)]])
    return (rz @ rx @ ry).astype(np.float32)


def _moved(batch, rot, shift):
    pos = torch.from_numpy(batch.pos.numpy() @ rot.T + shift)
    return dataclasses.replace(batch, pos=pos)


MACE_SMALL = mace.MACEConfig(channels=8, n_rbf=4, n_species=4)
DIMENET_SMALL = dimenet.DimeNetConfig(n_blocks=2, d_hidden=16, n_bilinear=4, n_spherical=3,
                                      n_radial=3, n_species=4)


@pytest.mark.parametrize("seed", range(5))
def test_mace_invariance(seed):
    params = mace.init_params(torch.Generator().manual_seed(0), MACE_SMALL, device="cpu")
    b = graph.synthetic_graph_batch(n_nodes=24, n_edges=80, with_pos=True, n_species=4,
                                    n_graphs=2, seed=seed, device="cpu")
    rot, shift = _rotation(seed), np.float32(np.random.default_rng(seed).normal(size=3))
    e0 = mace.forward(params, b, MACE_SMALL)
    e1 = mace.forward(params, _moved(b, rot, shift), MACE_SMALL)
    np.testing.assert_allclose(e0.numpy(), e1.numpy(), rtol=1e-4, atol=1e-4)


def _forces(params, batch):
    pos = batch.pos.clone().requires_grad_(True)
    e = mace.forward(params, dataclasses.replace(batch, pos=pos), MACE_SMALL).sum()
    return -torch.autograd.grad(e, pos)[0].numpy()


def _without_self_loops(b):
    keep = b.edge_src != b.edge_dst
    return dataclasses.replace(b, edge_src=b.edge_src[keep], edge_dst=b.edge_dst[keep],
                               edge_mask=b.edge_mask[keep], n_edges=int(keep.sum()))


@pytest.mark.parametrize("seed", range(3))
def test_mace_force_equivariance(seed):
    """Forces (−∂E/∂pos) rotate with the frame: F(Rx) = R·F(x), on the
    reference test's molecules without their self-loop edges (an atom bonded
    to itself; ROADMAP C.25: there r = 0, and ``r / max(|r|, 1e-6)`` sends
    ±1e6 times a gradient into one row, where they cancel up to f32
    rounding, ~1e-3 on these molecules; the reference's forces are NaN
    there, and its test passes on NaN = NaN)."""
    params = mace.init_params(torch.Generator().manual_seed(0), MACE_SMALL, device="cpu")
    b = _without_self_loops(graph.synthetic_graph_batch(
        n_nodes=16, n_edges=48, with_pos=True, n_species=4, seed=seed + 1, device="cpu"))
    rot = _rotation(seed + 3)
    f0 = _forces(params, b)
    f1 = _forces(params, _moved(b, rot, np.zeros(3, np.float32)))
    np.testing.assert_allclose(f1, f0 @ rot.T, rtol=1e-3, atol=1e-4)


def test_c25_mace_forces_at_self_loops():
    """C.25: with self-loop edges the reference's MACE forces are NaN (the
    gradient of ``jnp.linalg.norm`` at 0); the port's are finite (torch's
    norm has gradient 0 at 0)."""
    from repro.data import synthetic_graph_batch as ref_batch

    rp = ref_mace.init_params(jax.random.PRNGKey(0), ref_mace.MACEConfig(
        channels=8, n_rbf=4, n_species=4))
    params = mace.params_from_reference(jax.tree.map(np.asarray, rp), MACE_SMALL, "cpu")
    rb = ref_batch(n_nodes=16, n_edges=48, with_pos=True, n_species=4, seed=1)
    b = graph.synthetic_graph_batch(n_nodes=16, n_edges=48, with_pos=True, n_species=4, seed=1,
                                    device="cpu")
    assert int((b.edge_src == b.edge_dst).sum()) == 5
    ref_f = jax.grad(lambda pos: ref_mace.forward(rp, dataclasses.replace(rb, pos=pos),
                                                  ref_mace.MACEConfig(channels=8, n_rbf=4,
                                                                      n_species=4)).sum())(rb.pos)
    assert np.isnan(np.asarray(ref_f)).any()
    assert np.isfinite(_forces(params, b)).all()


@pytest.mark.parametrize("seed", range(5))
def test_dimenet_invariance(seed):
    params = dimenet.init_params(torch.Generator().manual_seed(0), DIMENET_SMALL, device="cpu")
    b = graph.synthetic_graph_batch(n_nodes=20, n_edges=60, with_pos=True, n_species=4,
                                    with_triplets=True, seed=seed, device="cpu")
    rot, shift = _rotation(seed + 1), np.float32([1.0, -2.0, 0.5])
    e0 = dimenet.forward(params, b, DIMENET_SMALL)
    e1 = dimenet.forward(params, _moved(b, rot, shift), DIMENET_SMALL)
    np.testing.assert_allclose(e0.numpy(), e1.numpy(), rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("seed", range(3))
def test_mace_permutation_invariance(seed):
    """Energy invariant under relabelling the atoms (a permutation of node ids)."""
    params = mace.init_params(torch.Generator().manual_seed(0), MACE_SMALL, device="cpu")
    b = graph.synthetic_graph_batch(n_nodes=12, n_edges=36, with_pos=True, n_species=4,
                                    seed=seed + 5, device="cpu")
    perm = torch.from_numpy(np.random.default_rng(seed).permutation(12))
    inv = torch.argsort(perm).to(torch.int32)
    b2 = dataclasses.replace(
        b, pos=b.pos[perm], species=b.species[perm], edge_src=inv[b.edge_src.long()],
        edge_dst=inv[b.edge_dst.long()], graph_ids=b.graph_ids[perm], node_mask=b.node_mask[perm])
    np.testing.assert_allclose(mace.forward(params, b, MACE_SMALL).numpy(),
                               mace.forward(params, b2, MACE_SMALL).numpy(), rtol=1e-4, atol=1e-4)
