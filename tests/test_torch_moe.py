"""The port's mixture-of-experts FFN (``nn/moe.py``) against the reference
package on the CPU.

``moe_capacity`` equals the reference's on a grid of sizes.  ``moe_ffn``
at f32 over every ``renorm`` × gated × ``dispatch`` × ``n_groups`` ×
``virtual_split``, at the default capacity factor and at one small enough
to drop (choice, token) pairs: the experts each token picks equal, bit for
bit, those the reference's ``lax.top_k`` picked (recorded from its call),
and the slot positions, the kept pairs and the drop count equal those the
reference's choice-major formula gives for them; the output and the aux
loss agree within 1e-5 (rtol, and atol 1e-5 of the largest |output|: f32
products summed in another order than XLA's).  All-zero tokens, whose
logits tie for every expert, route to experts 0 and 1 as ``lax.top_k``
breaks ties.  Gradients of the output and the aux loss to the router, the
experts and the tokens, dropped pairs included, agree with ``jax.grad``
within 1e-5 of each leaf's largest |gradient|.
"""
import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.nn import moe as RM
from repro_torch.nn import moe as M

TOL = 1e-5
T, D, F, E, K = 64, 16, 32, 4, 2
ZERO_ROWS = 5  # the first tokens are all zero: every expert's logit ties


def close(got, want, tol=TOL):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=tol,
                               atol=tol * max(1e-3, float(np.abs(want).max())))


def _inputs(gated, s, seed=0):
    p = RM.init_moe(jax.random.PRNGKey(seed), D, F, E, gated=gated, virtual_split=s)
    x = np.random.default_rng(seed + 1).standard_normal((T, D)).astype(np.float32)
    x[:ZERO_ROWS] = 0
    pt = jax.tree.map(lambda a: torch.from_numpy(np.array(a)), p)
    return p, pt, x


def _ref_positions(idx, capacity):
    """The reference's choice-major slot positions (``moe.py:123-129``) of
    the choices ``idx`` (G, Tg, k), in numpy."""
    g, tg, k = idx.shape
    ohf = np.eye(E, dtype=np.int64)[idx].transpose(0, 2, 1, 3).reshape(g, k * tg, E)
    pos = np.sum((np.cumsum(ohf, axis=1) - 1) * ohf, axis=-1)
    return pos, pos < capacity


@pytest.mark.parametrize("n,e,k,f", list(itertools.product(
    (1, 7, 512, 8192), (4, 8, 16), (2, 4), (0.3, 1.25))))
def test_moe_capacity_matches_reference(n, e, k, f):
    assert M.moe_capacity(n, e, k, f) == RM.moe_capacity(n, e, k, f)


CASES = list(itertools.product(("topk", "full"), (True, False), ("scatter", "einsum"), (1, 2),
                               (1, 2), (1.25, 0.3)))


@pytest.mark.parametrize("renorm,gated,dispatch,groups,split,cf", CASES)
def test_moe_ffn_matches_reference(renorm, gated, dispatch, groups, split, cf, monkeypatch):
    p, pt, x = _inputs(gated, split)
    picked = []
    top_k = jax.lax.top_k

    def recording(v, k):
        out = top_k(v, k)
        picked.append(np.asarray(out[1]))
        return out

    monkeypatch.setattr(jax.lax, "top_k", recording)
    kw = dict(top_k=K, capacity_factor=cf, renorm=renorm, dispatch=dispatch, n_groups=groups,
              virtual_split=split)
    want, want_aux = RM.moe_ffn(p, jnp.asarray(x), **kw)
    got, aux = M.moe_ffn(pt, torch.from_numpy(x), **kw)
    close(got.numpy(), want)
    close(float(aux), float(want_aux))

    (ref_idx,) = picked
    r = M.route(pt["router"], torch.from_numpy(x).reshape(groups, T // groups, D), n_experts=E,
                top_k=K, capacity_factor=cf, renorm=renorm)
    assert r.capacity == RM.moe_capacity(T // groups, E, K, cf)
    np.testing.assert_array_equal(r.idx.numpy(), ref_idx)
    pos, keep = _ref_positions(ref_idx, r.capacity)
    np.testing.assert_array_equal(r.pos.numpy(), pos)
    np.testing.assert_array_equal(r.keep.numpy(), keep)
    assert int(r.dropped) == int((~keep).sum())
    assert (int(r.dropped) > 0) == (cf < 1)  # the small factor drops pairs, the default none
    # all-zero tokens tie on every expert: the lower experts first, as lax.top_k
    np.testing.assert_array_equal(r.idx.numpy()[0, :ZERO_ROWS], [[0, 1]] * ZERO_ROWS)
    close(float(r.aux), float(want_aux))


@pytest.mark.parametrize("renorm,dispatch,split,cf", list(itertools.product(
    ("topk", "full"), ("scatter", "einsum"), (1, 2), (1.25, 0.3))))
def test_moe_gradients_match_jax_grad(renorm, dispatch, split, cf):
    p, pt, x = _inputs(True, split, seed=3)
    cot = np.random.default_rng(9).standard_normal((T, D)).astype(np.float32)
    kw = dict(top_k=K, capacity_factor=cf, renorm=renorm, dispatch=dispatch, n_groups=2,
              virtual_split=split)

    def ref_loss(p, x):
        out, aux = RM.moe_ffn(p, x, **kw)
        return jnp.sum(out * cot) + 0.5 * aux

    want_p, want_x = jax.grad(ref_loss, argnums=(0, 1))(p, jnp.asarray(x))
    leaves, spec = jax.tree_util.tree_flatten(pt)
    leaves = [t.clone().requires_grad_(True) for t in leaves]
    xt = torch.from_numpy(x).requires_grad_(True)
    out, aux = M.moe_ffn(jax.tree_util.tree_unflatten(spec, leaves), xt, **kw)
    grads = torch.autograd.grad(torch.sum(out * torch.from_numpy(cot)) + 0.5 * aux,
                                leaves + [xt])
    for g, w in zip(grads, jax.tree_util.tree_leaves(want_p) + [want_x]):
        close(g.numpy(), w)
    if cf < 1:  # dropped pairs pass no gradient: their tokens' only path is the router's
        assert int(M.route(pt["router"], torch.from_numpy(x).reshape(2, T // 2, D),
                           n_experts=E, top_k=K, capacity_factor=cf,
                           renorm=renorm).dropped) > 0


def test_moe_init_has_the_reference_layout():
    p = M.init_moe(torch.Generator().manual_seed(0), D, F, E, gated=True, virtual_split=2)
    want = RM.init_moe(jax.random.PRNGKey(0), D, F, E, gated=True, virtual_split=2)
    got = jax.tree.map(lambda t: tuple(t.shape), p, is_leaf=torch.is_tensor)
    assert got == jax.tree.map(lambda a: tuple(a.shape), want)
    assert 0.8 < float(p["down"].std()) * F ** 0.5 < 1.2
    assert 0.8 < float(p["up"].std()) * D ** 0.5 < 1.2
    with pytest.raises(ValueError, match="virtual_split"):
        M.init_moe(torch.Generator(), D, F, E, virtual_split=3)


def test_moe_ffn_refuses_what_the_reference_cannot_take():
    _, pt, x = _inputs(True, 1)
    with pytest.raises(ValueError, match="groups"):
        M.moe_ffn(pt, torch.from_numpy(x), top_k=K, n_groups=3)
    with pytest.raises(ValueError, match="renorm"):
        M.moe_ffn(pt, torch.from_numpy(x), top_k=K, renorm="softmax")
    with pytest.raises(ValueError, match="dispatch"):
        M.moe_ffn(pt, torch.from_numpy(x), top_k=K, dispatch="dense")
