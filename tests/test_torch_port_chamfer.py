"""PyTorch port, Chamfer distance: ``ops.chamfer`` -- on the CPU the plain
version of the CUDA kernel K4 -- against the JAX package's
``ops.chamfer`` and its Pallas kernel (interpret mode on the CPU, as
``tests/test_pallas_chamfer.py`` runs it), on the same seeded clouds.
Tolerances are that file's: rtol 1e-4, atol 1e-5."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from genre_shapehd_tpu.ops import chamfer as jch
from genre_shapehd_tpu.ops.pallas import (nndistance_pallas,
                                          nndistance_score_pallas)
from genre_shapehd_tpu.ops.pallas.chamfer_kernel import _one_sided_min
from genre_shapehd_tpu_torch.ops import chamfer as tch
from genre_shapehd_tpu_torch.ops.cuda import chamfer_kernel as ck

torch.set_num_threads(2)
TOL = dict(rtol=1e-4, atol=1e-5)
SHAPES = [((2, 700), (2, 1200)), ((1, 513), (1, 511))]


def _clouds(s1, s2, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(s1 + (3,)).astype(np.float32),
            rng.standard_normal(s2 + (3,)).astype(np.float32))


def _by_index(x, y, idx):
    """Squared distance from each x to the y its index names."""
    nn = np.take_along_axis(y, idx[..., None].astype(np.int64), axis=1)
    return ((x - nn) ** 2).sum(-1)


@pytest.mark.parametrize("s1,s2", SHAPES)
def test_nndistance_matches_jax_and_pallas(s1, s2):
    x1, x2 = _clouds(s1, s2, seed=s1[1])
    d1, d2 = tch.nndistance(torch.from_numpy(x1), torch.from_numpy(x2))
    r1, r2 = jch.nndistance(jnp.asarray(x1), jnp.asarray(x2))
    p1, p2 = nndistance_pallas(jnp.asarray(x1), jnp.asarray(x2))
    assert d1.shape == s1 and d2.shape == s2 and d1.dtype == torch.float32
    for got, ref, pal in ((d1, r1, p1), (d2, r2, p2)):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)
        np.testing.assert_allclose(got.numpy(), np.asarray(pal), **TOL)


@pytest.mark.parametrize("s1,s2", SHAPES)
def test_nndistance_w_idx_matches_jax(s1, s2):
    x1, x2 = _clouds(s1, s2, seed=3)
    d1, d2, i1, i2 = (t.numpy() for t in tch.nndistance_w_idx(
        torch.from_numpy(x1), torch.from_numpy(x2)))
    r1, r2, j1, j2 = (np.asarray(t) for t in jch.nndistance_w_idx(
        jnp.asarray(x1), jnp.asarray(x2)))
    assert i1.dtype == i2.dtype == np.int32
    np.testing.assert_allclose(d1, r1, **TOL)
    np.testing.assert_allclose(d2, r2, **TOL)
    # two distances can tie: hold the indices to the distances they give
    np.testing.assert_allclose(_by_index(x1, x2, i1), r1, **TOL)
    np.testing.assert_allclose(_by_index(x2, x1, i2), r2, **TOL)
    assert (i1 == j1).mean() > 0.99 and (i2 == j2).mean() > 0.99


@pytest.mark.parametrize("block", [256, 500])
def test_blocked_path_matches_jax_blocked_path(block):
    """``block`` < M: the column-blocked loop (ragged last block at 500)
    against the JAX package's scan and against the one-block path."""
    x1, x2 = _clouds((2, 700), (2, 1200), seed=4)
    t1, t2 = torch.from_numpy(x1), torch.from_numpy(x2)
    got = [t.numpy() for t in tch.nndistance_w_idx(t1, t2, block=block)]
    ref = [np.asarray(t) for t in jch.nndistance_w_idx(
        jnp.asarray(x1), jnp.asarray(x2), block=block)]
    whole = [t.numpy() for t in tch.nndistance_w_idx(t1, t2)]
    for k in (0, 1):
        assert got[k].shape == ref[k].shape == whole[k].shape
        np.testing.assert_allclose(got[k], ref[k], **TOL)
        np.testing.assert_allclose(got[k], whole[k], **TOL)
    np.testing.assert_allclose(_by_index(x1, x2, got[2]), ref[0], **TOL)
    np.testing.assert_allclose(_by_index(x2, x1, got[3]), ref[1], **TOL)
    d1, d2 = tch.nndistance(t1, t2, block=block)
    np.testing.assert_array_equal(d1.numpy(), got[0])
    np.testing.assert_array_equal(d2.numpy(), got[1])


def _with_ties(s1, s2, seed):
    """Clouds whose points repeat: every fifth point of x2 is an exact
    copy of an earlier one, and x1 holds copies of x2's points, so that
    distances tie exactly (at zero and above)."""
    x1, x2 = _clouds(s1, s2, seed)
    rng = np.random.default_rng(seed + 1)
    m = x2.shape[1]
    for j in range(1, m, 5):
        x2[:, j] = x2[:, rng.integers(0, j)]
    k = min(x1.shape[1], m)
    x1[:, :k:2] = x2[:, rng.integers(0, m, size=len(range(0, k, 2)))]
    return x1, x2


@pytest.mark.parametrize("s1,s2,ties", [
    ((2, 37), (2, 45), False), ((1, 1), (1, 300), False),
    ((2, 300), (2, 1), False), ((1, 1), (1, 1), False),
    ((2, 130), (2, 211), True), ((1, 1024), (1, 1024), True)])
def test_nn_min_dist_edge_clouds_match_jax(s1, s2, ties):
    """The plain version of K4, the arithmetic its card tests hold the
    kernel to, at the shapes the kernel's lane groups and chunks make
    edges of (N = 1, M = 1, N and M no multiple of a group of lanes or of
    a chunk) and on clouds with exact duplicates: distances against the
    JAX package's ``nndistance_w_idx`` and its Pallas ``_one_sided_min``
    (interpret mode on the CPU), indices through the distances they
    give."""
    x1, x2 = (_with_ties if ties else _clouds)(s1, s2, seed=s1[1] + s2[1])
    d1, d2, i1, i2 = (t.numpy() for t in ck.nn_min_dist(
        torch.from_numpy(x1), torch.from_numpy(x2)))
    r1, r2, _, _ = (np.asarray(t) for t in jch.nndistance_w_idx(
        jnp.asarray(x1), jnp.asarray(x2)))
    p1 = np.asarray(_one_sided_min(jnp.asarray(x1), jnp.asarray(x2)))
    p2 = np.asarray(_one_sided_min(jnp.asarray(x2), jnp.asarray(x1)))
    assert d1.shape == s1 and d2.shape == s2 and i1.dtype == np.int32
    for got, ref, pal in ((d1, r1, p1), (d2, r2, p2)):
        np.testing.assert_allclose(got, ref, **TOL)
        np.testing.assert_allclose(got, pal, **TOL)
    np.testing.assert_allclose(_by_index(x1, x2, i1), r1, **TOL)
    np.testing.assert_allclose(_by_index(x2, x1, i2), r2, **TOL)
    if ties:
        # the copies in x1 lie at distance 0 (the plain version's
        # expansion leaves at most atol there)
        copies = (min(s1[1], s2[1]) + 1) // 2
        assert ((d1 <= TOL["atol"]).sum(-1) >= copies).all()


def test_nndistance_score_matches_jax_and_pallas():
    x1, x2 = _clouds((2, 300), (2, 450), seed=5)
    got = tch.nndistance_score(torch.from_numpy(x1), torch.from_numpy(x2))
    ref = jch.nndistance_score(jnp.asarray(x1), jnp.asarray(x2))
    pal = nndistance_score_pallas(jnp.asarray(x1), jnp.asarray(x2))
    assert got.shape == (2,)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)
    np.testing.assert_allclose(got.numpy(), np.asarray(pal), **TOL)
    # identical zero clouds (what an empty iso-surface samples to) score
    # sqrt(1e-20) twice, not NaN
    z = torch.zeros(1, 64, 3)
    s = tch.nndistance_score(z, z)
    assert torch.isfinite(s).all() and float(s[0]) < 1e-9


def _loss_t(d1, d2):
    return d1.sum() + 0.5 * d2.sum()


def test_gradients_match_jax_grad():
    x1, x2 = _clouds((1, 40), (1, 60), seed=2)

    def loss(fn):
        return lambda a, b: (lambda d: jnp.sum(d[0]) + 0.5 * jnp.sum(d[1]))(
            fn(a, b))

    g_ref = jax.grad(loss(jch.nndistance), argnums=(0, 1))(
        jnp.asarray(x1), jnp.asarray(x2))
    g_pal = jax.grad(loss(nndistance_pallas), argnums=(0, 1))(
        jnp.asarray(x1), jnp.asarray(x2))
    t1 = torch.from_numpy(x1).requires_grad_()
    t2 = torch.from_numpy(x2).requires_grad_()
    _loss_t(*tch.nndistance(t1, t2)).backward()
    for got, ref, pal in zip((t1.grad, t2.grad), g_ref, g_pal):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)
        np.testing.assert_allclose(got.numpy(), np.asarray(pal), **TOL)


def test_kernel_backward_formula_matches_autograd_of_plain():
    """The CUDA path's backward (gather / scatter-add on the indices the
    kernel returns) is plain PyTorch: run it here on the plain version's
    indices against autograd through the plain version's minima."""
    x1, x2 = _clouds((2, 50), (2, 70), seed=6)
    t1 = torch.from_numpy(x1).requires_grad_()
    t2 = torch.from_numpy(x2).requires_grad_()
    d1, d2, i1, i2 = ck.nn_min_dist_plain(t1, t2)
    g1 = torch.from_numpy(np.random.default_rng(7).standard_normal(
        (2, 50)).astype(np.float32))
    g2 = torch.from_numpy(np.random.default_rng(8).standard_normal(
        (2, 70)).astype(np.float32))
    ((d1 * g1).sum() + (d2 * g2).sum()).backward()
    with torch.no_grad():
        dx1, dx2 = ck._scatter_grad(t1, t2, i1, g1)
        ex2, ex1 = ck._scatter_grad(t2, t1, i2, g2)
    np.testing.assert_allclose((dx1 + ex1).numpy(), t1.grad.numpy(), **TOL)
    np.testing.assert_allclose((dx2 + ex2).numpy(), t2.grad.numpy(), **TOL)


def test_bad_shapes_raise():
    with pytest.raises(ValueError):
        tch.nndistance(torch.zeros(1, 5, 2), torch.zeros(1, 5, 3))
    with pytest.raises(ValueError):
        tch.nndistance(torch.zeros(2, 5, 3), torch.zeros(1, 5, 3))
    with pytest.raises(ValueError):
        tch.nndistance(torch.zeros(1, 0, 3), torch.zeros(1, 5, 3))
