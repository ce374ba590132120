"""The port's SH colour fit (``neuray_tpu_torch/ops/sh.py``) against the
JAX package's ``neuray_tpu/ops/sh.py``, degrees 0-4, and the JAX package's
own SH tests (``tests/test_mixture_compositing_sh.py::test_sh_fit_*``)
run on the port.

Tolerances. ``sh_basis`` is a polynomial of the directions: 1e-6 up to
degree 3; degree 4's ``35 z^4 - 30 z^2 + 3`` cancels terms up to 35, and
the two packages' powers round it apart by up to 4 ulps of 8 (3.8e-6), so
2e-5 there (8 ulps of 35 are 1.7e-5). The fit solves the
normal equations through an explicit f32 inverse, whose error is the
condition number of ``lhs`` times f32's epsilon times the size of the
solution; both packages sit that far from a float64 solve (on these
inputs the largest error over ``cond * 2^-24 * |theta|`` is ~4.4 for each,
at condition numbers up to 8e5 on the near-singular rows). So each row is
held, against JAX and against float64, to ``8 * cond * 2^-24 * |theta|``
(``fit_bound``), and the zero-weight rows (well conditioned, cond < 250)
also to JAX at 1e-5. ``sh_predict`` is a dot of the basis with theta:
1e-5 absolute plus 1e-5 relative on the same theta.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from neuray_tpu.ops import sh as jSH

from neuray_tpu_torch.ops import sh as SH

torch.set_num_threads(1)

EPS32 = 2.0 ** -24


def t(x):
    return torch.from_numpy(np.array(x))


def unit_dirs(rng, *shape):
    d = rng.randn(*shape, 3)
    return (d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(np.float32)


@pytest.mark.parametrize("degree", range(5))
def test_sh_regs_equal_jax(degree):
    np.testing.assert_array_equal(SH.sh_regs(degree), jSH.sh_regs(degree))
    assert SH.sh_regs(degree).dtype == np.float32


@pytest.mark.parametrize("degree", range(5))
def test_sh_basis_matches_jax(degree):
    d = unit_dirs(np.random.RandomState(degree), 64, 5)
    ours = SH.sh_basis(t(d), degree).numpy()
    theirs = np.asarray(jSH.sh_basis(jnp.asarray(d), degree))
    assert ours.shape == theirs.shape == (64, 5, (degree + 1) ** 2)
    np.testing.assert_allclose(ours, theirs, rtol=0,
                               atol=2e-5 if degree == 4 else 1e-6)


def fit_inputs(degree, b=90, n=8):
    """Rows 0-29 with zero weights (the ``insufficient`` guard), rows
    30-59 near-singular (every direction within ~1e-3 of one), rows 60-89
    random; random colours and weights."""
    rng = np.random.RandomState(10 + degree)
    d = unit_dirs(rng, b, n)
    d[30:60] = d[30:60, :1] + 1e-3 * rng.randn(30, n, 3).astype(np.float32)
    c = rng.rand(b, n, 3).astype(np.float32)
    w = rng.rand(b, n).astype(np.float32)
    w[:30] = 0.0
    return d, c, w


def fit_bound(d, w, degree, theta64):
    """8 * cond(lhs) * 2^-24 * max |theta| per row, lhs in float64."""
    regs = torch.from_numpy(SH.sh_regs(degree)).double()
    A = SH.sh_basis(t(d).double(), degree)
    wd = t(w).double()
    wd = wd + (wd.sum(1, keepdim=True) < 1e-4) * 1e-4
    lhs = (A * wd[..., None]).transpose(-1, -2) @ A + torch.diag(regs)
    cond = np.linalg.cond(lhs.numpy())
    return 8 * cond * EPS32 * np.abs(theta64).max(axis=(1, 2)), cond


@pytest.mark.parametrize("degree", range(5))
def test_sh_fit_matches_jax(degree):
    d, c, w = fit_inputs(degree)
    regs = SH.sh_regs(degree)
    ours = SH.sh_fit(t(d), t(c), t(w), degree, t(regs)).numpy()
    theirs = np.asarray(jSH.sh_fit(jnp.asarray(d), jnp.asarray(c),
                                   jnp.asarray(w), degree, jnp.asarray(regs)))
    exact = SH.sh_fit(t(d).double(), t(c).double(), t(w).double(), degree,
                      t(regs).double()).numpy()
    k = (degree + 1) ** 2
    assert ours.shape == theirs.shape == (90, k, 3)
    assert ours.dtype == np.float32
    bound, cond = fit_bound(d, w, degree, exact)
    for name, other in (("jax", theirs), ("float64", exact)):
        err = np.abs(ours - other).max(axis=(1, 2))
        assert (err <= bound).all(), (name, (err / bound).max())
    err_jax = np.abs(theirs - exact).max(axis=(1, 2))
    assert (err_jax <= bound).all()
    assert (cond[:30] < 250).all()
    np.testing.assert_allclose(ours[:30], theirs[:30], rtol=0, atol=1e-5)
    if degree == 0:
        np.testing.assert_allclose(ours, theirs, rtol=0, atol=1e-5)


@pytest.mark.parametrize("degree", range(5))
def test_sh_predict_matches_jax(degree):
    rng = np.random.RandomState(20 + degree)
    d = unit_dirs(rng, 40, 3)
    theta = rng.randn(40, (degree + 1) ** 2, 3).astype(np.float32)
    ours = SH.sh_predict(t(d), t(theta), degree).numpy()
    theirs = np.asarray(jSH.sh_predict(jnp.asarray(d), jnp.asarray(theta),
                                       degree))
    np.testing.assert_allclose(ours, theirs, rtol=1e-5, atol=1e-5)


def test_sh_fit_default_regs_are_degree_3():
    d, c, w = fit_inputs(3)
    np.testing.assert_array_equal(
        SH.sh_fit(t(d), t(c), t(w)).numpy(),
        SH.sh_fit(t(d), t(c), t(w), 3, t(SH.sh_regs(3))).numpy())


def test_sh_fit_promotes_bf16_colours_to_f32():
    """A bf16 gather's colours are fitted in f32, as JAX promotes them."""
    d, c, w = fit_inputs(3)
    cb = t(c).to(torch.bfloat16)
    ours = SH.sh_fit(t(d), cb, t(w))
    assert ours.dtype == torch.float32
    np.testing.assert_array_equal(ours.numpy(),
                                  SH.sh_fit(t(d), cb.float(), t(w)).numpy())


# ---- the JAX package's own SH tests, on the port ----

def test_sh_fit_reconstructs_low_degree_signal(rng):
    """Fit colours generated by a known SH expansion; the prediction at
    held-out directions must match."""
    b, n, degree = 4, 60, 3
    k = (degree + 1) ** 2
    theta_gt = rng.randn(b, k, 3).astype(np.float32) * 0.3
    dirs = rng.randn(b, n, 3).astype(np.float32)
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
    colors = SH.sh_predict(t(dirs), t(theta_gt))
    theta = SH.sh_fit(t(dirs), colors, torch.ones((b, n)))
    test_dirs = rng.randn(b, 10, 3).astype(np.float32)
    test_dirs /= np.linalg.norm(test_dirs, axis=-1, keepdims=True)
    pred = SH.sh_predict(t(test_dirs), theta).numpy()
    expect = SH.sh_predict(t(test_dirs), t(theta_gt)).numpy()
    np.testing.assert_allclose(pred, expect, rtol=5e-2, atol=5e-2)


def test_sh_fit_zero_weights_stable(rng):
    b, n = 2, 16
    dirs = rng.randn(b, n, 3).astype(np.float32)
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
    colors = rng.rand(b, n, 3).astype(np.float32)
    theta = SH.sh_fit(t(dirs), t(colors), torch.zeros((b, n))).numpy()
    assert np.isfinite(theta).all()
