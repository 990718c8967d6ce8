"""Basis kernels vs closed forms and autodiff (SURVEY.md §4 test plan)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from kanodes.ops import basis as B


GRID = B.make_grid(5)
H = B.default_denominator(5)
X = jnp.linspace(-0.97, 0.97, 23)


def _numpy_ref(name, x, grid, h):
    y = (np.asarray(x)[..., None] - np.asarray(grid)) / h
    if name == "rbf":
        return np.exp(-y ** 2)
    if name == "rswaf":
        return 1.0 / np.cosh(y) ** 2
    if name == "iqf":
        return 1.0 / (1.0 + y ** 2)
    raise AssertionError(name)


@pytest.mark.parametrize("name", ["rbf", "rswaf", "iqf"])
def test_closed_form(name):
    got = B.get_basis(name)(X, GRID, H)
    want = _numpy_ref(name, X, GRID, H)
    assert got.shape == (23, 5)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("name", ["rbf", "rswaf", "iqf"])
def test_autodiff_matches_closed_form_derivative(name):
    fn = B.get_basis(name)
    dfn = B.BASIS_DX[name]

    def scalar(x):
        return fn(x, GRID, H)

    got = jax.vmap(jax.jacfwd(scalar))(X)       # [23, 5]
    want = dfn(X, GRID, H)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("name", ["rbf", "rswaf", "iqf"])
def test_second_order_autodiff_is_finite(name):
    # KAN-PINN needs grad-of-grad through the bases
    fn = B.get_basis(name)

    def s(x):
        return jnp.sum(fn(x, GRID, H) ** 2)

    h = jax.hessian(s)(jnp.asarray(0.3))
    assert jnp.isfinite(h)


def test_rbf_peak_at_centers():
    vals = B.rbf(GRID, GRID, H)  # [5, 5]
    np.testing.assert_allclose(np.diag(vals), 1.0, rtol=1e-6)


def test_bspline_partition_of_unity():
    k = 3
    grid = B.make_bspline_grid(in_dims=2, grid_size=5, k=k)
    x = jnp.stack([jnp.linspace(-0.9, 0.9, 17),
                   jnp.linspace(-0.5, 0.5, 17)], axis=-1)  # [17, 2]
    bas = B.bspline_basis(x, grid, k)
    assert bas.shape == (17, 2, 5 + k)
    np.testing.assert_allclose(bas.sum(-1), 1.0, rtol=1e-5, atol=1e-5)
    assert bool(jnp.all(bas >= -1e-6))


def test_bspline_grad_flows():
    k = 3
    grid = B.make_bspline_grid(1, 5, k)

    def f(x):
        return jnp.sum(B.bspline_basis(x, grid, k) ** 2)

    g = jax.grad(f)(jnp.asarray([0.21]))
    assert jnp.all(jnp.isfinite(g))


class TestFourierBasis:
    def test_matches_numpy(self):
        from kanodes.ops.basis import fourier, make_grid

        x = np.linspace(-1, 1, 23).astype(np.float32)
        for G in (1, 2, 3, 4, 7, 10):
            got = np.asarray(fourier(jnp.asarray(x), make_grid(G), 0.5))
            assert got.shape == (23, G)
            want_cols = [np.ones_like(x)]
            k = 1
            while len(want_cols) < G:
                want_cols.append(np.sin(k * np.pi * x))
                if len(want_cols) < G:
                    want_cols.append(np.cos(k * np.pi * x))
                k += 1
            np.testing.assert_allclose(got, np.stack(want_cols, -1),
                                       rtol=2e-5, atol=2e-5)

    def test_periodicity(self):
        from kanodes.ops.basis import fourier, make_grid

        grid = make_grid(7)
        x = jnp.asarray(np.linspace(-1, 1, 11), jnp.float32)
        a = np.asarray(fourier(x, grid, 0.5))
        b = np.asarray(fourier(x + 2.0, grid, 0.5))
        np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-4)

    def test_dx_matches_autodiff(self):
        from kanodes.ops.basis import fourier, fourier_dx, make_grid

        G = 8
        grid = make_grid(G)
        xs = jnp.asarray(np.linspace(-0.98, 0.98, 17), jnp.float32)
        want = jax.vmap(jax.jacfwd(lambda v: fourier(v, grid, 0.5)))(xs)
        got = fourier_dx(xs, grid, 0.5)
        np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                                   rtol=1e-4, atol=1e-4)


class TestChebyBasis:
    def test_matches_numpy_chebyshev(self):
        from kanodes.ops.basis import cheby, make_grid

        for G in (1, 2, 3, 5, 10):
            grid = make_grid(G)
            x = jnp.asarray(np.linspace(-1, 1, 23), jnp.float32)
            got = np.asarray(cheby(x, grid, 0.5))       # [23, G]
            for k in range(G):
                coef = np.zeros(G)
                coef[k] = 1.0
                want = np.polynomial.chebyshev.chebval(np.asarray(x), coef)
                np.testing.assert_allclose(got[:, k], want,
                                           rtol=2e-5, atol=2e-5)

    def test_dx_matches_autodiff(self):
        from kanodes.ops.basis import cheby, cheby_dx, make_grid

        G = 6
        grid = make_grid(G)
        xs = jnp.asarray(np.linspace(-0.98, 0.98, 17), jnp.float32)
        want = jax.vmap(jax.jacfwd(lambda v: cheby(v, grid, 0.5)))(xs)
        got = cheby_dx(xs, grid, 0.5)
        np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                                   rtol=1e-4, atol=1e-5)
        # outside the domain the derivative is zero (clip semantics)
        far = jnp.asarray([1.5, -2.0], jnp.float32)
        np.testing.assert_array_equal(
            np.asarray(cheby_dx(far, grid, 0.5)[..., 1:]), 0.0)

    def test_kdense_fourier_trains(self):
        """KDense(basis='fourier') fits a periodic 1-D target (the
        FourierKAN-style variant is a drop-in on the XLA path)."""
        import optax

        from kanodes.models import KANChain

        chain = KANChain.mlp_like([1, 4, 1], grid_len=7, basis="fourier")
        params = chain.init(jax.random.PRNGKey(0))
        x = jnp.asarray(np.linspace(-2, 2, 64)[:, None], jnp.float32)
        y = jnp.sin(1.7 * x)

        def loss(p):
            return jnp.mean((chain.apply(p, x) - y) ** 2)

        opt = optax.adam(2e-2)
        s = opt.init(params)
        l0 = float(loss(params))

        @jax.jit
        def step(p, s):
            g = jax.grad(loss)(p)
            u, s = opt.update(g, s, p)
            return optax.apply_updates(p, u), s

        for _ in range(300):
            params, s = step(params, s)
        assert float(loss(params)) < l0 * 1e-2

    def test_kdense_cheby_trains(self):
        """KDense(basis='cheby') fits a smooth 1-D target (the
        polynomial-basis KAN variant is a drop-in on the XLA path)."""
        import optax

        from kanodes.models import KANChain

        chain = KANChain.mlp_like([1, 4, 1], grid_len=6, basis="cheby")
        params = chain.init(jax.random.PRNGKey(0))
        x = jnp.asarray(np.linspace(-2, 2, 64)[:, None], jnp.float32)
        y = jnp.sin(1.7 * x)

        def loss(p):
            return jnp.mean((chain.apply(p, x) - y) ** 2)

        opt = optax.adam(2e-2)
        s = opt.init(params)
        l0 = float(loss(params))

        @jax.jit
        def step(p, s):
            g = jax.grad(loss)(p)
            u, s = opt.update(g, s, p)
            return optax.apply_updates(p, u), s

        for _ in range(300):
            params, s = step(params, s)
        assert float(loss(params)) < l0 * 1e-2
