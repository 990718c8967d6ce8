"""L-BFGS polish (train/polish.py)."""

import jax
import jax.numpy as jnp
import numpy as np

from kanodes.train.polish import PolishConfig, polish, polish_members


def _rosenbrock(p):
    x, y = p["x"], p["y"]
    return jnp.sum(100.0 * (y - x ** 2) ** 2 + (1 - x) ** 2)


def test_polish_converges_rosenbrock():
    p0 = {"x": jnp.zeros(3), "y": jnp.zeros(3)}
    out = polish(_rosenbrock, p0, PolishConfig(iters=100))
    assert float(out["best_loss"]) < 1e-8
    np.testing.assert_allclose(np.asarray(out["params"]["x"]), 1.0,
                               atol=1e-4)
    assert out["loss_history"].shape == (100,)


def test_polish_never_returns_worse_than_input():
    p_opt = {"x": jnp.ones(2), "y": jnp.ones(2)}
    out = polish(_rosenbrock, p_opt, PolishConfig(iters=5))
    assert float(out["best_loss"]) <= float(_rosenbrock(p_opt))


def test_polish_beats_adam_tail_on_lv_like_least_squares():
    """A small ill-conditioned nonlinear least-squares: Adam stalls at
    its lr-wander floor, the quasi-Newton polish goes orders lower."""
    import optax

    key = jax.random.PRNGKey(0)
    A = jax.random.normal(key, (20, 8)) * jnp.logspace(0, -3, 8)
    target = jax.random.normal(jax.random.PRNGKey(1), (20,))

    def loss(w):
        return jnp.mean((jnp.tanh(A @ w) - jnp.tanh(A @ w0_true)) ** 2)

    w0_true = jax.random.normal(jax.random.PRNGKey(2), (8,))
    w = jnp.zeros(8)
    opt = optax.adam(1e-2)
    st = opt.init(w)

    @jax.jit
    def step(w, st):
        g = jax.grad(loss)(w)
        up, st = opt.update(g, st)
        return optax.apply_updates(w, up), st

    for _ in range(500):
        w, st = step(w, st)
    adam_floor = float(loss(w))

    out = polish(loss, w, PolishConfig(iters=50))
    assert float(out["best_loss"]) < adam_floor * 0.5, (
        float(out["best_loss"]), adam_floor)


def test_polish_members_matches_sequential():
    """One vmapped polish over S starts runs the same per-member math
    as S sequential polishes: short-horizon iterate parity (before f32
    rounding can diverge trajectories on the ill-conditioned banana),
    then convergence parity to the floor on a well-behaved objective."""
    starts = [{"x": jnp.full(3, 0.1 * s), "y": jnp.full(3, -0.05 * s)}
              for s in range(4)]
    stacked = jax.tree.map(lambda *xs: jnp.stack(xs), *starts)

    # (a) 5-iter loss-history parity on Rosenbrock
    cfg5 = PolishConfig(iters=5)
    seq5 = [polish(_rosenbrock, p, cfg5) for p in starts]
    out5 = polish_members(_rosenbrock, stacked, cfg5)
    assert out5["best_loss"].shape == (4,)
    assert out5["loss_history"].shape == (4, 5)
    for s, r in enumerate(seq5):
        np.testing.assert_allclose(np.asarray(out5["loss_history"][s]),
                                   np.asarray(r["loss_history"]),
                                   rtol=1e-4, atol=1e-7)

    # (b) both flows reach the same floor on a smooth least-squares
    A = jax.random.normal(jax.random.PRNGKey(0), (20, 8))
    w_true = jax.random.normal(jax.random.PRNGKey(1), (8,))

    def loss(w):
        return jnp.mean((A @ w - A @ w_true) ** 2)

    ws = [0.3 * jax.random.normal(jax.random.PRNGKey(10 + s), (8,))
          for s in range(4)]
    cfg = PolishConfig(iters=40)
    seq = [polish(loss, w, cfg) for w in ws]
    out = polish_members(loss, jnp.stack(ws), cfg)
    for s, r in enumerate(seq):
        assert float(r["best_loss"]) < 1e-10
        assert float(out["best_loss"][s]) < 1e-10


def test_polish_members_never_worse_than_inputs():
    stacked = {"x": jnp.stack([jnp.ones(2), jnp.zeros(2)]),
               "y": jnp.stack([jnp.ones(2), jnp.zeros(2)])}
    out = polish_members(_rosenbrock, stacked, PolishConfig(iters=3))
    for s in range(2):
        v0 = float(_rosenbrock(jax.tree.map(lambda l: l[s], stacked)))
        assert float(out["best_loss"][s]) <= v0
