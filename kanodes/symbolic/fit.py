"""High-level symbolic-regression post-pass.

Rebuild of the reference's interpretability tail:
  * `Symbolic_reg.jl:122-156` — per-edge `EquationSearch` over trained
    KAN activation curves (8 searches for the pruned LV network);
  * `Fisher-KPP_Source.jl:216-234` / `Allen-Cahn_Source.jl:210-236` —
    automated SR on the learned 1->1 source-term KAN;
  * `Plotting_symbolic.jl:196-236` — re-simulation of the recovered
    symbolic RHS against truth.

Expressions come from the native GP engine (`symbolic/engine.py`) and
are canonicalized with sympy so `x0*(1 - x0)`-style forms print the way
the paper reports them.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from kanodes.symbolic.engine import SymbolicFit, fit_expression

# the numpy evaluation environment for recovered expressions — op set
# mirrors the unary functions native/symreg.cpp can emit. Every
# consumer (plots, composition, re-simulation) must share THIS dict so
# growing the GP op set is a one-place change.
SYMREG_EVAL_FNS = {"sin": np.sin, "cos": np.cos, "exp": np.exp,
                   "square": np.square}


def eval_symreg_expr(expr, **variables) -> np.ndarray:
    """Sandboxed numpy eval of a symreg expression.

    `expr` is a string (or pre-`compile`d code object) over variables
    like x0/x1 and the SYMREG_EVAL_FNS ops. Constant expressions
    broadcast to the variables' common shape.
    """
    env = dict(SYMREG_EVAL_FNS)
    shape: tuple = ()
    for k, v in variables.items():
        v = np.asarray(v, np.float64)
        env[k] = v
        shape = np.broadcast_shapes(shape, v.shape)
    if isinstance(expr, str):
        expr = compile(expr, "<symreg>", "eval")
    out = eval(expr, {"__builtins__": {}}, env)  # noqa: S307
    return np.broadcast_to(np.asarray(out, np.float64), shape)


def simplify_expression(expr: str, precision: int = 4) -> str:
    """Canonicalize with sympy (expand + simplify + rounded constants)."""
    try:
        import sympy
    except ImportError:
        return expr
    try:
        e = sympy.sympify(expr.replace("square", "_sq"),
                          locals={"_sq": lambda v: v ** 2})
        e = sympy.expand(sympy.simplify(e))
        # round float constants (Integers/Rationals — e.g. exponents —
        # are structural and stay exact)
        repl = {n: sympy.Float(round(float(n), precision))
                for n in e.atoms(sympy.Float)}
        e = e.xreplace(repl)
        # drop terms with ~zero coefficients
        e = sympy.expand(e)
        if isinstance(e, sympy.Add):
            kept = [t for t in e.args
                    if abs(float(t.as_coeff_Mul()[0])) > 10 ** -precision]
            e = sympy.Add(*kept) if kept else sympy.Float(0)
        return str(e)
    except Exception:
        return expr


@dataclasses.dataclass
class EdgeEquation:
    layer: int
    i: int
    o: int
    fit: SymbolicFit
    pretty: str


def fit_edge_activations(chain, params, x, *, ops=("+", "-", "*", "/"),
                         generations: int = 200, seed: int = 0,
                         **kw) -> list[EdgeEquation]:
    """Run SR on every edge activation of a trained chain (the
    Symbolic_reg.jl workflow: one EquationSearch per activation)."""
    from kanodes.sparsify.activations import chain_activations

    ca = chain_activations(chain, params, x)
    out = []
    for l, act in enumerate(ca.acts):
        xin = np.asarray(ca.inputs[l])
        a = np.asarray(act)
        N, I, O = a.shape
        for i in range(I):
            for o in range(O):
                fit = fit_expression(xin[:, i], a[:, i, o], ops=ops,
                                     generations=generations,
                                     seed=seed + 131 * (l * I * O + i * O + o),
                                     **kw)
                out.append(EdgeEquation(l, i, o, fit,
                                        simplify_expression(fit.expression)))
    return out


def compose_edge_equations(edge_eqs: list[EdgeEquation],
                           widths: tuple[int, int, int]):
    """Compose PER-EDGE symbolic fits through the 2-layer KAN structure —
    the reference's `symb_comp_getter` ("Symbolic KAN-ODE" panel of
    Fig 4(C), `Plotting_symbolic.jl:96-140,225`): hidden node j is the
    sum of its input-edge expressions, outputs are sums of the
    second-layer edge expressions evaluated at those hidden values.

    Returns fn(pts [N, I]) -> [N, O] (NumPy).
    """
    I, W, O = widths
    table = {(e.layer, e.i, e.o): compile(e.fit.expression, "<edge>",
                                          "eval") for e in edge_eqs}

    def _edge(l, i, o, x):
        return eval_symreg_expr(table[(l, i, o)], x0=x)

    def fn(pts: np.ndarray) -> np.ndarray:
        pts = np.asarray(pts)
        h = np.zeros((pts.shape[0], W))
        for j in range(W):
            for i in range(I):
                h[:, j] += _edge(0, i, j, pts[:, i])
        out = np.zeros((pts.shape[0], O))
        for o in range(O):
            for j in range(W):
                out[:, o] += _edge(1, j, o, h[:, j])
        return out

    return fn


def compact_fit(x: np.ndarray, y: np.ndarray, *,
                ops=("+", "-", "*"), generations: int = 250,
                seed: int = 0, **kw) -> SymbolicFit:
    """Pareto selection: ONE GP search returns the engine's per-size
    hall of fame (`engine.fit_pareto`), and the SHORTEST front member
    whose MSE is within a tolerance band of the best wins (overfitting
    a learned model's approximation error with a huge genome is noise,
    not physics). Replaces the former 3-searches-at-3-parsimonies sweep
    at ~1/3 the cost with a denser front."""
    from kanodes.symbolic.engine import fit_pareto
    var = float(np.var(y)) + 1e-12
    front = fit_pareto(x, y, ops=ops, generations=generations,
                       seed=seed, **kw)
    best_mse = min(f.mse for f in front)
    # tolerance band: the target y comes from a LEARNED model, so its own
    # approximation error floors how much of the residual is physics
    tol = max(3.0 * best_mse, 3e-4 * var)
    ok = [f for f in front if f.mse <= tol]
    return min(ok, key=lambda f: f.size)


def fit_scalar_function(fn, lo: float, hi: float, n: int = 400, *,
                        ops=("+", "-", "*", "/"), generations: int = 250,
                        seed: int = 0, compact: bool = True,
                        **kw) -> SymbolicFit:
    """SR on a scalar callable over [lo, hi] — the gray-box source-term
    recovery (`Fisher-KPP_Source.jl:216-234`): sample the trained 1->1
    KAN on its input range and fit a closed form.

    compact=True runs a small pareto sweep over parsimony pressures and
    returns the SHORTEST expression whose MSE is within a tolerance band
    of the best — the learned KAN only approximates the true law, so
    chasing its wiggles with a huge genome is overfitting (the
    reference's SRRegressor model selection plays the same role).
    """
    x = np.linspace(lo, hi, n)
    y = np.asarray(fn(x)).ravel()
    if not compact:
        return fit_expression(x, y, ops=ops, generations=generations,
                              seed=seed, **kw)
    return compact_fit(x, y, ops=ops, generations=generations, seed=seed,
                       **kw)


def resimulate_symbolic_rhs(exprs: list[str], u0, ts, n_state: int):
    """Integrate du_k/dt = expr_k(u_0..u_{d-1}) and return the trajectory
    — symbolic-model validation (`Plotting_symbolic.jl:196-236`)."""
    import jax.numpy as jnp
    from kanodes.ode import odeint

    compiled = [compile(e, "<sym>", "eval") for e in exprs]

    def rhs(t, u, args):
        env = {f"x{i}": u[i] for i in range(n_state)}
        # the jnp twin of SYMREG_EVAL_FNS (device re-simulation)
        env.update({k: getattr(jnp, k) for k in SYMREG_EVAL_FNS})
        return jnp.stack([eval(c, {"__builtins__": {}}, env)  # noqa: S307
                          for c in compiled])

    return odeint(rhs, jnp.asarray(u0), jnp.asarray(ts), None,
                  rtol=1e-7, atol=1e-9, adjoint="none")
