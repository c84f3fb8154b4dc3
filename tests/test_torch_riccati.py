"""The port's iLQR / Riccati refinement (trajopt/riccati.py) against the JAX
package's: the tree flattener, the Riccati recursion's gains on random
linearizations, whole solves on the double integrator under both curvature
models, and the batched solve with a per-env context.

Tolerances: the recursion's gains to 1e-4 relative (float32 LU solves in
both); the double integrator's controls to 1e-4 and its rewards to 1e-4
relative (the same float32 arithmetic in a different order)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from extended_legged_gym_tpu.trajopt import riccati as J
from extended_legged_gym_tpu_torch.trajopt import riccati as R
from torch_parity import one_torch_thread  # noqa: F401 (autouse)

TARGET = 30.0


def _di_step_jax(x, u):
    """tests/test_trajopt.py's double integrator, x = [pos, vel]."""
    vel = x[1] + u[0]
    pos = x[0] + vel
    r = -((pos - TARGET) ** 2) / 100.0 - 0.01 * u[0] ** 2
    return jnp.stack([pos, vel]), r


def _di_step(x, u):
    """The same step on a batch ``[N, 2]``."""
    vel = x[:, 1] + u[:, 0]
    pos = x[:, 0] + vel
    r = -((pos - TARGET) ** 2) / 100.0 - 0.01 * u[:, 0] ** 2
    return torch.stack([pos, vel], -1), r


@dataclasses.dataclass
class _Leaves:
    a: torch.Tensor
    flags: torch.Tensor
    count: torch.Tensor


def test_make_flattener_round_trips_mixed_leaves():
    """Float, bool and int leaves in a dict of a dataclass and a tuple: the
    flat layout is JAX's (dict keys sorted), the round trip exact, and the
    discrete leaves carry no derivative."""
    rng = np.random.default_rng(0)
    a = rng.standard_normal((2, 3)).astype(np.float32)
    flags = rng.uniform(size=4) < 0.5
    count = rng.integers(-5, 5, 3).astype(np.int32)
    v = rng.standard_normal(2).astype(np.float32)
    jtree = {"z": (jnp.asarray(v),), "b": {"a": jnp.asarray(a), "flags": jnp.asarray(flags),
                                          "count": jnp.asarray(count)}}
    ttree = {"z": (torch.as_tensor(v),),
             "b": _Leaves(torch.as_tensor(a), torch.as_tensor(flags), torch.as_tensor(count))}
    jflat, _, jdim = J.make_flattener(jtree)
    flatten, unflatten, dim = R.make_flattener(ttree)
    assert dim == jdim == 15
    # a dataclass flattens its fields in order: a, flags, count (the JAX dict
    # sorts them a, count, flags), so compare leaf by leaf
    got = flatten(ttree).numpy()
    np.testing.assert_array_equal(got[:6], np.asarray(jflat(jtree))[:6])
    np.testing.assert_array_equal(got[6:10], flags.astype(np.float32))
    np.testing.assert_array_equal(got[10:13], count.astype(np.float32))
    back = unflatten(flatten(ttree))
    assert back["b"].flags.dtype == torch.bool and back["b"].count.dtype == torch.int32
    for x, y in ((back["b"].a, a), (back["b"].flags, flags), (back["b"].count, count),
                 (back["z"][0], v)):
        np.testing.assert_array_equal(x.numpy(), y)
    # leading batch axes, and a vector off the discrete grid rounds back
    batch = torch.stack([flatten(ttree), flatten(ttree) + 0.3])
    b2 = unflatten(batch)
    assert b2["b"].a.shape == (2, 2, 3)
    np.testing.assert_array_equal(b2["b"].count[1].numpy(), count)
    np.testing.assert_array_equal(b2["b"].flags[1].numpy(), flags.astype(np.float32) + 0.3 > 0.5)
    # discrete leaves: zero Jacobian rows and columns
    x = flatten(ttree).requires_grad_(True)
    y = flatten(unflatten(x))
    g, = torch.autograd.grad(y.sum(), x)
    np.testing.assert_array_equal(g.numpy(), np.r_[np.ones(6), np.zeros(7), np.ones(2)])


def test_backward_gains_match_jax():
    """_backward on random linearizations (E=3, T=5, n=4, m=2, a random
    regularizer per env)."""
    rng = np.random.default_rng(1)
    E, T, n, m = 3, 5, 4, 2
    f = lambda *s: rng.standard_normal(s).astype(np.float32)
    fx, fu, rx, ru = 0.5 * f(E, T, n, n), f(E, T, n, m), f(E, T, n), f(E, T, m)
    ax, au = f(E, T, n, n), f(E, T, m, m)
    rxx = -np.einsum("etij,etkj->etik", ax, ax) - np.eye(n, dtype=np.float32)
    ruu = -np.einsum("etij,etkj->etik", au, au) - np.eye(m, dtype=np.float32)
    rux = 0.1 * f(E, T, m, n)
    reg = rng.uniform(0.1, 2.0, E).astype(np.float32)
    args = (fx, fu, rx, ru, rxx, rux, ruu)
    want = [jax.vmap(J._backward)(*map(jnp.asarray, args), jnp.asarray(reg))]
    ks, Ks = R._backward(*map(torch.as_tensor, args), torch.as_tensor(reg))
    wk, wK = (np.asarray(w) for w in want[0])
    np.testing.assert_allclose(ks.numpy(), wk, rtol=1e-4, atol=1e-4 * np.abs(wk).max())
    np.testing.assert_allclose(Ks.numpy(), wK, rtol=1e-4, atol=1e-4 * np.abs(wK).max())


@pytest.mark.parametrize("hessian", ["exact", "proximal"])
def test_ilqr_solve_matches_jax_double_integrator(hessian):
    """tests/test_trajopt.py:262-275 on noisy initial controls: the same
    controls, J0, J and accept fraction."""
    us0 = (0.3 * np.random.default_rng(2).standard_normal((32, 1))).astype(np.float32)
    kw = dict(n_iters=8, hessian=hessian, prox_x=0.02, prox_u=0.05)
    ju, ji = jax.jit(lambda a, b: J.ilqr_solve(_di_step_jax, a, b, **kw))(
        jnp.zeros(2), jnp.asarray(us0))
    tu, ti = R.ilqr_solve(_di_step, torch.zeros(2), torch.as_tensor(us0), **kw)
    np.testing.assert_allclose(tu.numpy(), np.asarray(ju), atol=1e-4)
    for k in ("J0", "J"):
        np.testing.assert_allclose(getattr(ti, k).item(), float(getattr(ji, k)), rtol=1e-4)
    assert ti.improved.item() == float(ji.improved)
    assert ti.J.item() > ti.J0.item() + 100.0 and ti.J.item() > -12.0


def test_ilqr_solve_batched_with_ctx_matches_jax():
    """Per-env context: each env's own target and control cost, u_clip on,
    three envs solved in one batch against JAX's vmap."""
    rng = np.random.default_rng(3)
    E, T = 3, 12
    targets = np.array([5.0, -3.0, 10.0], np.float32)
    costs = np.array([0.01, 0.1, 0.05], np.float32)
    x0 = rng.standard_normal((E, 2)).astype(np.float32)
    us0 = (0.3 * rng.standard_normal((E, T, 1))).astype(np.float32)

    def jstep(x, u, ctx):
        tgt, c = ctx
        vel = x[1] + u[0]
        pos = x[0] + vel
        return jnp.stack([pos, vel]), -((pos - tgt) ** 2) / 10.0 - c * u[0] ** 2

    def tstep(x, u, ctx):
        tgt, c = ctx
        vel = x[:, 1] + u[:, 0]
        pos = x[:, 0] + vel
        return torch.stack([pos, vel], -1), -((pos - tgt) ** 2) / 10.0 - c * u[:, 0] ** 2

    kw = dict(n_iters=4, u_clip=0.8, reg_init=0.5)
    ju, ji = jax.jit(lambda a, b, c: J.ilqr_solve_batched(jstep, a, b, ctx=c, **kw))(
        jnp.asarray(x0), jnp.asarray(us0), (jnp.asarray(targets), jnp.asarray(costs)))
    tu, ti = R.ilqr_solve_batched(tstep, torch.as_tensor(x0), torch.as_tensor(us0),
                                  ctx=(torch.as_tensor(targets), torch.as_tensor(costs)), **kw)
    np.testing.assert_allclose(tu.numpy(), np.asarray(ju), atol=1e-4)
    np.testing.assert_allclose(ti.J.numpy(), np.asarray(ji.J), rtol=1e-4)
    np.testing.assert_allclose(ti.J0.numpy(), np.asarray(ji.J0), rtol=1e-4)
    np.testing.assert_array_equal(ti.improved.numpy(), np.asarray(ji.improved))
    assert bool((ti.J >= ti.J0).all())
