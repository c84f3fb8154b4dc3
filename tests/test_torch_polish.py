"""The port's gradient and iLQR polish against the JAX package's.

* ``TrajGradSampling.polish`` on an analytic rollout (tests/test_trajopt.py's
  double integrator): nodes to 1e-4, gains (up to 1.7e3) to 1e-3 relative.
* The ANYmal-C MPC env (ABA solver in JAX) at E=1, 4 dense steps (Hsample 3)
  and 2 nodes (Hnode 1): the differentiable ``rollout_batch`` (the plain
  engine, counted on ``engine_substeps``) equals JAX's and the default route
  (rewards to 1e-5); the gradient of the summed reward with respect to the
  nodes matches ``jax.grad`` through JAX's XLA engine (to 1e-4 of its
  largest entry); ``fx``, ``fu``, ``rx`` and ``ru`` along the nominal
  trajectory match ``jax.jacfwd`` of JAX's iLQR step (to 1e-3 of each
  block's largest entry plus 1e-3 relative: contact stiffness puts entries
  of order 1e3 beside entries of order 1e-3); one ``optimize_all_trajectories``
  in each of the gradient and iLQR modes (no diffusion step, one polish
  iteration) matches the JAX result composed from those references and
  JAX's own rollouts (nodes to 1e-4, gains to 1e-5).

JAX's whole jitted polish takes over a minute to compile here, so its parts
are jitted one by one and shared between the tests (module fixtures); the
composition follows JAX's ``polish_step`` and ``ilqr_solve`` line by line
(extended_legged_gym_tpu/trajopt/sampling.py:146-190, riccati.py:183-234)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from extended_legged_gym_tpu.robots.anymal_c_traj import AnymalCTrajGradSampling as JEnv
from extended_legged_gym_tpu.robots.anymal_c_traj import anymal_c_traj_sampling_cfg as jcfg
from extended_legged_gym_tpu.trajopt import riccati as JR
from extended_legged_gym_tpu.trajopt.sampling import TrajGradSampling as JSampler
from extended_legged_gym_tpu.trajopt.sampling import TrajOptConfig as JOptCfg
from extended_legged_gym_tpu_torch.physics.engine import EngineEnvStep
from extended_legged_gym_tpu_torch.robots.anymal_c_traj import (AnymalCTrajGradSampling,
                                                               anymal_c_traj_sampling_cfg)
from extended_legged_gym_tpu_torch.trajopt import riccati as R
from extended_legged_gym_tpu_torch.trajopt.sampling import TrajGradSampling, TrajOptConfig
from torch_parity import one_torch_thread, to_torch_state  # noqa: F401 (autouse)

E, HS, HN, A = 1, 3, 1, 12
LR = 0.05
SCALES = (1.0, 0.25, 0.0625)


def _di_rollout(us, backend):
    """Double integrator from rest (tests/test_trajopt.py:16): positions
    [..., T+1] of dense controls [..., T, 1], the first one 0."""
    pos = backend.cumsum(backend.cumsum(us[..., 0], -1), -1)
    return backend.concatenate([0.0 * pos[..., :1], pos], -1)


def test_polish_matches_jax_analytic_rollout():
    """20 polish iterations on the double integrator from the same random
    nodes (tests/test_trajopt.py:152-184)."""
    target = 30.0
    kw = dict(num_samples=31, temp_sample=0.1, horizon_samples=32, horizon_nodes=8,
              noise_scaling=2.0, update_method="mppi", gamma=0.99)
    jopt = JSampler(JOptCfg(**kw), num_envs=2, num_actions=1)
    opt = TrajGradSampling(TrajOptConfig(**kw), num_envs=2, num_actions=1, device="cpu")
    nodes = np.random.default_rng(0).standard_normal((2, 9, 1)).astype(np.float32)
    jfn = lambda us: -jnp.square(_di_rollout(us, jnp)[..., 1:] - target) / 100.0
    tfn = lambda us: -torch.square(_di_rollout(us, torch)[..., 1:] - target) / 100.0
    want, jinfo = jax.jit(lambda n: jopt.polish(n, jfn, n_iters=20, lr=0.3))(jnp.asarray(nodes))
    got, info = opt.polish(torch.as_tensor(nodes), tfn, n_iters=20, lr=0.3)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4)
    np.testing.assert_allclose(info["polish_gain"].numpy(), np.asarray(jinfo["polish_gain"]),
                               atol=1e-4, rtol=1e-3)
    np.testing.assert_array_equal(got[:, 0].numpy(), nodes[:, 0])
    assert float(info["polish_gain"].sum()) > 0.1


def _small(cfg, method):
    to = cfg.trajectory_opt
    to.num_samples, to.horizon_samples, to.horizon_nodes = 3, HS, HN
    to.num_diffuse_steps, to.polish_iters, to.polish_method, to.polish_lr = 0, 1, method, LR
    return cfg


@pytest.fixture(scope="module")
def envs():
    c = _small(jcfg(E), "gradient")
    c.sim.solver = "aba"
    jenv = JEnv(c)
    env = AnymalCTrajGradSampling(_small(anymal_c_traj_sampling_cfg(E), "gradient"),
                                  device="cpu")
    js = jenv.reset_all(jax.random.PRNGKey(0))
    nodes = (0.3 * np.random.default_rng(1).standard_normal((E, HN + 1, A))).astype(np.float32)
    return jenv, env, js, to_torch_state(js), nodes


@pytest.fixture(scope="module")
def jax_diff_rollout(envs):
    """JAX's differentiable rollout_batch, jitted once for [E, 3, HS+1, A]."""
    jenv = envs[0]
    return jax.jit(lambda s, us: jenv.rollout_batch(s, us, differentiable=True))


@pytest.fixture(scope="module")
def jax_grad(envs):
    """(score, gradient) of the summed reward of the nodes, through JAX's
    differentiable rollout."""
    jenv, _, js, _, nodes = envs
    score = lambda n: jnp.sum(jenv.rollout_batch(js, jenv.node2u_batch(n)[:, None],
                                                 differentiable=True)[:, 0], axis=-1)
    J, g = jax.jit(jax.value_and_grad(lambda n: score(n).sum()))(jnp.asarray(nodes))
    return np.asarray(J), np.asarray(g)


def _jax_ilqr_problem(jenv, js):
    """JAX's iLQR step closure (envs/batch_rollout.py:420-442) for env 0."""
    rs0 = jenv.main_to_rollout(js)
    dyn0 = jenv._rollout_dyn_split(rs0)
    flatten, unflatten, _ = JR.make_flattener(jax.tree.map(lambda x: x[0], dyn0))

    def step_fn(x, u):
        rs_ctx, ep_slice = jax.tree.map(lambda l: l[0], (rs0, js.env_params))
        rs = jax.tree.map(lambda l: l[None], rs_ctx).replace(
            **{k: jax.tree.map(lambda l: l[None], v) for k, v in unflatten(x).items()})
        rs_n, rew = jenv.rollout_step(rs, u[None], jax.tree.map(lambda l: l[None], ep_slice),
                                      differentiable=True)
        return flatten(jenv._rollout_dyn_split(jax.tree.map(lambda l: l[0], rs_n))), rew[0]

    return step_fn, flatten(jax.tree.map(lambda x: x[0], dyn0))


@pytest.fixture(scope="module")
def jax_lin(envs):
    """JAX's nominal rollout and linearization (proximal) of the nodes'
    dense controls."""
    jenv, _, js, _, nodes = envs
    step_fn, x0 = _jax_ilqr_problem(jenv, js)
    us = jenv.node2u_batch(jnp.asarray(nodes))[0]
    xs, rews = jax.jit(lambda a, b: JR._rollout(step_fn, a, b))(x0, us)
    lin = jax.jit(lambda a, b: JR._linearize(step_fn, a, b, "proximal", 0.1, 1.0))(xs, us)
    return step_fn, x0, us, xs, rews, lin


def test_differentiable_rollout_matches_jax_and_default_route(envs, jax_diff_rollout):
    jenv, env, js, s, _ = envs
    us = (0.5 * np.random.default_rng(2).standard_normal((E, 3, HS + 1, A))).astype(np.float32)
    want = np.asarray(jax_diff_rollout(js, jnp.asarray(us)))
    EngineEnvStep.engine_substeps = 0
    got = env.rollout_batch(s, torch.as_tensor(us), differentiable=True).numpy()
    assert EngineEnvStep.engine_substeps == (HS + 1) * env.cfg.control.decimation
    fast = env.rollout_batch(s, torch.as_tensor(us)).numpy()
    assert EngineEnvStep.engine_substeps == (HS + 1) * env.cfg.control.decimation
    np.testing.assert_allclose(got, want, atol=1e-5)
    np.testing.assert_allclose(got, fast, atol=1e-5)


def test_node_gradient_matches_jax_grad(envs, jax_grad):
    _, env, _, s, nodes = envs
    J, g = jax_grad
    n = torch.as_tensor(nodes).requires_grad_(True)
    score = env.rollout_batch(s, env.node2u_batch(n)[:, None], differentiable=True)[:, 0].sum()
    got, = torch.autograd.grad(score, n)
    assert np.isfinite(got.numpy()).all()
    np.testing.assert_allclose(score.item(), float(J), atol=1e-5)
    np.testing.assert_allclose(got.numpy(), g, atol=1e-4 * np.abs(g).max())


def test_jacobians_match_jax_jacfwd(envs, jax_lin):
    """fx, fu, rx, ru at each of the nominal trajectory's HS+1 control steps
    (forward-mode dual tensors on a replicated batch against jax.jacfwd)."""
    _, env, _, s, _ = envs
    _, jx0, jus, jxs, jrews, lin = jax_lin
    step_fn, x0, ctx = env.ilqr_problem(s)
    np.testing.assert_array_equal(x0[0].numpy(), np.asarray(jx0))
    us = torch.as_tensor(np.asarray(jus))[None]
    with torch.no_grad():
        xs, rews = R._rollout(step_fn, x0, us, ctx)
        got = R._linearize(step_fn, xs, us, "proximal", 0.1, 1.0, ctx)
    np.testing.assert_allclose(xs[0].numpy(), np.asarray(jxs), atol=1e-4)
    np.testing.assert_allclose(rews[0].numpy(), np.asarray(jrews), atol=1e-5)
    for name, a, b in zip(("fx", "fu", "rx", "ru"), got[:4], lin[:4]):
        a, b = a[0].numpy(), np.asarray(b)
        assert np.isfinite(a).all(), name
        np.testing.assert_allclose(a, b, rtol=1e-3, atol=1e-3 * np.abs(b).max(), err_msg=name)


def test_gradient_mode_matches_jax(envs, jax_grad, jax_diff_rollout):
    """optimize_all_trajectories with polish_method "gradient": JAX's
    polish_step from its gradient and its differentiable rollouts of the
    three candidates; the engine route only (no kernel launch)."""
    jenv, env, js, s, nodes = envs
    J_old, g = jax_grad
    gn = g / (np.linalg.norm(g.reshape(E, -1), axis=-1)[:, None, None] + 1e-8)
    cands = nodes[:, None] + (LR * np.asarray(SCALES, np.float32))[None, :, None, None] * gn[:, None]
    cands[:, :, 0] = nodes[:, None, 0]
    Js = np.asarray(jax_diff_rollout(js, jenv.node2u_batch(jnp.asarray(cands)))).sum(-1)
    best = Js.argmax(1)
    J_new = Js[np.arange(E), best]
    want = np.where((J_new > J_old)[:, None, None], cands[np.arange(E), best], nodes)
    env.cfg.trajectory_opt.polish_method = "gradient"
    EngineEnvStep.engine_substeps = 0
    got, info = env.optimize_all_trajectories(s, torch.as_tensor(nodes), n_diffuse=0)
    assert EngineEnvStep.engine_substeps == 2 * (HS + 1) * env.cfg.control.decimation
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4)
    np.testing.assert_allclose(info["polish_gain"].numpy(),
                               [np.maximum(J_new - J_old, 0.0).mean()], atol=1e-5)
    assert float(info["polish_gain"][0]) > 0.0


def test_ilqr_mode_matches_jax(envs, jax_lin, jax_diff_rollout):
    """optimize_all_trajectories with polish_method "ilqr": JAX's ilqr_solve
    iteration (one) from its rollout, linearization, recursion and line
    search, then the node-level accept on JAX's rollout (with the ABA
    solver on the CPU its fast and differentiable rollouts are one XLA
    computation, so the compiled differentiable one scores both)."""
    jenv, env, js, s, nodes = envs
    step_fn, x0, us, xs, rews, lin = jax_lin
    J0 = float(rews.sum())
    reg = float(env.cfg.trajectory_opt.ilqr_reg)
    ks, Ks = jax.jit(JR._backward)(*lin, reg)
    alphas = jnp.asarray((1.0, 0.5, 0.2, 0.05))
    us_all, J_all = jax.jit(jax.vmap(lambda a: JR._forward(step_fn, x0, xs, us, ks, Ks, a)))(alphas)
    best = int(jnp.argmax(J_all))
    improved = float(J_all[best]) > J0
    us_opt = us_all[best] if improved else us
    new = jenv.u2node_batch(us_opt[None]).at[:, 0, :].set(jnp.asarray(nodes)[:, 0, :])
    both = jnp.stack([jnp.asarray(nodes), new, new], axis=1)              # [E, 3, Hn+1, A]
    J = np.asarray(jax_diff_rollout(js, jenv.node2u_batch(both))).sum(-1)
    J_old, J_new = J[:, 0], J[:, 1]
    want = np.where((J_new > J_old)[:, None, None], np.asarray(new), nodes)
    env.cfg.trajectory_opt.polish_method = "ilqr"
    EngineEnvStep.engine_substeps = 0
    got, info = env.optimize_all_trajectories(s, torch.as_tensor(nodes), n_diffuse=0)
    # the nominal rollout, the linearization's one step, the 4-alpha line search
    assert EngineEnvStep.engine_substeps == (2 * (HS + 1) + 1) * env.cfg.control.decimation
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4)
    np.testing.assert_allclose(float(info["polish_gain"]),
                               np.maximum(J_new - J_old, 0.0).mean(), atol=1e-5)
    assert float(info["ilqr_accept"]) == float(improved)


@pytest.mark.parametrize("mode", ["none", "fd", "gradient", "ilqr"])
def test_solve_counts_follow_the_structure(mode, monkeypatch):
    """One solve per mode (scripts/bench_polish.py's counting, E=2 at a
    small shape; on the CPU the fused step's wrapper runs its plain version
    and counts nothing, so each call is counted here as the card's launch
    would be): the fused step's launches and the engine's substeps are what
    expected_counts derives (the plain engine only for gradient and iLQR),
    and the polish never lowers an env's fast-route score."""
    from extended_legged_gym_tpu_torch.ops import physics_kernel as pk
    from extended_legged_gym_tpu_torch.scripts.bench_polish import (counted_solve,
                                                                    expected_counts, node_scores,
                                                                    polish_env)

    call = pk.DecimatedEnvStep.__call__

    def counted(self, *args):
        type(self).launches += 1
        return call(self, *args)

    monkeypatch.setattr(pk.DecimatedEnvStep, "__call__", counted)
    env = polish_env(mode, 2, "cpu", num_envs=2)
    to = env.cfg.trajectory_opt
    to.num_samples, to.horizon_samples, to.horizon_nodes = 3, 2, 1
    env.traj_sampler = TrajGradSampling(TrajOptConfig(
        num_samples=3, horizon_samples=2, horizon_nodes=1), 2, A, device="cpu")
    state = env.reset_all(seed=0)
    nodes = 0.3 * torch.randn(2, 2, A, generator=torch.Generator().manual_seed(0))
    got, info, counts = counted_solve(env, state, nodes, seed=1)
    b1, engine = expected_counts(env)
    assert counts == {"B1": b1, "B2": 0, "engine_substeps": engine}
    assert (engine > 0) == (mode in ("gradient", "ilqr"))
    to.polish_iters = 0
    diffused, _, _ = counted_solve(env, state, nodes, seed=1)
    before, after = node_scores(env, state, diffused), node_scores(env, state, got)
    assert bool((after >= before - 1e-5 * before.abs() - 1e-6).all()), (before, after)
    assert bool(torch.isfinite(got).all())


def test_differentiable_route_runs_in_float64(envs):
    """The rollout step keeps the state's float type (the card's gradients
    are held to float64 on the CPU): the float64 node gradient lies within
    1e-4 of the float32 one's largest entry."""
    from extended_legged_gym_tpu_torch.utils.tree import tree_map

    _, env, _, s, nodes = envs
    s64 = tree_map(lambda x: x.double() if x.is_floating_point() else x, s)
    grads = []
    for st, n in ((s, torch.as_tensor(nodes)), (s64, torch.as_tensor(nodes).double())):
        n = n.requires_grad_(True)
        us = torch.einsum("dn,...na->...da", env.traj_sampler.spline.A.to(n.dtype), n)
        J = env.rollout_batch(st, us[:, None], differentiable=True)[:, 0].sum()
        assert J.dtype == n.dtype
        grads.append(torch.autograd.grad(J, n)[0])
    g32, g64 = grads
    np.testing.assert_allclose(g32.double().numpy(), g64.numpy(),
                               atol=1e-4 * g64.abs().max().item())
