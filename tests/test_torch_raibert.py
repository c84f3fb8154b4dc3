"""The Raibert planners and the random walker against the JAX package, on the
CPU: tests/test_raibert.py's six checks run on the port (the half-sine swing;
the integrator's commanded base pose, gait and feet, observation, rewards
and masked reset; the random-walk pose variant; the closed-form heuristic),
each also held to the JAX planner on the same inputs with the JAX draws
injected (the nominal-foothold normals and the walkers' targets, recomputed
from the JAX key splits); and the random walker alone, uniform and normal.

Tolerances: one evaluation 1e-5 absolute (the same float32 formulas); states
after 50-60 integration steps 1e-4 absolute (float32 accumulation of the
integrated pose); the swing and support masks exactly."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from extended_legged_gym_tpu.utils import raibert_planner as jrp
from extended_legged_gym_tpu.utils.random_walker import RandomWalker as JRandomWalker
from extended_legged_gym_tpu_torch.utils.raibert_planner import (
    RaibertHeuristic, RaibertHeuristicCfg, RaibertPlanner, RaibertPlannerV2Cfg,
    SimpleRaibertPlanner, SimpleRaibertPlannerCfg, sin_swing_traj)
from extended_legged_gym_tpu_torch.utils.random_walker import RandomWalker

B = 4
IDENT = torch.tensor([0.0, 0.0, 0.0, 1.0]).repeat(B, 1)
JIDENT = jnp.tile(jnp.asarray([0.0, 0.0, 0.0, 1.0]), (B, 1))
t = lambda x: torch.as_tensor(np.array(x))


def _pos():
    pos = torch.zeros(B, 3)
    pos[:, 2] = 0.3
    return pos


def _jax_noise(p, key):
    """The JAX integrator's nominal draws for ``key``."""
    k1, k2, k3 = jax.random.split(key, 3)
    F = p.foot_num
    return (t(jax.random.normal(k1, (B, F, 3))), t(jax.random.normal(k2, (B,))),
            t(jax.random.normal(k3, (B,))))


def _init_pair(jp, p, key=0):
    """(JAX state, port state) from the same draws."""
    k = jax.random.PRNGKey(key)
    js = jp.init(k, jnp.asarray(_pos().numpy()), JIDENT)
    if isinstance(p, RaibertPlanner):
        k1, k2, k3 = jax.random.split(k, 3)
        walks = []
        for kw, w in ((k2, jp.base_rw), (k3, jp.foot_rw)):
            ka, kb, _ = jax.random.split(kw, 3)
            walks.append((t(w._sample(ka)), t(w._sample(kb))))
        s = p.init(_pos(), IDENT, noise=_jax_noise(p, k1), base_walk=walks[0],
                   foot_walk=walks[1])
    else:
        s = p.init(_pos(), IDENT, noise=_jax_noise(p, k))
    return js, s


def _assert_state(s, js, atol):
    for k in ("base_pos", "base_quat", "foot_pos", "gait_idx", "nominal_foothold",
              "nominal_base_height", "nominal_swing_height"):
        np.testing.assert_allclose(getattr(s, k).numpy(), np.asarray(getattr(js, k)), atol=atol,
                                   err_msg=k)
    np.testing.assert_array_equal(s.last_contacts.numpy(), np.asarray(js.last_contacts))


def test_sin_swing_traj():
    assert float(sin_swing_traj(0.1, torch.tensor(0.25))) == np.float32(0.1)
    assert float(sin_swing_traj(0.1, torch.tensor(0.75))) == 0.0
    ph = np.linspace(0.0, 1.0, 41).astype(np.float32)
    np.testing.assert_allclose(sin_swing_traj(0.07, torch.as_tensor(ph)).numpy(),
                               np.asarray(jrp.sin_swing_traj(0.07, jnp.asarray(ph))), atol=1e-7)


def test_simple_planner_integrates_commands():
    """The ideal base pose integrates the velocity commands, as in JAX."""
    p, jp = SimpleRaibertPlanner(SimpleRaibertPlannerCfg()), \
        jrp.SimpleRaibertPlanner(jrp.SimpleRaibertPlannerCfg())
    jstep = jax.jit(jp.step)
    for cmd in ([0.5, 0.0, 0.0], [0.0, 0.0, 1.0]):
        js, s = _init_pair(jp, p)
        _assert_state(s, js, 1e-6)
        c = torch.tensor(cmd).repeat(B, 1)
        for _ in range(50):
            s, js = p.step(s, c), jstep(js, jnp.asarray(c.numpy()))
        _assert_state(s, js, 1e-4)
        if cmd[0]:
            # 50 steps * 0.02 s * 0.5 m/s = 0.5 m forward; height at the nominal
            np.testing.assert_allclose(s.base_pos[:, 0].numpy(), 0.5, atol=1e-3)
            np.testing.assert_allclose(s.base_pos[:, 2].numpy(), s.nominal_base_height.numpy(),
                                       atol=1e-5)
        else:
            # 1.0 rad of yaw: the quaternion's z is sin(1.0 / 2)
            np.testing.assert_allclose(s.base_quat[:, 2].numpy(), np.sin(1.0 / 2), atol=1e-3)


def test_simple_planner_gait_and_feet():
    p, jp = SimpleRaibertPlanner(SimpleRaibertPlannerCfg()), \
        jrp.SimpleRaibertPlanner(jrp.SimpleRaibertPlannerCfg())
    jstep = jax.jit(jp.step)
    js, s = _init_pair(jp, p)
    cmd = torch.tensor([0.3, 0.0, 0.0]).repeat(B, 1)
    zs = []
    for _ in range(int(p.cfg.gait_period / p.cfg.dt)):
        s, js = p.step(s, cmd), jstep(js, jnp.asarray(cmd.numpy()))
        zs.append(s.foot_pos[:, :, 2].numpy())
    _assert_state(s, js, 1e-4)
    zs = np.stack(zs)                                  # [T, B, F]
    # every foot both swings (z > 0) and stands (z == 0) within one period
    assert (zs.max(axis=0) > 0.01).all() and (zs.min(axis=0) <= 1e-6).all()
    # tripod: the phase-0 and phase-0.5 feet alternate
    sw, ph = p.swing_mask(s).numpy(), p.phases.numpy()
    np.testing.assert_array_equal(sw, np.asarray(jp.swing_mask(js)))
    assert (sw[:, ph == 0.0] != sw[:, ph == 0.5]).all()
    assert float(s.foot_pos[:, :, 0].mean()) > 0.05   # the feet advance with the body


def test_simple_planner_obs_rewards_and_reset():
    p, jp = SimpleRaibertPlanner(SimpleRaibertPlannerCfg()), \
        jrp.SimpleRaibertPlanner(jrp.SimpleRaibertPlannerCfg())
    js, s = _init_pair(jp, p)
    F = p.foot_num
    rng = np.random.default_rng(0)
    real_pos = _pos() + torch.as_tensor(0.05 * rng.standard_normal((B, 3)), dtype=torch.float32)
    q = rng.standard_normal((B, 4)).astype(np.float32)
    real_quat = torch.as_tensor(q / np.linalg.norm(q, axis=1, keepdims=True))
    feet = s.foot_pos + torch.as_tensor(0.05 * rng.standard_normal((B, F, 3)), dtype=torch.float32)
    jr = lambda x: jnp.asarray(x.numpy())
    obs = p.observations(s, real_pos, real_quat)
    assert obs.shape == (B, 3 + 4 + 3 * F + F)
    np.testing.assert_allclose(obs.numpy(), np.asarray(jp.observations(js, jr(real_pos),
                                                                       jr(real_quat))), atol=1e-5)
    for name, arg in (("base_pos_track", real_pos), ("base_quat_track", real_quat),
                      ("foot_pos_track", feet), ("foot_pos_track_z", feet)):
        np.testing.assert_allclose(getattr(p, "penalty_" + name)(s, arg).numpy(),
                                   np.asarray(getattr(jp, "penalty_" + name)(js, jr(arg))),
                                   atol=1e-5, err_msg=name)
    for name, arg in (("base_pos_track", real_pos), ("base_quat_track", real_quat),
                      ("foot_pos_track", feet)):
        np.testing.assert_allclose(getattr(p, "reward_" + name)(s, arg).numpy(),
                                   np.asarray(getattr(jp, "reward_" + name)(js, jr(arg))),
                                   atol=1e-5, err_msg=name)
    # perfect tracking: the exp rewards are 1
    np.testing.assert_allclose(p.reward_base_pos_track(s, s.base_pos).numpy(), 1.0, atol=1e-5)
    # the swing-contact penalty counts the swinging feet in contact
    s1, js1 = p.step(s, torch.zeros(B, 3)), jp.step(js, jnp.zeros((B, 3)))
    fz = torch.full((B, F), 10.0)
    fz[0, :2] = 0.0
    s2, pen = p.penalty_foot_swing_contact(s1, fz)
    js2, jpen = jp.penalty_foot_swing_contact(js1, jr(fz))
    np.testing.assert_array_equal(pen.numpy(), np.asarray(jpen))
    np.testing.assert_array_equal(s2.last_contacts.numpy(), np.asarray(js2.last_contacts))
    assert float(pen[1]) == float(p.swing_mask(s1)[1].sum())
    # a masked reset re-draws only the envs done
    done = torch.tensor([True, False, False, False])
    key = jax.random.PRNGKey(9)
    s3 = p.reset(s2, done, _pos(), IDENT, noise=_jax_noise(p, key))
    js3 = jp.reset(js2, key, jnp.asarray(done.numpy()), jr(_pos()), JIDENT)
    _assert_state(s3, js3, 1e-5)
    assert not np.allclose(s3.nominal_foothold[0].numpy(), s2.nominal_foothold[0].numpy())
    np.testing.assert_array_equal(s3.nominal_foothold[1].numpy(), s2.nominal_foothold[1].numpy())
    # the planner's own draws: the same shapes
    s4 = p.reset(s2, done, _pos(), IDENT, generator=torch.Generator().manual_seed(1))
    np.testing.assert_array_equal(s4.foot_pos[1:].numpy(), s2.foot_pos[1:].numpy())


def test_v2_planner_pose_randomwalk():
    """The reference pose wanders inside its bounds and differs from the
    integrated pose; with the JAX walkers' target draws injected the states
    stay JAX's."""
    p, jp = RaibertPlanner(RaibertPlannerV2Cfg()), jrp.RaibertPlanner(jrp.RaibertPlannerV2Cfg())
    js, s = _init_pair(jp, p)
    jstep = jax.jit(jp.step)
    cmd = torch.zeros(B, 3)
    for _ in range(60):
        draws = []
        for w, ws in ((jp.base_rw, js.base_rw), (jp.foot_rw, js.foot_rw)):
            _, k1 = jax.random.split(ws.key)
            draws.append(t(w._sample(k1)))
        s = p.step(s, cmd, base_targets=draws[0], foot_targets=draws[1])
        js = jstep(js, jnp.zeros((B, 3)))
    _assert_state(s, js, 1e-4)
    for a, b in ((s.base_rw, js.base_rw), (s.foot_rw, js.foot_rw)):
        for k in ("current", "target", "timer"):
            np.testing.assert_allclose(getattr(a, k).numpy(), np.asarray(getattr(b, k)),
                                       atol=1e-4, err_msg=k)
    ref_pos, ref_quat = p._ref_pose(s)
    jref_pos, jref_quat = jp._ref_pose(js)
    np.testing.assert_allclose(ref_pos.numpy(), np.asarray(jref_pos), atol=1e-4)
    np.testing.assert_allclose(ref_quat.numpy(), np.asarray(jref_quat), atol=1e-4)
    cfg, rw = p.cfg, s.base_rw.current.numpy()
    assert (rw >= np.asarray(cfg.base_rand_low) - 1e-5).all()
    assert (rw <= np.asarray(cfg.base_rand_high) + 1e-5).all()
    np.testing.assert_allclose(s.base_pos[:, 2].numpy(), rw[:, 2], atol=1e-5)
    assert not np.allclose(ref_pos.numpy(), s.base_pos.numpy())
    obs = p.observations(s, s.base_pos, s.base_quat)
    assert bool(torch.isfinite(obs).all())
    # with its own draws the walk stays in bounds too
    g = torch.Generator().manual_seed(0)
    s2 = p.init(_pos(), IDENT, generator=g)
    for _ in range(30):
        s2 = p.step(s2, cmd, generator=g)
    rw2 = s2.base_rw.current.numpy()
    assert (rw2 >= np.asarray(cfg.base_rand_low) - 1e-5).all()
    assert (rw2 <= np.asarray(cfg.base_rand_high) + 1e-5).all()


def test_heuristic_planner_unchanged():
    h, jh = RaibertHeuristic(RaibertHeuristicCfg()), jrp.RaibertHeuristic(jrp.RaibertHeuristicCfg())
    pos = torch.zeros(B, 3)
    pos[:, 2] = 0.5
    cmd = torch.tensor([0.5, 0.0, 0.0, 0.0]).repeat(B, 1)
    refs = h.references(pos, IDENT, torch.zeros(B, 3), cmd, torch.zeros(B))
    assert refs.foot_pos_ref.shape == (B, 4, 3) and bool(torch.isfinite(refs.base_pos_ref).all())
    # on drawn states, against JAX
    rng = np.random.default_rng(3)
    q = rng.standard_normal((B, 4)).astype(np.float32)
    args = [0.3 * rng.standard_normal((B, 3)), q / np.linalg.norm(q, axis=1, keepdims=True),
            rng.standard_normal((B, 3)), rng.uniform(-1, 1, (B, 4)), rng.uniform(0, 3, B)]
    args = [a.astype(np.float32) for a in args]
    refs = h.references(*[torch.as_tensor(a) for a in args])
    jrefs = jh.references(*[jnp.asarray(a) for a in args])
    for a, b, name in zip(refs, jrefs, refs._fields):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-5, err_msg=name)
    feet = args[0][:, None, :] + 0.3 * rng.standard_normal((B, 4, 3)).astype(np.float32)
    contacts = rng.uniform(size=(B, 4)) < 0.5
    for name, arg in (("base_pos_track", args[0]), ("foot_pos_track", feet),
                      ("foot_pos_track_z", feet), ("foot_swing_contact", contacts)):
        np.testing.assert_allclose(
            getattr(h, "reward_" + name)(refs, torch.as_tensor(arg)).numpy(),
            np.asarray(getattr(jh, "reward_" + name)(jrefs, jnp.asarray(arg))), atol=1e-5,
            err_msg=name)


@pytest.mark.parametrize("dist", ["uniform", "normal"])
def test_random_walker_matches_jax(dist):
    """Thirty steps of 0.1 s (targets due every 0.25 s) with the JAX draws
    injected; a uniform walk stays in its bounds."""
    bounds = (np.array([[-0.2, 0.0, 1.0], [0.3, 0.5, 2.0]], np.float32) if dist == "uniform"
              else np.array([[0.0, 1.0, -1.0], [0.1, 0.2, 0.3]], np.float32))
    jw = JRandomWalker(bounds, B, 0.25, 0.8, dist)
    w = RandomWalker(bounds, B, 0.25, 0.8, dist, device="cpu")
    k1, k2, _ = jax.random.split(jax.random.PRNGKey(5), 3)
    js = jw.init(jax.random.PRNGKey(5))
    s = w.init(current=t(jw._sample(k1)), target=t(jw._sample(k2)))
    for _ in range(30):
        _, k = jax.random.split(js.key)
        s = w.step(s, 0.1, new_targets=t(jw._sample(k)))
        js = jw.step(js, 0.1)
        for n in ("current", "target", "timer"):
            np.testing.assert_allclose(getattr(s, n).numpy(), np.asarray(getattr(js, n)),
                                       atol=1e-5, err_msg=n)
    if dist == "uniform":
        c = s.current.numpy()
        assert (c >= bounds[0] - 1e-6).all() and (c <= bounds[1] + 1e-6).all()
    own = w.init(torch.Generator().manual_seed(0))
    own = w.step(own, 0.3, torch.Generator().manual_seed(1))
    assert own.current.shape == (B, 3) and bool((own.timer == 0.25).all())
