"""The fused CUDA physics kernels (B1 flat, B2 heightfield) and their V-control
routes (one substep, torques passed in) against their plain version, on the
card; two launches on the same inputs agree bit for bit.  B1 is also held
with the ElSpider Air hexapod's tables, and the fixed-base regime with the
Franka arm's; B1 with A1's and Go2's, B2 with A1's, Go2's, ANYmal-B's,
Cassie's and the hexapod's on their rough tasks' grids, and the fixed-base
regime with the hanging hexapod's, its legs in contact.  Launches of more
than a wave of envs run two envs per warp: their rows equal the same rows
launched alone, a warp per env, bit for bit; the hexapod never packs, nor
Go2 at 4096 envs.

Needs a CUDA card and nvcc; skips without a card.  Imports no JAX, so it runs
on a machine without it:
    python -m pytest tests/test_torch_kernel_cuda.py -o addopts="" --noconftest -q
Tolerances of tests/test_physics_kernel.py:66-84."""
import numpy as np
import pytest
import torch

from extended_legged_gym_tpu_torch.ops import physics_kernel as pk
from extended_legged_gym_tpu_torch.physics import (EnvPhysParams, default_sim_params,
                                                   initial_state, load_model)
from extended_legged_gym_tpu_torch.terrain import flat_terrain

MODEL = "extended_legged_gym_tpu/robots/data/anymal_c.json"
TOLS = dict(base_pos=1e-4, base_quat=1e-4, joint_pos=5e-4, base_lin_vel=2e-2,
            base_ang_vel=2e-2, joint_vel=5e-2, contact_anchor=1e-4)

pytestmark = pytest.mark.cuda


@pytest.fixture(scope="module")
def setup():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU build")
    dev = torch.device("cuda")
    model = load_model(MODEL)
    step = pk.make_decimated_env_step(model, default_sim_params(), flat_terrain(), 4,
                                      np.full(12, 80.0, np.float32), np.full(12, 2.0, np.float32),
                                      model.default_dof_pos, 0.5)
    B = 300                                                  # not a multiple of the block
    rng = np.random.default_rng(0)
    t = lambda a: torch.as_tensor(a.astype(np.float32), device=dev)
    st = initial_state(model, B, pos=(0.0, 0.0, 0.54), device=dev)
    st = st.replace(base_pos=st.base_pos + t(0.05 * rng.standard_normal((B, 3))),
                    joint_pos=st.joint_pos + t(0.1 * rng.standard_normal((B, 12))),
                    joint_vel=t(0.5 * rng.standard_normal((B, 12))),
                    base_lin_vel=t(0.3 * rng.standard_normal((B, 3))),
                    base_ang_vel=t(0.3 * rng.standard_normal((B, 3))))
    ep = EnvPhysParams(t(rng.uniform(0.5, 1.25, B)), t(rng.uniform(-1.0, 1.0, B)))
    return step, st, ep, t(rng.standard_normal((B, 12)))


def test_kernel_matches_plain_on_card(setup):
    step, st, ep, act = setup
    before = pk.DecimatedEnvStep.launches
    sk, tk, rk = step(st, act, ep)
    assert pk.DecimatedEnvStep.launches == before + 1
    sp, tp, rp = step.plain(st, act, ep)
    torch.cuda.synchronize()
    for name, atol in TOLS.items():
        torch.testing.assert_close(getattr(sk, name), getattr(sp, name), atol=atol, rtol=0)
    torch.testing.assert_close(rk.foot_pos, rp.foot_pos, atol=1e-4, rtol=0)
    torch.testing.assert_close(tk, tp, atol=1e-2, rtol=0)
    fz_k, fz_p = rk.geom_forces[..., 2].sum(1), rp.geom_forces[..., 2].sum(1)
    assert ((fz_k - fz_p).abs() <= 30.0 + 0.2 * fz_p.abs()).all()


def test_kernel_rejects_mixed_devices(setup):
    step, st, ep, act = setup
    with pytest.raises(ValueError, match="actions"):
        step(st, act.cpu(), ep)


@pytest.fixture(scope="module")
def rough_setup():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU build")
    from extended_legged_gym_tpu_torch.scripts.bench_kernel import near_standing, rough_env

    env = rough_env(300, torch.device("cuda"))                   # not a multiple of the block
    states = near_standing(env.model, 300, 0, env.device, env.reset_all(seed=0).env_origins)
    return env.decimated_step, states


def test_rough_kernel_matches_plain_on_card(rough_setup):
    step, (st, ep, act) = rough_setup
    assert step.rough
    before = pk.DecimatedEnvStep.launches, pk.DecimatedEnvStep.rough_launches
    sk, tk, rk = step(st, act, ep)
    assert (pk.DecimatedEnvStep.launches, pk.DecimatedEnvStep.rough_launches) == (
        before[0], before[1] + 1)
    sp, tp, rp = step.plain(st, act, ep)
    torch.cuda.synchronize()
    for name, atol in TOLS.items():
        torch.testing.assert_close(getattr(sk, name), getattr(sp, name), atol=atol, rtol=0)
    torch.testing.assert_close(rk.foot_pos, rp.foot_pos, atol=1e-4, rtol=0)
    torch.testing.assert_close(tk, tp, atol=1e-2, rtol=0)
    fz_k, fz_p = rk.geom_forces[..., 2].sum(1), rp.geom_forces[..., 2].sum(1)
    assert ((fz_k - fz_p).abs() <= 30.0 + 0.2 * fz_p.abs()).all()


def _assert_close(sk, rk, sp, rp):
    for name, atol in TOLS.items():
        torch.testing.assert_close(getattr(sk, name), getattr(sp, name), atol=atol, rtol=0)
    torch.testing.assert_close(rk.foot_pos, rp.foot_pos, atol=1e-4, rtol=0)


def test_env_step_routes_match_plain_on_card(setup, rough_setup):
    """make_env_step and make_env_step_rough: one launch per call, counted on
    EnvStep's own counters, against one plain ABA substep."""
    step, st, ep, act = setup
    rstep, (rst, rep_, ract) = rough_setup
    for vstep, (s0, e0, a0), counter in (
            (pk.make_env_step(step.model, step.sp), (st, ep, act), "launches"),
            (pk.make_env_step_rough(rstep.model, rstep.sp, rstep.terrain), (rst, rep_, ract),
             "rough_launches")):
        tau = 20.0 * a0
        before = (pk.EnvStep.launches, pk.EnvStep.rough_launches,
                  pk.DecimatedEnvStep.launches, pk.DecimatedEnvStep.rough_launches)
        sk, rk = vstep(s0, tau, e0)
        after = (pk.EnvStep.launches, pk.EnvStep.rough_launches,
                 pk.DecimatedEnvStep.launches, pk.DecimatedEnvStep.rough_launches)
        k = 0 if counter == "launches" else 1
        assert after == tuple(b + (i == k) for i, b in enumerate(before))
        sp, _, rp = vstep.plain(s0, tau, e0)
        torch.cuda.synchronize()
        _assert_close(sk, rk, sp, rp)


def test_two_launches_are_bit_identical(setup, rough_setup):
    """Every sum in the kernel has a fixed order (no atomics)."""
    step, st, ep, act = setup
    rstep, (rst, rep_, ract) = rough_setup
    for stp, (s0, e0, a0) in ((step, (st, ep, act)), (rstep, (rst, rep_, ract))):
        a, b = stp.launch(s0, a0, e0), stp.launch(s0, a0, e0)
        torch.cuda.synchronize()
        for k in TOLS:
            assert torch.equal(getattr(a[0], k), getattr(b[0], k)), k
        assert torch.equal(a[1], b[1])
        for k in ("geom_forces", "foot_pos", "foot_vel"):
            assert torch.equal(getattr(a[2], k), getattr(b[2], k)), k


def test_elspider_kernel_matches_plain_on_card():
    """B1 with the hexapod's tables (19 bodies, 18 joints, 46 geoms, 6 feet)
    at 300 envs from near-standing states: one launch against the plain
    version in float64 (whose float32 rounding alone reaches most of the
    joint-velocity tolerance on the hexapod's light legs), then two launches
    bit for bit."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU build")
    from extended_legged_gym_tpu_torch.scripts.bench_kernel import (STAND_HEIGHT, near_standing,
                                                                    task_step)

    step = task_step("elspider_air_flat", torch.device("cuda"))
    st, ep, act = near_standing(step.model, 300, 0, torch.device("cuda"),
                                height=STAND_HEIGHT["elspider_air"])
    before = pk.DecimatedEnvStep.launches
    sk, tk, rk = step(st, act, ep)
    assert pk.DecimatedEnvStep.launches == before + 1
    sp, tp, rp = step.plain(st, act, ep, dtype=torch.float64)
    torch.cuda.synchronize()
    _assert_close(sk, rk, sp, rp)
    # the last substep's torques follow joint_pos and joint_vel through the
    # gains: 80 x 5e-4 + 2 x 5e-2
    torch.testing.assert_close(tk, tp, atol=0.14, rtol=0)
    again = step.launch(st, act, ep)
    torch.cuda.synchronize()
    for k in TOLS:
        assert torch.equal(getattr(sk, k), getattr(again[0], k)), k


def test_fixed_base_kernel_matches_plain_on_card():
    """The fixed-base regime with the arm's tables at 300 envs from states at
    rest: one launch, counted on ``fixed_launches`` alone, against the plain
    fixed-base step; the base pose unchanged bit for bit; two launches bit
    for bit."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU build")
    from extended_legged_gym_tpu_torch.scripts.bench_kernel import at_rest, franka_step

    dev = torch.device("cuda")
    step = franka_step(dev)
    st, ep, act = at_rest(step.model, 300, 0, dev)
    before = pk.DecimatedEnvStep.launches, pk.DecimatedEnvStep.fixed_launches
    sk, tk, rk = step(st, act, ep)
    assert (pk.DecimatedEnvStep.launches, pk.DecimatedEnvStep.fixed_launches) == (
        before[0], before[1] + 1)
    sp, tp, rp = step.plain(st, act, ep)
    torch.cuda.synchronize()
    _assert_close(sk, rk, sp, rp)
    torch.testing.assert_close(tk, tp, atol=1e-2, rtol=0)
    assert rk.foot_pos.shape == (300, 0, 3)
    assert torch.equal(sk.base_pos, st.base_pos) and torch.equal(sk.base_quat, st.base_quat)
    again = step.launch(st, act, ep)
    torch.cuda.synchronize()
    for k in TOLS:
        assert torch.equal(getattr(sk, k), getattr(again[0], k)), k


@pytest.mark.parametrize("task", ["a1_flat", "go2_flat", "a1", "go2_rough", "anymal_b", "cassie",
                                  "elspider_air_rough", "foot_track_elspider_air_hang"])
def test_family_kernel_matches_plain_on_card(task):
    """The LeggedRobot family's tables at 300 envs: B1 and B2 from
    near-standing states (B2 above the task's spawn origins), the fixed-base
    regime with the hexapod's base held at 0.175 m (legs in contact); one
    launch, counted on its route alone, against the plain version in float64
    (the light legs' float32 rounding), then two launches bit for bit."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU build")
    from extended_legged_gym_tpu_torch.scripts.bench_kernel import (at_rest, task_env,
                                                                    task_states)

    dev = torch.device("cuda")
    env = task_env(task, dev, 300)
    step = env.decimated_step
    if step.model.fix_base:
        st, ep, act = at_rest(step.model, 300, 0, dev,
                              torch.tensor([0.0, 0.0, 0.175], device=dev).expand(300, 3))
    else:
        st, ep, act = task_states(env, 300, 0, dev)
    route = "fixed_launches" if step.model.fix_base else (
        "rough_launches" if step.rough else "launches")
    counters = ("launches", "rough_launches", "fixed_launches")
    before = {k: getattr(pk.DecimatedEnvStep, k) for k in counters}
    sk, tk, rk = step(st, act, ep)
    after = {k: getattr(pk.DecimatedEnvStep, k) for k in counters}
    assert after == {k: before[k] + (k == route) for k in counters}
    sp, tp, rp = step.plain(st, act, ep, dtype=torch.float64)
    torch.cuda.synchronize()
    assert float(rp.geom_forces[..., 2].sum()) > 0.0
    _assert_close(sk, rk, sp, rp)
    again = step.launch(st, act, ep)
    torch.cuda.synchronize()
    for k in TOLS:
        assert torch.equal(getattr(sk, k), getattr(again[0], k)), k


@pytest.mark.parametrize("terrain,B", [("flat", 262144), ("flat", 2112), ("rough", 32768)])
def test_packed_rows_equal_rows_launched_alone(terrain, B):
    """B1 of the sampling MPC at its diffusion (64 x 4096) and polish (64 x
    33) batches and B2 at the rough PPO fleet (32768 envs): the wrapper packs
    two envs per warp (more than one wave of envs at a warp per env), and 300
    rows of the launch equal the same rows launched alone at 300 envs (a warp
    per env) bit for bit."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU build")
    from extended_legged_gym_tpu_torch.robots.anymal_c_traj import (AnymalCTrajGradSampling,
                                                                   anymal_c_traj_sampling_cfg)
    from extended_legged_gym_tpu_torch.scripts.bench_kernel import near_standing, rough_env
    from extended_legged_gym_tpu_torch.utils.tree import tree_map

    dev = torch.device("cuda")
    if terrain == "flat":
        step, origins = AnymalCTrajGradSampling(anymal_c_traj_sampling_cfg(1),
                                                device=dev).decimated_step, None
    else:
        env = rough_env(B, dev)
        step, origins = env.decimated_step, env.reset_all(seed=0).env_origins
    counter = "rough_launches" if step.rough else "launches"
    counts = lambda: (getattr(pk.DecimatedEnvStep, counter), pk.DecimatedEnvStep.packed_launches)
    st, ep, act = near_standing(step.model, B, B, dev, origins)
    before = counts()
    sk, tk, rk = step(st, act, ep)
    assert counts() == (before[0] + 1, before[1] + 1)
    idx = torch.randperm(B, generator=torch.Generator().manual_seed(B))[:300].to(dev)
    rows = lambda x: x[idx]
    sa, ta, ra = step(tree_map(rows, st), act[idx], tree_map(rows, ep))
    assert counts() == (before[0] + 2, before[1] + 1)
    torch.cuda.synchronize()
    for k in TOLS:
        assert torch.equal(getattr(sk, k)[idx], getattr(sa, k)), k
    assert torch.equal(tk[idx], ta)
    for k in ("geom_forces", "foot_pos", "foot_vel"):
        assert torch.equal(getattr(rk, k)[idx], getattr(ra, k)), k


@pytest.mark.parametrize("task,robot,B", [("elspider_air_flat", "elspider_air", 8192),
                                           ("go2_flat", "go2", 4096)])
def test_no_packed_launch_where_it_holds_fewer_envs(task, robot, B):
    """The hexapod's 19 bodies keep a warp per env at any batch, and Go2's
    workspace (56 geoms) holds fewer envs per SM in packed blocks of 8 than
    at a warp per env: B1 at B envs, no packed launch."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU build")
    from extended_legged_gym_tpu_torch.scripts.bench_kernel import (STAND_HEIGHT, near_standing,
                                                                    task_step)

    dev = torch.device("cuda")
    step = task_step(task, dev)
    st, ep, act = near_standing(step.model, B, 0, dev, height=STAND_HEIGHT[robot])
    before = pk.DecimatedEnvStep.launches, pk.DecimatedEnvStep.packed_launches
    step(st, act, ep)
    torch.cuda.synchronize()
    assert (pk.DecimatedEnvStep.launches, pk.DecimatedEnvStep.packed_launches) == (
        before[0] + 1, before[1])
    assert step.launch_shape(B, dev, pk.load_library()) == (pk.WARP, pk.ENVS_PER_BLOCK)
