"""The command options of the env (``commands.heading_command``,
``commands.curriculum``) against the JAX env with the ABA solver, on
``anymal_c_flat`` at 8 envs (noise, pushes and randomization off).

The JAX state is carried into the port and the JAX command draws (the
resample key's and the reset key's, split as the JAX env splits them) are
injected through ``_draw_commands``.  Steps go through a resample (half the
envs at the end of their resampling interval) and a reset (envs past the
episode length), and through a curriculum update (the step count at a
multiple of the episode length, the resetting envs' tracking sums set high)
and through the two ways it is held back.  Tolerances are
tests/test_torch_env.py's (states 5e-3, observations 1e-2, rewards 1e-3);
commands, which the draws and the P law set, 1e-5; the lin-vel-x range
exactly."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from extended_legged_gym_tpu.envs.legged_robot import LeggedRobot as JLeggedRobot
from extended_legged_gym_tpu.robots.anymal_c import anymal_c_flat_cfg as janymal_c_flat_cfg
from extended_legged_gym_tpu_torch.envs.legged_robot import LeggedRobot
from extended_legged_gym_tpu_torch.robots.anymal_c import anymal_c_flat_cfg
from extended_legged_gym_tpu_torch.utils.math import quat_rotate, wrap_to_pi
from torch_parity import PHYS, to_torch_state

E = 8


def _cfg(cfg, option):
    cfg.env.num_envs = E
    cfg.noise.add_noise = False
    cfg.domain_rand.push_robots = False
    cfg.domain_rand.randomize_friction = cfg.domain_rand.randomize_base_mass = False
    if option == "heading":
        cfg.commands.heading_command = True
    else:
        cfg.commands.curriculum = True
        cfg.commands.max_curriculum = 2.0
    return cfg


@functools.lru_cache(maxsize=None)
def make_envs(option):
    jc = _cfg(janymal_c_flat_cfg(), option)
    jc.sim.solver = "aba"
    jenv = JLeggedRobot(jc)
    env = LeggedRobot(_cfg(anymal_c_flat_cfg(), option), device="cpu")
    return option, jenv, env, jax.jit(jenv.step)


def inject_commands(env, jenv, js):
    """The JAX step's command draws (the resample's, then the reset's) as
    the port's ``_draw_commands``, each at the lin-vel-x range it is asked
    for."""
    _, k_cmd, _, _, k_cmd2, _ = jax.random.split(js.key, 6)
    keys = [k_cmd, k_cmd2]
    cr = jenv.command_ranges
    third = cr["heading"] if jenv.cfg.commands.heading_command else cr["ang_vel_yaw"]

    def draw(lin_range):
        ks = jax.random.split(keys.pop(0), 4)
        lo, hi = (float(x) for x in lin_range)
        u = [jax.random.uniform(ks[0], (E,), minval=lo, maxval=hi),
             jax.random.uniform(ks[1], (E,), minval=cr["lin_vel_y"][0], maxval=cr["lin_vel_y"][1]),
             jax.random.uniform(ks[2], (E,), minval=third[0], maxval=third[1])]
        return torch.as_tensor(np.stack([np.asarray(x) for x in u], 1))

    env._draw_commands = draw
    return keys


def carried(js, option):
    s = to_torch_state(js)
    if option == "curriculum":
        s = s.replace(command_lin_vel_x_range=torch.as_tensor(np.array(js.command_lin_vel_x_range)))
    return s


def assert_step_matches(s, js, reset, i=0, redrawn=None):
    """``s`` against the JAX state ``js`` after a step whose resets are
    ``reset``: the envs reset now or before (``redrawn``, whose initial
    velocities and joints the port draws itself) only in what the reset
    sets without a draw (their base positions, commands and rewards)."""
    now = np.asarray(reset)
    keep = ~now & (True if redrawn is None else ~redrawn)
    for k in PHYS:
        a, b = getattr(s.phys, k).numpy(), np.asarray(getattr(js.phys, k))
        np.testing.assert_allclose(a[keep], b[keep], atol=5e-3, err_msg=f"step {i} {k}")
    np.testing.assert_allclose(s.phys.base_pos.numpy()[now], np.asarray(js.phys.base_pos)[now],
                               atol=1e-6)
    # (the heading law's column 2 follows the redrawn envs' own bases)
    cmd, jcmd = s.commands.numpy(), np.asarray(js.commands)
    np.testing.assert_allclose(cmd[:, [0, 1, 3]], jcmd[:, [0, 1, 3]], atol=1e-5,
                               err_msg=f"commands {i}")
    np.testing.assert_allclose(cmd[keep | now, 2], jcmd[keep | now, 2], atol=1e-5,
                               err_msg=f"commands {i}")
    np.testing.assert_allclose(s.obs.numpy()[keep], np.asarray(js.obs)[keep], atol=1e-2)
    np.testing.assert_allclose(s.rew.numpy()[keep | now], np.asarray(js.rew)[keep | now],
                               atol=1e-3)
    np.testing.assert_array_equal(s.reset_buf.numpy(), np.asarray(js.reset_buf))


@pytest.mark.parametrize("option", ["heading", "curriculum"])
def test_steps_through_a_resample_and_a_reset_match_jax(option):
    option, jenv, env, jstep = make_envs(option)
    js = jenv.reset_all(jax.random.PRNGKey(0))
    interval = jenv.resampling_interval
    lengths = np.array(js.episode_length)
    lengths[: E // 2] = interval - 1                     # resample at the first step
    lengths[-1] = jenv.max_episode_length                # times out: reset
    js = js.replace(episode_length=jnp.asarray(lengths))
    s = carried(js, option)
    rng = np.random.default_rng(0)
    redrawn = np.zeros(E, bool)
    for i in range(3):
        inject_commands(env, jenv, js)
        a = (0.3 * rng.standard_normal((E, 12))).astype(np.float32)
        js_next = jstep(js, jnp.asarray(a))
        s = env.step(s, torch.as_tensor(a))
        assert_step_matches(s, js_next, js_next.reset_buf, i, redrawn)
        redrawn |= np.asarray(js_next.reset_buf)
        if i == 0:
            assert bool(np.asarray(js_next.reset_buf)[-1]) and int(s.episode_length[-1]) == 0
            # the resampled envs' commands changed
            assert not np.allclose(np.asarray(js_next.commands)[: E // 2, :2],
                                   np.asarray(js.commands)[: E // 2, :2])
        js = js_next
    if option == "heading":
        # column 2 is the P law of the heading command and the base heading
        # (the env reset at the first step carries the P law from its second)
        fwd = quat_rotate(s.phys.base_quat, torch.tensor([1.0, 0.0, 0.0]).expand(E, 3))
        heading = torch.atan2(fwd[:, 1], fwd[:, 0])
        law = torch.clamp(0.5 * wrap_to_pi(s.commands[:, 3] - heading), -1.0, 1.0)
        # (the law reads the state before the step's physics; one step moves
        # the heading by a few mrad)
        np.testing.assert_allclose(s.commands[:, 2].numpy(), law.numpy(), atol=0.02)
        assert (s.commands[:, 3].abs() > 0).all()


@pytest.mark.parametrize("case", ["widens", "off_timing", "poor_tracking"])
def test_curriculum_update_matches_jax(case):
    option, jenv, env, jstep = make_envs("curriculum")
    js = jenv.reset_all(jax.random.PRNGKey(1))
    reset = np.zeros(E, bool)
    reset[::3] = True
    lengths = np.where(reset, jenv.max_episode_length, np.array(js.episode_length))
    j = jenv.reward_names.index("tracking_lin_vel")
    scale = float(jenv.reward_scale_table[0, j])
    level = 0.5 if case == "poor_tracking" else 0.9
    sums = dict(js.episode_sums)
    sums["tracking_lin_vel"] = jnp.asarray(np.where(
        reset, level * scale * jenv.max_episode_length, 0.0).astype(np.float32))
    step0 = jenv.max_episode_length - (2 if case == "off_timing" else 1)
    js = js.replace(episode_length=jnp.asarray(lengths.astype(np.int32)), episode_sums=sums,
                    common_step=jnp.asarray(step0, js.common_step.dtype))
    s = carried(js, option)
    inject_commands(env, jenv, js)
    a = (0.2 * np.random.default_rng(1).standard_normal((E, 12))).astype(np.float32)
    jout = jstep(js, jnp.asarray(a))
    out = env.step(s, torch.as_tensor(a))
    np.testing.assert_array_equal(out.command_lin_vel_x_range.numpy(),
                                  np.asarray(jout.command_lin_vel_x_range))
    before = np.asarray(js.command_lin_vel_x_range)
    if case == "widens":
        np.testing.assert_allclose(out.command_lin_vel_x_range.numpy(), before + [-0.5, 0.5])
        # the resets drew lin vel x from the widened range
        vx = out.commands[torch.as_tensor(reset), 0].numpy()
        assert (vx >= before[0] - 0.5).all() and (vx <= before[1] + 0.5).all()
    else:
        np.testing.assert_array_equal(out.command_lin_vel_x_range.numpy(), before)
    assert_step_matches(out, jout, reset)


@pytest.mark.parametrize("option", ["heading", "curriculum"])
def test_gait_2_step_reads_the_heading_column(option):
    """``_reward_gait_2_step`` gates on column 3 with the heading command
    (column 2 otherwise), as JAX's does: commands whose column 2 and 3 give
    opposite gates."""
    option, jenv, env, jstep = make_envs(option)
    js = jenv.reset_all(jax.random.PRNGKey(2))
    rng = np.random.default_rng(2)
    for _ in range(3):
        js = jstep(js, jnp.asarray((0.3 * rng.standard_normal((E, 12))).astype(np.float32)))
    cmd = np.zeros((E, 4), np.float32)
    cmd[: E // 2, 2] = 1.0                      # only the yaw-rate column moves
    cmd[E // 2:, 3] = 1.0                       # only the heading column moves
    js = js.replace(commands=jnp.asarray(cmd))
    s = to_torch_state(js)
    ctx = env._contact_context(s)
    ctx = {**ctx, "feet_air_time": torch.rand(E, 4, generator=torch.Generator().manual_seed(0))}
    jctx = {k: jnp.asarray(v.numpy()) for k, v in ctx.items()}
    got = env._reward_gait_2_step(s, ctx).numpy()
    np.testing.assert_allclose(got, np.asarray(jenv._reward_gait_2_step(js, jctx)),
                               rtol=1e-5, atol=1e-6)
    moving = got != 0.0
    idx_heading = option == "heading"
    assert moving[E // 2:].all() == idx_heading and moving[: E // 2].all() == (not idx_heading)
