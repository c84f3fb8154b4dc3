"""The port's state recorder (utils/replay.py) and play logger
(utils/plot_logger.py) on the CPU: a record, export, load and replay round
trip on anymal_c_flat at 2 envs; the logger's JSON against the JAX
logger's from the same states (the JAX env's states carried into the port),
and ``plot_states`` with and without matplotlib."""
import json
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from extended_legged_gym_tpu.envs.legged_robot import LeggedRobot as JLeggedRobot
from extended_legged_gym_tpu.robots.anymal_c import anymal_c_flat_cfg as janymal_c_flat_cfg
from extended_legged_gym_tpu.utils.plot_logger import Logger as JLogger
from extended_legged_gym_tpu_torch.envs.legged_robot import LeggedRobot
from extended_legged_gym_tpu_torch.robots.anymal_c import anymal_c_flat_cfg
from extended_legged_gym_tpu_torch.utils.plot_logger import Logger
from extended_legged_gym_tpu_torch.utils.replay import StateRecorder
from torch_parity import PHYS, to_torch_state

E = 2


def _small(cfg):
    cfg.env.num_envs = E
    cfg.noise.add_noise = False
    return cfg


@pytest.fixture(scope="module")
def env():
    return LeggedRobot(_small(anymal_c_flat_cfg()), device="cpu")


def test_record_export_load_replay_round_trip(env, tmp_path):
    rec = StateRecorder()
    s = env.reset_all(seed=0)
    states = []
    for i in range(4):
        s = env.step(s, torch.full((E, 12), 0.1 * i))
        rec.record_step(s, extra={"step": i})
        states.append(s)
    assert len(rec) == 4
    rec.export(str(tmp_path / "rec.pkl"))
    back = StateRecorder.load(str(tmp_path / "rec.pkl"))
    assert len(back) == 4 and back.extras[2] == {"step": 2}
    for i, replayed in enumerate(back.iter_replay(s)):
        for k in PHYS:
            assert torch.equal(getattr(replayed.phys, k), getattr(states[i].phys, k)), (i, k)
        # only the physics state is replaced
        assert replayed.obs is s.obs
    stacked = back.stacked()
    assert stacked.base_pos.shape == (4, E, 3) and stacked.contact_anchor.shape[:2] == (4, E)
    np.testing.assert_array_equal(stacked.joint_pos[1], states[1].phys.joint_pos.numpy())
    # a replayed frame steps on like the recorded state
    a = torch.full((E, 12), 0.2)
    np.testing.assert_array_equal(env.step(back.replay_frame(states[3], 1), a).phys.base_pos.numpy(),
                                  env.step(states[1], a).phys.base_pos.numpy())


def test_save_json_matches_jax(env, tmp_path):
    """Both loggers fed the same states (log_env_step) and episode rewards
    write the same JSON."""
    jc = _small(janymal_c_flat_cfg())
    jc.sim.solver = "aba"
    jenv = JLeggedRobot(jc)
    js = jenv.reset_all(jax.random.PRNGKey(0))
    step = jax.jit(jenv.step)
    log, jlog = Logger(env.dt), JLogger(jenv.dt)
    rng = np.random.default_rng(0)
    for i in range(3):
        js = step(js, jnp.asarray((0.3 * rng.standard_normal((E, 12))).astype(np.float32)))
        log.log_env_step(env, to_torch_state(js), joint_index=i)
        jlog.log_env_step(jenv, js, joint_index=i)
    rewards = {"rew_tracking_lin_vel": np.float32(0.7), "rew_torques": np.float32(-0.01),
               "count": 3.0}
    log.log_rewards(rewards, 2)
    jlog.log_rewards(rewards, 2)
    log.save_json(str(tmp_path / "port" / "states.json"))
    jlog.save_json(str(tmp_path / "jax" / "states.json"))
    port = json.loads((tmp_path / "port" / "states.json").read_text())
    want = json.loads((tmp_path / "jax" / "states.json").read_text())
    assert port.keys() == want.keys() and port["states"].keys() == want["states"].keys()
    assert port["rewards"] == want["rewards"] and port["num_episodes"] == want["num_episodes"] == 2
    assert port["dt"] == pytest.approx(want["dt"])
    for k, v in want["states"].items():
        np.testing.assert_allclose(np.asarray(port["states"][k]), np.asarray(v), rtol=1e-6,
                                   atol=1e-6, err_msg=k)
    assert np.asarray(port["states"]["contact_forces_z"]).shape == (3, 4)


def test_plot_states_without_and_with_matplotlib(env, tmp_path, monkeypatch):
    log = Logger(env.dt)
    assert log.plot_states(str(tmp_path / "empty.png")) is None       # nothing logged
    s = env.reset_all(seed=1)
    for _ in range(3):
        s = env.step(s, torch.zeros(E, 12))
        log.log_env_step(env, s)
    with monkeypatch.context() as m:
        m.setitem(sys.modules, "matplotlib", None)                   # not installed
        assert log.plot_states(str(tmp_path / "none.png")) is None
    assert not (tmp_path / "none.png").exists()
    pytest.importorskip("matplotlib")
    path = log.plot_states(str(tmp_path / "plots" / "play_states.png"))
    assert path == str(tmp_path / "plots" / "play_states.png")
    assert (tmp_path / "plots" / "play_states.png").stat().st_size > 0
