"""scripts/play.py on the CPU from the committed flat checkpoint
(logs/flat_anymal_c/Aug21_12-38-39_r5_ft4, through the registry's
``--resume --load_run``), at 4 envs for a few steps, started from the JAX
env's reset state: its rows match the JAX env stepped from that state by
the JAX runner's policy of the same checkpoint (states 5e-3, commands
exactly, rewards 1e-3, as tests/test_torch_env.py), its files land in the
given directory and ``EXPORT_POLICY=1`` adds the deployment files.  The step
count's default is the JAX script's ``int(10 / env.dt)``."""
import inspect
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from extended_legged_gym_tpu import robots as jrobots  # noqa: F401  (the JAX registry)
from extended_legged_gym_tpu.rl.runner import OnPolicyRunner as JOnPolicyRunner
from extended_legged_gym_tpu.utils.task_registry import task_registry as jtask_registry
from extended_legged_gym_tpu_torch.scripts import play as play_script
from extended_legged_gym_tpu_torch.utils.task_registry import get_args
from torch_parity import to_torch_state

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RUN = "Aug21_12-38-39_r5_ft4"
E, STEPS = 4, 4


def _args():
    return get_args(argv=["--task", "anymal_c_flat", "--num_envs", str(E), "--device", "cpu",
                          "--load_run", RUN])


@pytest.fixture(scope="module")
def jax_rows():
    """The JAX env at play's overrides, reset with PRNGKey(0) and stepped by
    the JAX policy of the same checkpoint: (reset state, rows)."""
    cfg, tcfg = jtask_registry.get_cfgs("anymal_c_flat")
    cfg.env.num_envs = E
    cfg.noise.add_noise = False
    cfg.domain_rand.randomize_friction = False
    cfg.domain_rand.push_robots = False
    cfg.terrain.curriculum = False
    cfg.sim.solver = "aba"
    jenv, _ = jtask_registry.make_env("anymal_c_flat", env_cfg=cfg)
    runner = JOnPolicyRunner(jenv, tcfg)
    runner.load(os.path.join(ROOT, "logs/flat_anymal_c", RUN, "model_final.pkl"))
    policy = runner.get_inference_policy()
    js0 = js = jenv.reset_all(jax.random.PRNGKey(0))
    step = jax.jit(jenv.step)
    rows = []
    for i in range(STEPS):
        js = step(js, policy(js.obs))
        rows.append(dict(t=i * jenv.dt, base_height=float(js.phys.base_pos[0, 2]),
                         base_vel_x=float(js.base_lin_vel[0, 0]),
                         command_x=float(js.commands[0, 0]), rew=float(js.rew[0])))
    assert not bool(jnp.any(js.reset_buf))
    return js0, rows


def test_play_rows_match_jax(jax_rows, tmp_path, monkeypatch):
    js0, want = jax_rows
    monkeypatch.chdir(ROOT)
    runs = sorted(os.listdir(os.path.join(ROOT, "logs", "flat_anymal_c")))
    out = play_script.play(_args(), steps=STEPS, out_dir=str(tmp_path),
                           initial_state=to_torch_state(js0))
    rows = out["rows"]
    assert len(rows) == STEPS and out["finite"] and out["env"].num_envs == E
    for r, w in zip(rows, want):
        assert r["t"] == pytest.approx(w["t"]) and r["command_x"] == w["command_x"]
        assert abs(r["base_height"] - w["base_height"]) < 5e-3
        assert abs(r["base_vel_x"] - w["base_vel_x"]) < 5e-3
        assert abs(r["rew"] - w["rew"]) < 1e-3
    assert out["mean_abs_vx_err"] == pytest.approx(
        np.mean([abs(r["base_vel_x"] - r["command_x"]) for r in rows]))
    lines = (tmp_path / "play_log.jsonl").read_text().splitlines()
    assert [json.loads(x) for x in lines] == rows
    states = json.loads((tmp_path / "play_states.json").read_text())
    assert len(states["states"]["base_vel_x"]) == STEPS
    assert str(tmp_path / "play_states.png") in out["files"]
    # nothing lands under logs/ when an output directory is given
    assert sorted(os.listdir(os.path.join(ROOT, "logs", "flat_anymal_c"))) == runs


def test_play_defaults_and_export(tmp_path, monkeypatch):
    """The step count defaults to 10 s of control steps (checked on the
    signature and the env's dt: 500 at 0.02 s); EXPORT_POLICY=1 writes
    the deployment files under ``exported/``."""
    assert inspect.signature(play_script.play).parameters["steps"].default is None
    monkeypatch.chdir(ROOT)
    monkeypatch.setenv("EXPORT_POLICY", "1")
    out = play_script.play(_args(), steps=2, out_dir=str(tmp_path))
    assert int(10.0 / out["env"].dt) == 500
    names = sorted(os.listdir(tmp_path / "exported"))
    assert names == ["policy.pt2", "policy_1.pt"]
    assert len(out["rows"]) == 2 and out["first"][2].shape == (E, 12)
