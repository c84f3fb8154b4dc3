"""Helpers shared by the port's parity tests: carrying a JAX env state into
the port."""
import numpy as np
import pytest
import torch

from extended_legged_gym_tpu_torch.envs.legged_robot import EnvState
from extended_legged_gym_tpu_torch.physics import EnvPhysParams, PhysState

PHYS = ("base_pos", "base_quat", "joint_pos", "base_lin_vel", "base_ang_vel", "joint_vel",
        "contact_anchor")


def to_torch_state(js) -> EnvState:
    """A JAX EnvState's values as the port's EnvState."""
    t = lambda x: torch.as_tensor(np.array(x))
    i64 = lambda x: t(x).to(torch.int64)
    return EnvState(
        phys=PhysState(*[t(getattr(js.phys, k)) for k in PHYS]),
        env_params=EnvPhysParams(t(js.env_params.friction_scale), t(js.env_params.base_mass_delta)),
        episode_length=i64(js.episode_length), commands=t(js.commands),
        actions=t(js.actions), last_actions=t(js.last_actions), last_dof_vel=t(js.last_dof_vel),
        torques=t(js.torques), feet_air_time=t(js.feet_air_time),
        feet_contact_time=t(js.feet_contact_time), last_contacts=t(js.last_contacts),
        base_lin_vel=t(js.base_lin_vel), base_ang_vel=t(js.base_ang_vel),
        projected_gravity=t(js.projected_gravity), foot_positions=t(js.foot_positions),
        foot_velocities=t(js.foot_velocities), geom_forces=t(js.geom_forces), obs=t(js.obs),
        rew=t(js.rew), reset_buf=t(js.reset_buf), time_out_buf=t(js.time_out_buf),
        episode_sums={k: t(v) for k, v in js.episode_sums.items()},
        episode_return=t(js.episode_return), env_origins=t(js.env_origins),
        common_step=i64(js.common_step),
        episode_metrics={k: t(v) for k, v in js.episode_metrics.items()},
        measured_heights=t(js.measured_heights), terrain_levels=i64(js.terrain_levels),
        terrain_types=i64(js.terrain_types), reward_stage=i64(js.reward_stage))


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Run a module's torch CPU ops on one thread (restored after): the
    tier-1 run puts 6 workers on the machine's cores, and torch's default of
    one thread per core per worker oversubscribes them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
