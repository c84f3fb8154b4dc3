"""The spherical-ray tasks against the JAX package: one step of
``anymal_c_percept`` (B1's plain step) and ``elspider_air_rough_raycast``
(B2's plain step on a 2 x 2 grid) at 2 envs from the JAX reset state, 128
rays in each observation: states to 5e-3, observations to 1e-2, rewards to
1e-3 (tests/test_torch_env.py's)."""
import jax
import numpy as np
import pytest

from test_torch_nav_plan_percept import E, assert_step_matches, task_pair
from torch_parity import one_torch_thread  # noqa: F401 (autouse)


@pytest.mark.parametrize("task", ["anymal_c_percept", "elspider_air_rough_raycast"])
def test_ray_task_step_matches_jax(task):
    """128 spherical rays in the observation (cast twice, as in the JAX
    package: the base observation's copy and the percept channels')."""
    jenv, env = task_pair(task)
    js = jenv.reset_all(jax.random.PRNGKey(4))
    a = (0.3 * np.random.default_rng(4).standard_normal((E, env.num_actions))).astype(np.float32)
    _, s2 = assert_step_matches(jenv, env, js, a, task)
    assert s2.obs.shape == (E, env.num_obs) and env.raycaster.num_rays == 128
    rays = s2.obs[:, env.num_obs - 128:]
    assert bool(((rays >= 0) & (rays <= 1)).all()) and float(rays.max()) > 0.0
