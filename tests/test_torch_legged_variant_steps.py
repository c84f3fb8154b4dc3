"""Whole steps of the ANYmal-C and ElSpider variants against the JAX
package, on the CPU, through a reset: ``anymal_c_student`` (the history and
the 235-dim privileged observation), ``pose_anymal_c`` (8-dim commands),
``load_adapt_anymal_c`` (the base accelerations) and
``foot_track_elspider_air_hang`` (the hexapod's fixed base at the config's
0.28 m, where the feet hang clear of the ground), 4 envs each, as
tests/test_torch_legged_steps.py runs the plain family (same protocol and
tolerances); the hanging hexapod again with its base at 0.175 m, where the
feet at the default pose press 9 mm into the ground and the legs bear
load; and the pose variant's command widening with the JAX draws
injected.

Tolerances: steps as tests/test_torch_env.py's (states 5e-3, observations
1e-2, rewards 1e-3 absolute), the accelerations 1e-2 relative plus 1e-2
absolute; the widened commands exactly (the same draws); the fixed base
bit for bit."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_legged_steps import jax_pair_after_steps, steps_through_a_reset
from torch_family import make_pair

# (task, base height or None for the config's); at 0.175 m the hanging
# hexapod's legs bear load
CASES = (("anymal_c_student", None), ("pose_anymal_c", None), ("load_adapt_anymal_c", None),
         ("foot_track_elspider_air_hang", None), ("foot_track_elspider_air_hang", 0.175))


@pytest.fixture(scope="module", params=CASES,
                ids=lambda c: c[0] + ("" if c[1] is None else f"-at-{c[1]}m"))
def envs(request):
    task, base_z = request.param
    pair = jax_pair_after_steps(task, base_z)
    if base_z is not None:                     # most feet loaded in the state carried over
        jenv, js = pair[1], pair[4]
        fz = np.asarray(js.geom_forces)[:, np.asarray(jenv.feet_geoms), 2]
        assert (fz > 1.0).mean() > 0.5, fz
    return pair


def test_steps_through_a_reset_match_jax(envs):
    steps_through_a_reset(*envs)


def test_pose_commands_widen_as_in_jax():
    """The base env's 4 commands widened to 8 by three more draws (height,
    roll, pitch): with the JAX draws injected, the masked envs take them and
    the others keep theirs."""
    jenv, env = make_pair("pose_anymal_c")
    B = env.num_envs
    key = jax.random.PRNGKey(8)
    old = jnp.asarray(np.random.default_rng(2).uniform(-1, 1, (B, 8)).astype(np.float32))
    mask = jnp.asarray([True, False, True, False])
    want = np.asarray(jenv._sample_commands(key, old, mask, jnp.asarray([-1.0, 1.0])))
    ks = jax.random.split(key, 5)
    k1, k2, k3, _ = jax.random.split(ks[0], 4)
    u = lambda k, lo, hi: torch.as_tensor(np.array(jax.random.uniform(k, (B,), minval=lo,
                                                                       maxval=hi)))
    base = [u(k1, -1.0, 1.0), u(k2, *env.command_ranges["lin_vel_y"]),
            u(k3, *env.command_ranges["ang_vel_yaw"])]
    extra = (u(ks[1], 0.35, 0.6), u(ks[2], -0.3, 0.3), u(ks[3], -0.3, 0.3))
    env._uniform = lambda shape, lo, hi: base.pop(0)
    env._draw_pose_commands = lambda: extra
    got = env._sample_commands(torch.as_tensor(np.array(old)), torch.as_tensor(np.array(mask)))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-7)
    assert got.shape == (B, 8) and not base
    del env._uniform, env._draw_pose_commands               # the env's own draws again
    widened = env._sample_commands(torch.zeros(B, 4), torch.ones(B, dtype=torch.bool))
    assert widened.shape == (B, 8) and float(widened[:, 4].min()) >= 0.35
