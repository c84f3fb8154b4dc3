"""Port foundations against the JAX package: robot model, quaternion ops,
spline matrices, configs, the contact model and the trajectory updates.

Inputs come from numpy seeds and go to both packages; tolerances are float32
rounding (1e-6 relative) unless stated."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from extended_legged_gym_tpu.physics import contact as jcontact
from extended_legged_gym_tpu.physics.serialize import load_model as jload_model
from extended_legged_gym_tpu.terrain import flat_terrain as jflat_terrain
from extended_legged_gym_tpu.trajopt import optimizers as jopt
from extended_legged_gym_tpu.trajopt.sampling import TrajGradSampling as JTrajGradSampling
from extended_legged_gym_tpu.trajopt.sampling import TrajOptConfig as JTrajOptConfig
from extended_legged_gym_tpu.utils import math as jm
from extended_legged_gym_tpu_torch.physics import contact as tcontact
from extended_legged_gym_tpu_torch.physics.serialize import load_model
from extended_legged_gym_tpu_torch.terrain import flat_terrain
from extended_legged_gym_tpu_torch.trajopt import optimizers as topt
from extended_legged_gym_tpu_torch.trajopt.sampling import TrajGradSampling, TrajOptConfig
from extended_legged_gym_tpu_torch.utils import math as tm

MODEL = "extended_legged_gym_tpu/robots/data/anymal_c.json"


def _t(x):
    return torch.as_tensor(np.asarray(x, np.float32))


def _quats(rng, n):
    q = rng.standard_normal((n, 4)).astype(np.float32)
    return q / np.linalg.norm(q, axis=-1, keepdims=True)


def test_model_loads_like_jax():
    m, jm_ = load_model(MODEL), jload_model(MODEL)
    assert (m.nb, m.nj, m.ng, m.num_feet) == (13, 12, 36, 4)
    for f in ("nb", "nj", "parent", "joint_names", "body_names", "geom_links", "foot_names",
              "joint_types", "fix_base"):
        assert getattr(m, f) == getattr(jm_, f), f
    for f in ("joint_origin_rot", "joint_origin_pos", "joint_axis", "mass", "com", "inertia",
              "armature", "dof_vel_limits", "torque_limits", "default_dof_pos", "geom_body",
              "geom_offset", "geom_radius", "foot_body", "foot_offset", "foot_geom"):
        np.testing.assert_array_equal(getattr(m, f), np.asarray(getattr(jm_, f)), err_msg=f)
    T = m.torch("cpu")
    assert T["geom_body"].dtype == torch.int64 and T["mass"].dtype == torch.float32


@pytest.mark.parametrize("name", ["quat_mul", "quat_rotate", "quat_rotate_inverse",
                                  "quat_to_matrix", "quat_from_axis_angle", "yaw_quat",
                                  "quat_apply_yaw", "skew"])
def test_quaternion_ops_match(name):
    rng = np.random.default_rng(0)
    q1, q2 = _quats(rng, 16), _quats(rng, 16)
    v = rng.standard_normal((16, 3)).astype(np.float32)
    ang = rng.uniform(-3, 3, 16).astype(np.float32)
    args = {"quat_mul": (q1, q2), "quat_rotate": (q1, v), "quat_rotate_inverse": (q1, v),
            "quat_to_matrix": (q1,), "quat_from_axis_angle": (v, ang), "yaw_quat": (q1,),
            "quat_apply_yaw": (q1, v), "skew": (v,)}[name]
    want = np.asarray(getattr(jm, name)(*[jnp.asarray(a) for a in args]))
    got = getattr(tm, name)(*[_t(a) for a in args]).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("method", ["spline", "linear"])
@pytest.mark.parametrize("nodes,dense", [(5, 17), (3, 5), (17, 65)])
def test_spline_matrices_match(method, nodes, dense):
    np.testing.assert_array_equal(tm._spline_interp_matrix_np(nodes, dense, method),
                                  jm._spline_interp_matrix_np(nodes, dense, method))
    np.testing.assert_allclose(tm.spline_fit_matrix(nodes, dense, method),
                               np.asarray(jm.spline_fit_matrix(nodes, dense, method)),
                               rtol=1e-6, atol=1e-6)


def test_trajopt_config_matches_jax_fields():
    from extended_legged_gym_tpu.robots.anymal_c_traj import anymal_c_traj_sampling_cfg as jcfg
    from extended_legged_gym_tpu.utils.config import class_to_dict as jc2d
    from extended_legged_gym_tpu_torch.robots.anymal_c_traj import anymal_c_traj_sampling_cfg
    from extended_legged_gym_tpu_torch.utils.config import class_to_dict

    a, b = anymal_c_traj_sampling_cfg(8), jcfg(8)
    assert class_to_dict(a.trajectory_opt) == jc2d(b.trajectory_opt)
    ws, jws = class_to_dict(a.rl_warmstart), jc2d(b.rl_warmstart)
    assert ws == {k: jws[k] for k in ws}
    assert class_to_dict(a.rewards.scales) == {
        k: v for k, v in jc2d(b.rewards.scales).items() if k in class_to_dict(a.rewards.scales)}
    nonzero = {k for k, v in jc2d(b.rewards.scales).items() if v != 0}
    assert nonzero <= set(class_to_dict(a.rewards.scales))


def test_contact_matches_jax():
    """Penetrating, receding, sliding and free spheres, with stale anchors."""
    rng = np.random.default_rng(1)
    ng = 64
    pos = np.c_[rng.uniform(-1, 1, (ng, 2)), rng.uniform(-0.05, 0.08, ng)].astype(np.float32)
    vel = rng.standard_normal((ng, 3)).astype(np.float32)
    rad = rng.uniform(0.02, 0.05, ng).astype(np.float32)
    anchor = (pos[:, :2] + 0.01 * rng.standard_normal((ng, 2))).astype(np.float32)
    jres = jcontact.sphere_terrain_contact(jflat_terrain(size=10.0), jcontact.default_contact_params(),
                                           jnp.asarray(pos), jnp.asarray(vel), jnp.asarray(rad),
                                           anchor=jnp.asarray(anchor))
    tres = tcontact.sphere_terrain_contact(flat_terrain(), tcontact.default_contact_params(),
                                           _t(pos), _t(vel), _t(rad), anchor=_t(anchor))
    for f in ("f_el", "n", "kt", "kd_minus_kt", "depth", "anchor"):
        np.testing.assert_allclose(getattr(tres, f).numpy(), np.asarray(getattr(jres, f)),
                                   rtol=1e-5, atol=1e-3, err_msg=f)
    np.testing.assert_allclose(tres.apply_D(_t(vel)).numpy(), np.asarray(jres.apply_D(jnp.asarray(vel))),
                               rtol=1e-5, atol=1e-2)


@pytest.mark.parametrize("method", ["mppi", "wbfo", "avwbfo"])
def test_update_rules_match(method):
    rng = np.random.default_rng(2)
    E, N, Hn1, Hs1, A = 3, 16, 5, 17, 12
    basis = jm._spline_interp_matrix_np(Hn1, Hs1)
    mean = rng.standard_normal((E, Hn1, A)).astype(np.float32)
    samples = rng.standard_normal((E, N, Hn1, A)).astype(np.float32)
    rew = rng.standard_normal((E, N, Hs1)).astype(np.float32)
    jfn = jopt.make_update_fn(method, 0.1, basis, gamma=0.95)
    want = np.asarray(jax.vmap(jfn)(jnp.asarray(mean), jnp.asarray(samples), jnp.asarray(rew)))
    got = topt.make_update_fn(method, 0.1, _t(basis), gamma=0.95)(_t(mean), _t(samples), _t(rew))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("append", [False, True])
def test_node_conversions_and_shift_match(append):
    rng = np.random.default_rng(3)
    E, A = 2, 12
    jts = JTrajGradSampling(JTrajOptConfig(), E, A)
    tts = TrajGradSampling(TrajOptConfig(), E, A, device="cpu")
    nodes = rng.standard_normal((E, 5, A)).astype(np.float32)
    tail = rng.standard_normal((E, A)).astype(np.float32) if append else None
    np.testing.assert_allclose(tts.node2u(_t(nodes)).numpy(), np.asarray(jts.node2u(jnp.asarray(nodes))),
                               rtol=1e-5, atol=1e-5)
    want = jts.shift(jnp.asarray(nodes), 1, None if tail is None else jnp.asarray(tail))
    got = tts.shift(_t(nodes), 1, None if tail is None else _t(tail))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)
