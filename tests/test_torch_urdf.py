"""The port's URDF loader (physics/urdf.py), save_model, the robot-model
extraction script and prismatic joints in its plain ABA and CRBA steps,
against the JAX package on the CPU.

URDFs are inline: the pendulum of tests/test_physics.py, a tree with fixed
joints to collapse (parallel-axis inertia, spheres re-expressed in the
movable body's frame), boxes and cylinders to pack into spheres and a mesh
to skip, and a slider with two prismatic joints (one of them on a floating
base's tilted axis) and a revolute one.  Loaded models must equal JAX's to
float32 rounding (1e-7).  The slider's kinematics and dynamics are held at
tests/test_torch_crba.py's tolerances, 20 steps of its ABA and CRBA steps at
tests/test_torch_physics.py's."""
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from extended_legged_gym_tpu.physics import dynamics as jdyn
from extended_legged_gym_tpu.physics import default_env_params as jdefault_env_params
from extended_legged_gym_tpu.physics import default_sim_params as jdefault_sim_params
from extended_legged_gym_tpu.physics import physics_step as jphysics_step
from extended_legged_gym_tpu.physics.engine import PhysState as JPhysState
from extended_legged_gym_tpu.physics.serialize import load_model as jload_model
from extended_legged_gym_tpu.physics.serialize import save_model as jsave_model
from extended_legged_gym_tpu.physics.urdf import attach_feet as jattach_feet
from extended_legged_gym_tpu.physics.urdf import load_urdf as jload_urdf
from extended_legged_gym_tpu.scripts import extract_robot_models as jextract
from extended_legged_gym_tpu.terrain import flat_terrain as jflat_terrain
from extended_legged_gym_tpu_torch.envs.legged_robot import LeggedRobot
from extended_legged_gym_tpu_torch.ops import physics_kernel as pk
from extended_legged_gym_tpu_torch.physics import (EngineEnvStep, attach_feet, default_env_params,
                                                   default_sim_params, dynamics, initial_state,
                                                   load_model, load_urdf, physics_step,
                                                   save_model)
from extended_legged_gym_tpu_torch.robots.anymal_c import anymal_c_flat_cfg
from extended_legged_gym_tpu_torch.scripts import extract_robot_models
from extended_legged_gym_tpu_torch.terrain import flat_terrain
from torch_parity import PHYS

PENDULUM_URDF = """
<robot name="pendulum">
  <link name="base">
    <inertial><mass value="1.0"/><origin xyz="0 0 0"/>
      <inertia ixx="0.01" iyy="0.01" izz="0.01" ixy="0" ixz="0" iyz="0"/></inertial>
  </link>
  <joint name="hinge" type="revolute">
    <parent link="base"/><child link="rod"/>
    <origin xyz="0 0 0" rpy="0 0 0"/><axis xyz="0 1 0"/>
    <limit lower="-10" upper="10" velocity="100" effort="100"/>
  </joint>
  <link name="rod">
    <inertial><mass value="2.0"/><origin xyz="0 0 -0.5"/>
      <inertia ixx="0.001" iyy="0.001" izz="0.001" ixy="0" ixz="0" iyz="0"/></inertial>
    <collision><origin xyz="0 0 -1.0"/><geometry><sphere radius="0.05"/></geometry></collision>
  </link>
</robot>
"""

# fixed joints to collapse (one with a rotated origin and its own inertial
# frame), a box, a long and a short cylinder, a mesh, a continuous joint and
# a joint without limits
TREE_URDF = """
<robot name="tree">
  <link name="base">
    <inertial><origin xyz="0.01 0 0.02" rpy="0 0 0.2"/><mass value="5.0"/>
      <inertia ixx="0.1" iyy="0.2" izz="0.25" ixy="0.01" ixz="0" iyz="0.002"/></inertial>
    <collision><origin xyz="0 0 0"/><geometry><box size="0.5 0.25 0.1"/></geometry></collision>
  </link>
  <joint name="imu_joint" type="fixed">
    <parent link="base"/><child link="imu"/><origin xyz="0.1 0.02 0.05" rpy="0.1 0.2 0.3"/>
  </joint>
  <link name="imu">
    <inertial><origin xyz="0 0 0.01" rpy="0.3 0 0"/><mass value="0.5"/>
      <inertia ixx="0.001" iyy="0.002" izz="0.003" ixy="0.0001" ixz="0" iyz="0"/></inertial>
    <collision><origin xyz="0 0 0.02" rpy="0 1.2 0"/>
      <geometry><cylinder radius="0.02" length="0.15"/></geometry></collision>
  </link>
  <joint name="LF_HAA" type="revolute">
    <parent link="base"/><child link="LF_HIP"/><origin xyz="0.2 0.1 0"/><axis xyz="1 0 0"/>
    <limit lower="-0.7" upper="0.5" velocity="7.5" effort="80"/>
  </joint>
  <link name="LF_HIP">
    <inertial><origin xyz="0 0.03 0"/><mass value="1.2"/>
      <inertia ixx="0.002" iyy="0.003" izz="0.002" ixy="0" ixz="0" iyz="0"/></inertial>
    <collision><origin xyz="0 0.05 -0.05" rpy="1.57 0 0"/>
      <geometry><cylinder radius="0.04" length="0.03"/></geometry></collision>
  </link>
  <joint name="LF_KFE" type="continuous">
    <parent link="LF_HIP"/><child link="LF_SHANK"/><origin xyz="0 0.05 -0.1"/><axis xyz="0 1 0"/>
  </joint>
  <link name="LF_SHANK">
    <inertial><origin xyz="0 0 -0.12"/><mass value="0.6"/>
      <inertia ixx="0.003" iyy="0.003" izz="0.0005" ixy="0" ixz="0" iyz="0"/></inertial>
    <collision><geometry><mesh filename="shank.stl"/></geometry></collision>
    <collision><origin xyz="0 0 -0.1"/><geometry><box size="0.04 0.06 0.18"/></geometry></collision>
  </link>
  <joint name="LF_foot_fixed" type="fixed">
    <parent link="LF_SHANK"/><child link="LF_FOOT"/><origin xyz="0 0 -0.25"/>
  </joint>
  <link name="LF_FOOT">
    <inertial><mass value="0.05"/>
      <inertia ixx="1e-5" iyy="1e-5" izz="1e-5" ixy="0" ixz="0" iyz="0"/></inertial>
    <collision><geometry><sphere radius="0.03"/></geometry></collision>
  </link>
  <joint name="RF_HAA" type="revolute">
    <parent link="base"/><child link="RF_HIP"/><origin xyz="0.2 -0.1 0" rpy="0 0 3.14159"/>
    <axis xyz="1 0 0"/><limit lower="-0.5" upper="0.7" velocity="7.5" effort="80"/>
  </joint>
  <link name="RF_HIP">
    <inertial><origin xyz="0 0 -0.1"/><mass value="1.0"/>
      <inertia ixx="0.004" iyy="0.004" izz="0.001" ixy="0" ixz="0" iyz="0"/></inertial>
    <collision><origin xyz="0 0 -0.12"/><geometry><sphere radius="0.025"/></geometry></collision>
  </link>
  <joint name="RF_foot_fixed" type="fixed">
    <parent link="RF_HIP"/><child link="RF_FOOT"/><origin xyz="0 0 -0.25"/>
  </joint>
  <link name="RF_FOOT">
    <collision><geometry><sphere radius="0.03"/></geometry></collision>
  </link>
</robot>
"""

# two prismatic joints (a vertical one on a tilted axis, a horizontal one)
# and a revolute joint riding on the first
SLIDER_URDF = """
<robot name="slider">
  <link name="base">
    <inertial><mass value="4.0"/>
      <inertia ixx="0.05" iyy="0.06" izz="0.08" ixy="0" ixz="0" iyz="0"/></inertial>
    <collision><geometry><box size="0.3 0.3 0.1"/></geometry></collision>
  </link>
  <joint name="slide" type="prismatic">
    <parent link="base"/><child link="leg"/><origin xyz="0.05 0 -0.05" rpy="0.1 0 0"/>
    <axis xyz="0 0.2 1"/><limit lower="-0.2" upper="0.2" velocity="5" effort="200"/>
  </joint>
  <link name="leg">
    <inertial><origin xyz="0 0 -0.1"/><mass value="1.0"/>
      <inertia ixx="0.004" iyy="0.004" izz="0.001" ixy="0" ixz="0" iyz="0"/></inertial>
  </link>
  <joint name="knee" type="revolute">
    <parent link="leg"/><child link="shin"/><origin xyz="0 0 -0.2"/><axis xyz="0 1 0"/>
    <limit lower="-2" upper="2" velocity="20" effort="50"/>
  </joint>
  <link name="shin">
    <inertial><origin xyz="0 0 -0.1"/><mass value="0.5"/>
      <inertia ixx="0.002" iyy="0.002" izz="0.0005" ixy="0" ixz="0" iyz="0"/></inertial>
  </link>
  <joint name="shin_foot" type="fixed">
    <parent link="shin"/><child link="shin_foot"/><origin xyz="0 0 -0.2"/>
  </joint>
  <link name="shin_foot">
    <inertial><mass value="0.05"/>
      <inertia ixx="1e-5" iyy="1e-5" izz="1e-5" ixy="0" ixz="0" iyz="0"/></inertial>
    <collision><geometry><sphere radius="0.03"/></geometry></collision>
  </link>
  <joint name="rail" type="prismatic">
    <parent link="base"/><child link="carriage"/><origin xyz="-0.1 0 0.06" rpy="0 0 0.4"/>
    <axis xyz="0.6 0.8 0"/><limit lower="-0.3" upper="0.3" velocity="3" effort="100"/>
  </joint>
  <link name="carriage">
    <inertial><origin xyz="0.02 0 0.01"/><mass value="0.8"/>
      <inertia ixx="0.001" iyy="0.002" izz="0.002" ixy="0" ixz="0" iyz="0"/></inertial>
    <collision><geometry><sphere radius="0.04"/></geometry></collision>
  </link>
</robot>
"""

URDFS = {"pendulum": PENDULUM_URDF, "tree": TREE_URDF, "slider": SLIDER_URDF}
ARRAYS = ("joint_origin_rot", "joint_origin_pos", "joint_axis", "mass", "com", "inertia",
          "armature", "dof_pos_limits", "dof_vel_limits", "torque_limits", "default_dof_pos",
          "geom_body", "geom_offset", "geom_radius", "foot_body", "foot_offset", "foot_radius",
          "foot_geom", "ancestor_mask", "base_init_height")
STATIC = ("nb", "nj", "body_names", "joint_names", "parent", "joint_types", "fix_base",
          "geom_links", "foot_names")
B = 4


def _write(tmp_path, name):
    p = tmp_path / f"{name}.urdf"
    p.write_text(URDFS[name])
    return str(p)


def _assert_models_equal(m, jm):
    for f in STATIC:
        assert getattr(m, f) == getattr(jm, f), f
    for f in ARRAYS:
        a, b = np.asarray(getattr(m, f)), np.asarray(getattr(jm, f))
        assert a.dtype == b.dtype and a.shape == b.shape, f
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-7, err_msg=f)


KWARGS = {"pendulum": dict(fix_base=True),
          "tree": dict(default_joint_angles={"LF_HAA": 0.1, "KFE": -0.8, "HAA": 0.05},
                       armature=0.01, base_init_height=0.45),
          "slider": dict(default_joint_angles={"slide": 0.05, "knee": 0.3}, base_init_height=0.5)}
FEET = {"pendulum": "rod", "tree": "FOOT", "slider": "foot"}


@pytest.mark.parametrize("name", list(URDFS))
def test_load_urdf_and_attach_feet_match_jax(tmp_path, name):
    path = _write(tmp_path, name)
    m, jm = load_urdf(path, **KWARGS[name]), jload_urdf(path, **KWARGS[name])
    _assert_models_equal(m, jm)
    m, jm = attach_feet(m, FEET[name]), jattach_feet(jm, FEET[name])
    _assert_models_equal(m, jm)
    assert m.num_feet == jm.num_feet >= 1
    if name == "tree":
        # the fixed children are gone: 3 movable bodies besides the base
        assert m.body_names == ("base", "LF_HIP", "LF_SHANK", "RF_HIP")
        assert m.joint_names == ("LF_HAA", "LF_KFE", "RF_HAA")
        assert m.foot_names == ("LF_FOOT", "RF_FOOT")
        assert abs(float(m.mass[0]) - 5.5) < 1e-6 and abs(float(m.mass[2]) - 0.65) < 1e-6
        assert m.default_dof_pos.tolist() == pytest.approx([0.1, -0.8, 0.05])
        assert m.dof_pos_limits[1].tolist() == [-1e9, 1e9]       # the continuous joint
    if name == "slider":
        assert m.joint_types == ("prismatic", "revolute", "prismatic") and m.has_prismatic


@pytest.mark.parametrize("name", list(URDFS))
def test_save_model_round_trips_with_jax(tmp_path, name):
    """The port's save_model writes what JAX's writes: each side's JSON loads
    into the same arrays in both packages."""
    path = _write(tmp_path, name)
    m = attach_feet(load_urdf(path, **KWARGS[name]), FEET[name])
    jm = jattach_feet(jload_urdf(path, **KWARGS[name]), FEET[name])
    save_model(m, str(tmp_path / "port.json"))
    jsave_model(jm, str(tmp_path / "jax.json"))
    assert (json.loads((tmp_path / "port.json").read_text())
            == json.loads((tmp_path / "jax.json").read_text()))
    for f in ("port.json", "jax.json"):
        _assert_models_equal(load_model(str(tmp_path / f)), jm)
        _assert_models_equal(jload_model(str(tmp_path / f)), jm)


def test_extract_robot_models_on_an_inline_tree(tmp_path):
    """Both scripts over a resources tree holding two of ROBOTS' URDFs write
    the same JSON; the others are skipped."""
    assert extract_robot_models.ROBOTS == jextract.ROBOTS
    root = tmp_path / "robots"
    for name, src in (("anymal_c", TREE_URDF), ("franka", PENDULUM_URDF)):
        p = root / extract_robot_models.ROBOTS[name]["urdf"]
        p.parent.mkdir(parents=True)
        p.write_text(src)
    written = extract_robot_models.main(str(root), str(tmp_path / "port"))
    jextract.main(str(root), str(tmp_path / "jax"))
    assert written == ["anymal_c", "franka"]
    assert sorted(os.listdir(tmp_path / "jax")) == ["anymal_c.json", "franka.json"]
    for name in written:
        port = json.loads((tmp_path / "port" / f"{name}.json").read_text())
        assert port == json.loads((tmp_path / "jax" / f"{name}.json").read_text())
    franka = load_model(str(tmp_path / "port" / "franka.json"))
    assert franka.fix_base and franka.foot_names == ()


def _slider(tmp_path, fix_base=False):
    path = _write(tmp_path, "slider")
    kw = dict(KWARGS["slider"], fix_base=fix_base)
    return attach_feet(load_urdf(path, **kw), "foot"), jattach_feet(jload_urdf(path, **kw), "foot")


def _slider_states(m, seed, z=0.5):
    """Tilted, joints perturbed, random velocities (the base at rest on a
    fixed base, which integrates its velocities unchanged)."""
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)
    q = np.array([0.05, -0.03, 0.1, 0.99], np.float32)
    st = initial_state(m, B, pos=(0.1, -0.2, z), device="cpu")
    st = st.replace(base_quat=torch.as_tensor(q / np.linalg.norm(q)).expand(B, 4).clone(),
                    joint_pos=st.joint_pos + torch.as_tensor(0.05 * f(B, m.nj)),
                    joint_vel=torch.as_tensor(0.5 * f(B, m.nj)),
                    base_lin_vel=torch.as_tensor(0.3 * f(B, 3)) * (not m.fix_base),
                    base_ang_vel=torch.as_tensor(0.4 * f(B, 3)) * (not m.fix_base))
    return st, JPhysState(*[jnp.asarray(getattr(st, k).numpy()) for k in PHYS])


def _fk_args(st):
    return (st.base_pos, st.base_quat, st.joint_pos, st.base_lin_vel, st.base_ang_vel,
            st.joint_vel)


def test_prismatic_kinematics_and_dynamics_match_jax(tmp_path):
    """tests/test_torch_crba.py's checks on the slider: FK, point and body
    Jacobians, M, C and the forward dynamics."""
    m, jm = _slider(tmp_path)
    st, jst = _slider_states(m, 0)
    kin = dynamics.forward_kinematics(m, *_fk_args(st))
    jkin = jax.vmap(lambda *a: jdyn.forward_kinematics(jm, *a))(*_fk_args(jst))
    for name in jdyn.Kinematics._fields:
        np.testing.assert_allclose(getattr(kin, name).numpy(), np.asarray(getattr(jkin, name)),
                                   atol=1e-5, err_msg=name)
    gb = np.asarray(m.geom_body)
    pts = kin.body_pos[:, gb] + (kin.body_rot[:, gb] @ torch.as_tensor(m.geom_offset)[..., None])[..., 0]
    jJg = jax.vmap(lambda k, p: jdyn.point_jacobian(jm, k, gb, p))(jkin, pts.numpy())
    np.testing.assert_allclose(dynamics.point_jacobian(m, kin, gb, pts).numpy(), np.asarray(jJg),
                               atol=1e-5)
    Jv, Jw = dynamics.body_jacobians(m, kin)
    jJv, jJw = jax.vmap(lambda k: jdyn.body_jacobians(jm, k))(jkin)
    np.testing.assert_allclose(Jv.numpy(), np.asarray(jJv), atol=1e-5)
    np.testing.assert_allclose(Jw.numpy(), np.asarray(jJw), atol=1e-5)
    assert float(Jw[..., 6].abs().max()) == float(Jw[..., 8].abs().max()) == 0.0
    g = np.array([0.0, 0.0, -9.81], np.float32)
    M = dynamics.mass_matrix(m, kin, Jv, Jw)
    C = dynamics.bias_forces(m, kin, Jv, Jw, torch.as_tensor(g))
    np.testing.assert_allclose(M.numpy(), np.asarray(jax.vmap(
        lambda k, a, b: jdyn.mass_matrix(jm, k, a, b))(jkin, jJv, jJw)), rtol=1e-4, atol=1e-3)
    np.testing.assert_allclose(C.numpy(), np.asarray(jax.vmap(
        lambda k, a, b: jdyn.bias_forces(jm, k, a, b, g))(jkin, jJv, jJw)), rtol=1e-4, atol=1e-3)


# tests/test_torch_physics.py's tolerances (kernel vs ABA, one step); 20
# steps of the same step in both packages stay inside them
TOLS = dict(base_pos=1e-4, base_quat=1e-4, joint_pos=5e-4, base_lin_vel=2e-2,
            base_ang_vel=2e-2, joint_vel=5e-2)


@pytest.mark.parametrize("solver", ["aba", "crba"])
@pytest.mark.parametrize("fix_base", [False, True])
def test_prismatic_steps_match_jax(tmp_path, solver, fix_base):
    """20 steps of the slider with random torques, from the same states, in
    both packages: floating, dropped onto flat ground (its spheres touch
    down); on a fixed base, held with its foot on the ground."""
    m, jm = _slider(tmp_path, fix_base)
    z = 0.415 if fix_base else 0.47
    st, jst = _slider_states(m, 1, z=z)
    tau = 5.0 * np.random.default_rng(2).standard_normal((B, m.nj)).astype(np.float32)
    sp, jsp = default_sim_params(solver=solver), jdefault_sim_params(solver=solver)
    ep = default_env_params(B, device="cpu")
    # (as tests/test_torch_crba.py: JAX's dense step indexes its numpy
    # ancestor mask with a jnp index, which cannot be traced under jit)
    jstep = jax.vmap(lambda s, t: jphysics_step(jm, jflat_terrain(size=10.0), jsp, s, t,
                                                jdefault_env_params()))
    if solver == "aba":
        jstep = jax.jit(jstep)
    contacts = 0
    for _ in range(20):
        st, rep = physics_step(m, flat_terrain(), sp, st, torch.as_tensor(tau), ep)
        jst, jrep = jstep(jst, tau)
        contacts += int((rep.geom_forces[..., 2] > 0).sum())
    for name, atol in TOLS.items():
        np.testing.assert_allclose(getattr(st, name).numpy(), np.asarray(getattr(jst, name)),
                                   atol=atol, err_msg=name)
    np.testing.assert_allclose(rep.foot_pos.numpy(), np.asarray(jrep.foot_pos), atol=1e-4)
    assert contacts > 0
    if fix_base:
        assert torch.equal(st.base_pos, initial_state(m, B, pos=(0.1, -0.2, z),
                                                      device="cpu").base_pos)
        assert float(rep.qdd[:, :6].abs().max()) == 0.0


def test_prismatic_aba_matches_crba(tmp_path):
    """tests/test_torch_crba.py::test_aba_matches_crba on the slider."""
    m, _ = _slider(tmp_path)
    st, _ = _slider_states(m, 3, z=0.47)
    tau = torch.as_tensor(5.0 * np.random.default_rng(4).standard_normal((B, m.nj)).astype(np.float32))
    ep = default_env_params(B, device="cpu")
    s1, r1 = physics_step(m, flat_terrain(), default_sim_params(solver="crba"), st, tau, ep)
    s2, r2 = physics_step(m, flat_terrain(), default_sim_params(solver="aba"), st, tau, ep)
    scale = float(r1.qdd.abs().max())
    np.testing.assert_allclose(r2.qdd.numpy(), r1.qdd.numpy(), rtol=0.02, atol=0.01 * scale + 0.05)
    np.testing.assert_allclose(s2.base_pos.numpy(), s1.base_pos.numpy(), atol=1e-4)


def _energy(m, st):
    kin = dynamics.forward_kinematics(m, *_fk_args(st))
    Jv, Jw = dynamics.body_jacobians(m, kin)
    M = dynamics.mass_matrix(m, kin, Jv, Jw)
    u = torch.cat([st.base_lin_vel, st.base_ang_vel, st.joint_vel], -1)
    ke = 0.5 * (u[:, None, :] @ M @ u[:, :, None])[:, 0, 0]
    pe = (torch.as_tensor(m.mass) * 9.81 * kin.com_w[..., 2]).sum(-1)
    return (ke + pe).double()


def test_pendulum_conserves_energy(tmp_path):
    """tests/test_physics.py::test_pendulum_energy_conservation in the port:
    the fixed-base pendulum from 1.2 rad swings 2000 steps of 1 ms with its
    energy within 2 %."""
    m = load_urdf(_write(tmp_path, "pendulum"), fix_base=True)
    st = initial_state(m, 1, pos=(0.0, 0.0, 0.0), device="cpu").replace(
        joint_pos=torch.tensor([[1.2]]))
    sp, ep, tau = default_sim_params(dt=0.001), default_env_params(1, device="cpu"), torch.zeros(1, 1)
    terrain = flat_terrain(height=-100.0)
    e0 = _energy(m, st)
    for _ in range(2000):
        st = physics_step(m, terrain, sp, st, tau, ep)[0]
    assert abs(float(st.joint_pos[0, 0]) - 1.2) > 0.1
    assert float((_energy(m, st) - e0).abs() / e0.abs()) < 0.02


def test_prismatic_env_takes_the_engine_route(tmp_path):
    """An env on a model with a prismatic joint steps the plain engine
    (EngineEnvStep) on flat ground; the fused step refuses the model (the
    kernel, like the JAX package's Pallas body, has no prismatic branch)."""
    m, _ = _slider(tmp_path)
    save_model(m, str(tmp_path / "slider.json"))
    cfg = anymal_c_flat_cfg()
    cfg.env.num_envs, cfg.env.num_actions, cfg.env.num_observations = 3, m.nj, 12 + 3 * m.nj
    cfg.asset.file = str(tmp_path / "slider.json")
    cfg.asset.foot_name = "foot"
    cfg.asset.penalize_contacts_on, cfg.asset.terminate_after_contacts_on = [], []
    cfg.control.stiffness, cfg.control.damping = {"slide": 200.0, "knee": 20.0, "rail": 50.0}, {
        "slide": 5.0, "knee": 0.5, "rail": 2.0}
    cfg.init_state.pos = [0.0, 0.0, 0.5]
    env = LeggedRobot(cfg, device="cpu")
    assert env.engine_step is not None and env.decimated_step is None and env.substep is None
    EngineEnvStep.engine_substeps = 0
    s = env.step(env.reset_all(seed=0), torch.zeros(3, m.nj))
    assert EngineEnvStep.engine_substeps == cfg.control.decimation
    assert bool(torch.isfinite(s.obs).all()) and bool(torch.isfinite(s.rew).all())
    with pytest.raises(NotImplementedError, match="revolute"):
        pk.make_decimated_env_step(m, default_sim_params(), flat_terrain(), 4,
                                   np.ones(m.nj), np.ones(m.nj), m.default_dof_pos, 0.5)
