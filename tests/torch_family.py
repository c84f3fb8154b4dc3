"""Helpers shared by the parity tests of the plain LeggedRobot family and its
variants (tests/test_torch_legged_*.py): the port's and the JAX package's
env of a registered task at a small size, the JAX state carried into the
port with the fields torch_parity.to_torch_state leaves out, and states
with every field the reward terms read drawn from a numpy seed; configs
compared field by field."""
import jax
import jax.numpy as jnp
import numpy as np
import torch

from extended_legged_gym_tpu.robots import task_registry as jtask_registry
from extended_legged_gym_tpu.utils.config import class_to_dict as jclass_to_dict
from extended_legged_gym_tpu_torch import robots  # noqa: F401
from extended_legged_gym_tpu_torch.utils.config import class_to_dict
from extended_legged_gym_tpu_torch.utils.task_registry import task_registry
from torch_parity import to_torch_state

E = 4
# the tasks this family adds to the port's registry
TASKS = ("a1", "a1_flat", "go2_rough", "go2_flat", "anymal_b", "cassie", "elspider_air_rough",
         "anymal_c_rough_teacher", "load_adapt_anymal_c", "pose_anymal_c", "stand_anymal_c",
         "anymal_c_student", "pose_go2_flat", "load_adapt_go2_flat", "stand_go2_flat",
         "pose_elspider_air_flat", "foot_track_elspider_air_flat", "foot_track_elspider_air_hang")


def small(cfg, n=E):
    """``n`` envs, no noise, randomization or pushes; a generated terrain cut
    to a 2 x 2 grid of 4 m subterrains with levels frozen (the spawn levels
    still drawn from 0..1)."""
    cfg.env.num_envs = n
    cfg.noise.add_noise = False
    cfg.domain_rand.randomize_friction = cfg.domain_rand.randomize_base_mass = False
    cfg.domain_rand.push_robots = False
    t = cfg.terrain
    t.num_rows = t.num_cols = 2
    t.terrain_length = t.terrain_width = 4.0
    t.border_size = 2.0
    t.max_init_terrain_level = 1
    t.freeze_terrain_levels = True
    return cfg


def make_pair(task, n=E, base_z=None):
    """(JAX env on its ABA solver, port env on the CPU) of ``task``; with
    ``base_z`` both start with the base at that height."""
    jcfg, _ = jtask_registry.get_cfgs(task)
    jcfg = small(jcfg, n)
    jcfg.sim.solver = "aba"
    cfg, _ = task_registry.get_cfgs(task)
    cfg = small(cfg, n)
    if base_z is not None:
        jcfg.init_state.pos = cfg.init_state.pos = [0.0, 0.0, base_z]
    jenv = jtask_registry.task_classes[task](jcfg)
    env, _ = task_registry.make_env(task, env_cfg=cfg, device="cpu")
    return jenv, env


def to_port(js):
    """A JAX EnvState as the port's, privileged observation and base
    accelerations included."""
    t = lambda x: None if x is None else torch.as_tensor(np.array(x))
    return to_torch_state(js).replace(
        privileged_obs=t(js.privileged_obs), base_lin_acc=t(js.base_lin_acc),
        base_ang_acc=t(js.base_ang_acc), last_root_vel=t(js.last_root_vel))


def drawn_state(jenv, seed):
    """The JAX env's reset state with every field a reward term or the
    observation reads drawn from ``seed``: feet in and out of contact, some
    pushed sideways and some past ``max_contact_force``, joint velocities
    and torques past their limits, some commands below ``speed_min``,
    terminations and time-outs (env 0 fell, env 1 timed out), air and
    contact times (env 1 long in the air), accelerations, and a previous
    observation (the student's history)."""
    js = jenv.reset_all(jax.random.PRNGKey(seed))
    rng = np.random.default_rng(seed)
    B, nf, nj = jenv.num_envs, jenv.num_feet, jenv.num_dof
    ng = int(jenv.model.geom_radius.shape[0])
    f32 = lambda a: jnp.asarray(np.asarray(a, np.float32))
    n = lambda *s: rng.standard_normal(s)
    gf = 20.0 * n(B, ng, 3) * (rng.uniform(size=(B, ng, 1)) < 0.5)
    feet = np.asarray(jenv.feet_geoms)
    fz = rng.choice([0.0, 0.05, 0.5, 20.0, 600.0], size=(B, nf))
    fz[1] = 0.0                                            # env 1 in the air
    gf[:, feet, 2] = fz
    gf[:, feet, :2] = rng.choice([0.0, 1.0, 200.0], size=(B, nf, 1)) * n(B, nf, 2)
    quat = n(B, 4)
    quat /= np.linalg.norm(quat, axis=1, keepdims=True)
    commands = np.asarray(js.commands).copy()
    commands[:, :3] = rng.uniform(-1.0, 1.0, (B, 3))
    commands[::2, :2] *= 0.05                              # below speed_min
    if commands.shape[1] == 8:
        commands[:, 4] = rng.uniform(0.35, 0.6, B)
        commands[:, 5:7] = rng.uniform(-0.3, 0.3, (B, 2))
    reset = rng.uniform(size=B) < 0.5
    timeout = reset & (rng.uniform(size=B) < 0.5)
    reset[:2], timeout[:2] = True, (False, True)           # env 0 fell, env 1 timed out
    air = rng.uniform(0.0, 2.0, (B, nf)) * (rng.uniform(size=(B, nf)) < 0.6)
    air[1] = 1.8
    last_contacts = rng.uniform(size=(B, nf)) < 0.5
    last_contacts[1] = False
    phys = js.phys
    base_pos = np.asarray(phys.base_pos) + 0.1 * n(B, 3)
    return js.replace(
        phys=phys.replace(
            base_pos=f32(base_pos), base_quat=f32(quat),
            joint_pos=f32(np.asarray(phys.joint_pos) + 0.8 * n(B, nj)),
            joint_vel=f32(30.0 * n(B, nj)),
            base_lin_vel=f32(n(B, 3)), base_ang_vel=f32(n(B, 3))),
        commands=f32(commands), actions=f32(n(B, nj)), last_actions=f32(n(B, nj)),
        last_dof_vel=f32(10.0 * n(B, nj)), torques=f32(60.0 * n(B, nj)),
        feet_air_time=f32(air),
        feet_contact_time=f32(rng.uniform(0.0, 1.0, (B, nf)) * (rng.uniform(size=(B, nf)) < 0.6)),
        last_contacts=jnp.asarray(last_contacts),
        base_lin_vel=f32(n(B, 3)), base_ang_vel=f32(n(B, 3)),
        base_lin_acc=f32(5.0 * n(B, 3)), base_ang_acc=f32(5.0 * n(B, 3)),
        projected_gravity=f32(np.asarray([0.0, 0.0, -1.0]) + 0.3 * n(B, 3)),
        foot_positions=f32(base_pos[:, None, :] + 0.4 * n(B, nf, 3)),
        foot_velocities=f32(n(B, nf, 3)), geom_forces=f32(gf),
        measured_heights=f32(0.1 * n(*np.asarray(js.measured_heights).shape)),
        obs=f32(n(*np.asarray(js.obs).shape)),
        reset_buf=jnp.asarray(reset), time_out_buf=jnp.asarray(timeout),
        episode_length=jnp.asarray(rng.integers(0, 400, B), js.episode_length.dtype))


def jax_ctx(jenv, s):
    """The contact context of the JAX env's ``_compute_reward``."""
    contact = s.geom_forces[:, jenv.feet_geoms, 2] > 1.0
    contact_filt = contact | s.last_contacts
    return dict(contact=contact, contact_filt=contact_filt,
                first_contact=(s.feet_air_time > 0.0) & contact_filt,
                feet_air_time=s.feet_air_time + jenv.dt,
                feet_contact_time=s.feet_contact_time + jenv.dt)


# fields of the JAX configs the port does not carry: the default joint
# angles (both envs take the model JSON's, held below) and the runner's
# staged-reward flag (the JAX runner never reads it)
NOT_CARRIED = set()


def _flat(d, prefix=""):
    out = {}
    for k, v in d.items():
        if isinstance(v, dict) and v and not k.endswith(("stiffness", "damping",
                                                         "default_joint_angles")):
            out.update(_flat(v, f"{prefix}{k}."))
        else:
            out[prefix + k] = v
    return out


def assert_cfg_equal(cfg, jcfg):
    """Every field of the port's config equals the JAX one's; every JAX field
    the port lacks is at the JAX class's default, or in NOT_CARRIED."""
    got, want = _flat(class_to_dict(cfg)), _flat(jclass_to_dict(jcfg))
    default = _flat(jclass_to_dict(type(jcfg)()))
    for k, v in got.items():
        assert k in want, k
        assert v == want[k], (k, v, want[k])
    for k in set(want) - set(got) - NOT_CARRIED:
        assert want[k] == default.get(k, 0.0), (k, want[k])
