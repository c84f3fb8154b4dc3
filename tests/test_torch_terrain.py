"""The port's terrain (terrain/generator.py, terrain/heightfield.py), its
rough contact and one rough ABA step against the JAX package on the same
inputs.

* Generator: heights and env origins equal exactly (the port draws from its
  own numpy RandomState in the JAX generator's order), in curriculum,
  randomized and selected modes at small grids and at the rough config's
  full 8 x 8 grid.
* Sampling: heights and normals to 1e-6 at random points, some past the
  grid edge.
* Contact on a heightfield: the tolerances of tests/test_torch_foundations.py
  (rtol 1e-5, atol 1e-3).
* One ABA step on a slope and on a generated grid: the TOLS of
  tests/test_torch_physics.py.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from extended_legged_gym_tpu.envs.legged_robot_config import TerrainCfg as JTerrainCfg
from extended_legged_gym_tpu.physics import contact as jcontact
from extended_legged_gym_tpu.physics import default_sim_params as jdefault_sim_params
from extended_legged_gym_tpu.physics import initial_state as jinitial_state
from extended_legged_gym_tpu.physics.aba import aba_physics_step as jaba_physics_step
from extended_legged_gym_tpu.physics.engine import EnvPhysParams as JEnvPhysParams
from extended_legged_gym_tpu.physics.serialize import load_model as jload_model
from extended_legged_gym_tpu.terrain import heightfield as jhf
from extended_legged_gym_tpu.terrain.generator import Terrain as JTerrain
from extended_legged_gym_tpu_torch.envs.legged_robot_config import TerrainCfg
from extended_legged_gym_tpu_torch.physics import (EnvPhysParams, PhysState, contact,
                                                   default_sim_params, load_model)
from extended_legged_gym_tpu_torch.physics.aba import aba_physics_step
from extended_legged_gym_tpu_torch.terrain import (Terrain, flat_terrain, from_numpy,
                                                   sample_height, sample_height_and_normal)

MODEL = "extended_legged_gym_tpu/robots/data/anymal_c.json"
FIELDS = ("base_pos", "base_quat", "joint_pos", "base_lin_vel", "base_ang_vel", "joint_vel",
          "contact_anchor")
TOLS = dict(base_pos=1e-4, base_quat=1e-4, joint_pos=5e-4, base_lin_vel=2e-2,
            base_ang_vel=2e-2, joint_vel=5e-2)


def _cfgs(**kw):
    jc, c = JTerrainCfg(), TerrainCfg()
    for k, v in kw.items():
        setattr(jc, k, v)
        setattr(c, k, v)
    return jc, c


SMALL = dict(num_rows=3, num_cols=3, terrain_length=4.0, terrain_width=4.0, border_size=2.0)
GRIDS = {
    "curriculum": dict(SMALL, curriculum=True),
    "curriculum_all_types": dict(SMALL, curriculum=True, num_cols=8,
                                 terrain_proportions=[0.1, 0.1, 0.2, 0.1, 0.2, 0.1, 0.1, 0.1]),
    "randomized": dict(SMALL, curriculum=False),
    "selected": dict(SMALL, num_rows=2, num_cols=2, curriculum=False, selected=True,
                     terrain_kwargs={"type": "discrete_obstacles_terrain", "max_height": 0.2,
                                     "min_size": 1.0, "max_size": 2.0, "num_rects": 10}),
    "rough_cfg_full": dict(),
}


@pytest.mark.parametrize("name", list(GRIDS))
def test_generator_matches_jax(name):
    jc, c = _cfgs(**GRIDS[name])
    jt = JTerrain(jc, num_envs=8, seed=3)
    t = Terrain(c, num_envs=8, seed=3)
    np.testing.assert_array_equal(t.heights, jt.heights)
    np.testing.assert_array_equal(t.env_origins, jt.env_origins)
    # the streams stay in step after the grid (the env's spawn-level draw)
    np.testing.assert_array_equal(t.rng.randint(0, 6, 16), np.random.randint(0, 6, 16))
    td, jtd = t.to_device(0.8), jt.to_device(0.8)
    assert td.is_flat == jtd.is_flat and td.hscale == float(jtd.hscale)
    np.testing.assert_array_equal(td.corner_tex, jtd.corner_tex)


def _slope(ax=0.15, ay=-0.08, size=12.0, hscale=0.25):
    """Planar slope h = ax x + ay y (tests/test_physics_kernel.py:150-158)."""
    n = int(size / hscale)
    xs = np.arange(n) * hscale - size / 2
    h = (ax * xs[:, None] + ay * xs[None, :]).astype(np.float32)
    return (jhf.from_numpy(h, hscale, origin=(-size / 2, -size / 2)),
            from_numpy(h, hscale, origin=(-size / 2, -size / 2)))


def _grid():
    """A generated 2 x 3 grid (slopes, rough slope, stairs, discrete)."""
    jc, c = _cfgs(num_rows=2, num_cols=3, terrain_length=4.0, terrain_width=4.0, border_size=1.0,
                  curriculum=True)
    return JTerrain(jc, 4, seed=1).to_device(), Terrain(c, 4, seed=1).to_device()


TERRAINS = {"slope": _slope, "grid": _grid}


def _interior(t, rng, n, margin=1.0):
    """Uniform xy over the terrain, ``margin`` inside its edges."""
    lo = np.array(t.origin) + margin
    hi = np.array(t.origin) + np.array(t.shape) * t.hscale - margin
    return rng.uniform(lo, hi, (n, 2)).astype(np.float32)


@pytest.mark.parametrize("terrain", list(TERRAINS))
def test_sampling_matches_jax(terrain):
    jt, t = TERRAINS[terrain]()
    H, W = t.shape
    lo = np.array(t.origin) - 1.0
    hi = np.array(t.origin) + np.array([H, W]) * t.hscale + 1.0
    xy = np.random.default_rng(0).uniform(lo, hi, (4096, 2)).astype(np.float32)
    want_h, want_n = jhf.sample_height_and_normal(jt, jnp.asarray(xy))
    h, n = sample_height_and_normal(t, torch.as_tensor(xy))
    np.testing.assert_allclose(h.numpy(), np.asarray(want_h), atol=1e-6, rtol=0)
    np.testing.assert_allclose(n.numpy(), np.asarray(want_n), atol=1e-6, rtol=0)
    np.testing.assert_allclose(sample_height(t, torch.as_tensor(xy)).numpy(),
                               np.asarray(jhf.sample_height(jt, jnp.asarray(xy))), atol=1e-6, rtol=0)
    assert ((xy < np.array(t.origin)) | (xy > hi - 1.0)).any()   # some points lie past the edge


def test_flat_terrain_samples_without_grid():
    t = flat_terrain(friction=0.7, height=0.25)
    assert t.is_flat and t.corner_tex is None and t.friction == pytest.approx(0.7)
    h, n = sample_height_and_normal(t, torch.zeros(5, 2))
    assert (h == 0.25).all() and (n == torch.tensor([0.0, 0.0, 1.0])).all()


@pytest.mark.parametrize("terrain", list(TERRAINS))
def test_rough_contact_matches_jax(terrain):
    """Penetrating, receding, sliding and free spheres on the terrain, with
    stale anchors."""
    jt, t = TERRAINS[terrain]()
    rng = np.random.default_rng(1)
    ng = 256
    xy = _interior(t, rng, ng)
    h = np.asarray(jhf.sample_height(jt, jnp.asarray(xy)))
    rad = rng.uniform(0.02, 0.05, ng).astype(np.float32)
    pos = np.c_[xy, h + rng.uniform(-0.05, 0.08, ng)].astype(np.float32)
    vel = rng.standard_normal((ng, 3)).astype(np.float32)
    anchor = (xy + 0.01 * rng.standard_normal((ng, 2))).astype(np.float32)
    jres = jcontact.sphere_terrain_contact(jt, jcontact.default_contact_params(), jnp.asarray(pos),
                                           jnp.asarray(vel), jnp.asarray(rad),
                                           anchor=jnp.asarray(anchor))
    tt = lambda a: torch.as_tensor(a)
    res = contact.sphere_terrain_contact(t, contact.default_contact_params(), tt(pos), tt(vel),
                                         tt(rad), anchor=tt(anchor))
    assert float(np.abs(np.asarray(jres.n)[:, :2]).max()) > 0.05   # normals are tilted
    for f in ("f_el", "n", "kt", "kd_minus_kt", "depth", "anchor"):
        np.testing.assert_allclose(getattr(res, f).numpy(), np.asarray(getattr(jres, f)),
                                   rtol=1e-5, atol=1e-3, err_msg=f)
    np.testing.assert_allclose(res.apply_D(tt(vel)).numpy(),
                               np.asarray(jres.apply_D(jnp.asarray(vel))), rtol=1e-5, atol=1e-2)


def _rough_states(jmodel, jt, t, B, seed):
    """Seeded near-standing states, 0.54 m above the terrain under the base."""
    rng = np.random.default_rng(seed)
    st = jax.tree.map(lambda x: np.broadcast_to(np.asarray(x), (B,) + x.shape).copy(),
                      jinitial_state(jmodel, pos=(0.0, 0.0, 0.54)))
    f = lambda a: a.astype(np.float32)
    xy = _interior(t, rng, B)
    hb = np.asarray(jhf.sample_height(jt, jnp.asarray(xy)))
    base = np.c_[xy, hb + 0.54].astype(np.float32) + f(0.03 * rng.standard_normal((B, 3)))
    return st.replace(base_pos=base, contact_anchor=np.repeat(base[:, None, :2], st.contact_anchor.shape[1], 1),
                      joint_pos=st.joint_pos + f(0.1 * rng.standard_normal((B, 12))),
                      joint_vel=f(0.5 * rng.standard_normal((B, 12))),
                      base_lin_vel=f(0.3 * rng.standard_normal((B, 3))),
                      base_ang_vel=f(0.3 * rng.standard_normal((B, 3))))


@pytest.mark.parametrize("terrain", list(TERRAINS))
def test_rough_aba_step_matches_jax(terrain):
    jt, t = TERRAINS[terrain]()
    jmodel, model = jload_model(MODEL), load_model(MODEL)
    B = 8
    jst = _rough_states(jmodel, jt, t, B, seed=0)
    tau = (5.0 * np.random.default_rng(1).standard_normal((B, 12))).astype(np.float32)
    rng = np.random.default_rng(2)
    fric = rng.uniform(0.5, 1.25, B).astype(np.float32)
    delta = rng.uniform(-1.0, 1.0, B).astype(np.float32)
    jstep = jax.jit(jax.vmap(lambda s, tq, ep: jaba_physics_step(
        jmodel, jt, jdefault_sim_params(), s, tq, ep)))
    jnew, jrep = jstep(jst, jnp.asarray(tau), JEnvPhysParams(jnp.asarray(fric), jnp.asarray(delta)))
    st = PhysState(*[torch.as_tensor(np.asarray(getattr(jst, k))) for k in FIELDS])
    new, rep = aba_physics_step(model, t, default_sim_params(), st, torch.as_tensor(tau),
                                EnvPhysParams(torch.as_tensor(fric), torch.as_tensor(delta)))
    assert float(np.abs(np.asarray(jrep.geom_forces)).sum()) > 100.0   # feet are loaded
    for name, atol in TOLS.items():
        np.testing.assert_allclose(getattr(new, name).numpy(), np.asarray(getattr(jnew, name)),
                                   atol=atol, err_msg=name)
    np.testing.assert_allclose(new.contact_anchor.numpy(), np.asarray(jnew.contact_anchor), atol=1e-4)
    np.testing.assert_allclose(rep.foot_pos.numpy(), np.asarray(jrep.foot_pos), atol=1e-4)
    np.testing.assert_allclose(rep.geom_forces.numpy(), np.asarray(jrep.geom_forces), atol=0.5)
