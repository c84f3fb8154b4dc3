"""The perception modules against the JAX package: ray patterns, heightfield
raycasts, the ray sensor and the depth camera.

Patterns are host numpy and must agree to 1e-6.  Raycasts run from seeded
poses over flat ground and a generated 4 x 4 curriculum grid (all terrain
types), with full-quaternion and yaw-only sensors: distances and hit points
to 1e-4 m, hits exactly.  The depth camera renders from the same poses at
the estimator's 48 x 24 -> 32 x 16 and at the default 60 x 30 -> 56 x 28
(both resizes shrink, so the antialiased triangle kernel is exercised), to
1e-4; with distance noise, the JAX draw is injected.  Terrains with a
ceiling or a triangle mesh are cast too (they were refused before the
confined slice)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from extended_legged_gym_tpu.envs.legged_robot_config import DepthCfg as JDepthCfg
from extended_legged_gym_tpu.envs.legged_robot_config import RaycasterCfg as JRaycasterCfg
from extended_legged_gym_tpu.envs.legged_robot_config import TerrainCfg as JTerrainCfg
from extended_legged_gym_tpu.perception import depth_camera as jdc
from extended_legged_gym_tpu.perception import patterns as jpat
from extended_legged_gym_tpu.perception.raycast import RayCaster as JRayCaster
from extended_legged_gym_tpu.perception.raycast import raycast as jraycast
from extended_legged_gym_tpu.terrain import flat_terrain as jflat_terrain
from extended_legged_gym_tpu.terrain.generator import Terrain as JTerrain
from extended_legged_gym_tpu_torch.envs.legged_robot_config import (DepthCfg, RaycasterCfg,
                                                                    TerrainCfg)
from extended_legged_gym_tpu_torch.perception import depth_camera as dc
from extended_legged_gym_tpu_torch.perception import patterns as pat
from extended_legged_gym_tpu_torch.perception.raycast import RayCaster, raycast
from extended_legged_gym_tpu_torch.terrain import Terrain, TerrainData, flat_terrain, from_numpy

B = 12


def grid_cfg(c):
    c.num_rows = c.num_cols = 4
    c.terrain_length = c.terrain_width = 4.0
    c.border_size = 2.0
    return c


@pytest.fixture(scope="module")
def terrains():
    """(name, JAX terrain, port terrain, xy range of the poses)."""
    jt = JTerrain(grid_cfg(JTerrainCfg()), 16, seed=5).to_device()
    t = Terrain(grid_cfg(TerrainCfg()), 16, seed=5).to_device()
    np.testing.assert_array_equal(t.height, np.asarray(jt.height))
    assert np.ptp(t.height) > 0.3
    return [("flat", jflat_terrain(size=20.0), flat_terrain(), (-5.0, 5.0)),
            ("grid", jt, t, (2.5, 15.5))]


def poses(terrain, lo_hi, seed):
    """Seeded bases 0.45-0.75 m over the ground: yaw anywhere, roll and
    pitch within 0.3 rad."""
    from extended_legged_gym_tpu_torch.terrain import sample_height
    from extended_legged_gym_tpu_torch.utils.math import ypr_to_quat

    rng = np.random.default_rng(seed)
    xy = rng.uniform(*lo_hi, (B, 2)).astype(np.float32)
    z = sample_height(terrain, torch.as_tensor(xy)) + torch.as_tensor(rng.uniform(0.45, 0.75, B),
                                                                      dtype=torch.float32)
    ypr = torch.as_tensor(rng.uniform([-np.pi, -0.3, -0.3], [np.pi, 0.3, 0.3], (B, 3)),
                          dtype=torch.float32)
    q = ypr_to_quat(ypr[:, 0], ypr[:, 1], ypr[:, 2])
    pos = torch.cat([torch.as_tensor(xy), z[:, None]], dim=1)
    return pos, q / q.norm(dim=1, keepdim=True)


# -------------------------------------------------------------- patterns
@pytest.mark.parametrize("name, kw", [
    ("single", {}),
    ("cone", dict(num_rays=32, ray_angle=60.0)),
    ("cone", dict(num_rays=17, ray_angle=45.0)),
    ("spherical", dict(spherical_num_azimuth=8, spherical_num_elevation=4)),
    ("spherical", dict(spherical_num_azimuth=5, spherical_num_elevation=3)),
    ("spherical2", dict(spherical2_num_points=32)),
    ("spherical2", dict(spherical2_num_points=20, spherical2_polar_axis=[1.0, 0.0, 0.0])),
    ("spherical2", dict(spherical2_num_points=9, spherical2_polar_axis=[0.0, 0.0, -1.0])),
])
def test_pattern_matches_jax(name, kw):
    jc, c = JRaycasterCfg(), RaycasterCfg()
    for cfg in (jc, c):
        cfg.ray_pattern = name
        for k, v in kw.items():
            setattr(cfg, k, v)
    want, got = jpat.make_pattern(jc), pat.make_pattern(c)
    assert got.dtype == np.float32 and got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=1e-6)
    np.testing.assert_allclose(np.linalg.norm(got, axis=1), 1.0, atol=1e-6)


@pytest.mark.parametrize("size, res", [(1.0, 0.1), (1.6, 0.2)])
def test_grid_pattern_matches_jax(size, res):
    for got, want in zip(pat.grid_pattern(size, res), jpat.grid_pattern(size, res)):
        np.testing.assert_allclose(got, want, atol=1e-6)
    c, jc = RaycasterCfg(), JRaycasterCfg()
    c.ray_pattern = jc.ray_pattern = "grid"
    for make, cfg in ((pat.make_pattern, c), (jpat.make_pattern, jc)):
        with pytest.raises(ValueError, match="unknown ray pattern"):
            make(cfg)


# -------------------------------------------------------------- raycasts
def test_raycast_matches_jax(terrains):
    """Random unit directions from seeded origins, 5 m and 2 m reach."""
    rng = np.random.default_rng(1)
    for name, jt, t, lo_hi in terrains:
        pos, _ = poses(t, lo_hi, seed=2)
        dirs = rng.standard_normal((B, 40, 3)).astype(np.float32)
        dirs[..., 2] = -np.abs(dirs[..., 2]) - 0.2          # mostly downward
        dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
        origins = np.broadcast_to(pos.numpy()[:, None, :], dirs.shape).copy()
        for reach in (5.0, 2.0):
            want = jraycast(jt, jnp.asarray(origins), jnp.asarray(dirs), reach)
            got = raycast(t, torch.as_tensor(origins), torch.as_tensor(dirs), reach)
            np.testing.assert_array_equal(got.hit.numpy(), np.asarray(want.hit), err_msg=name)
            np.testing.assert_allclose(got.distance.numpy(), np.asarray(want.distance), atol=1e-4,
                                       err_msg=name)
            np.testing.assert_allclose(got.points.numpy(), np.asarray(want.points), atol=1e-4,
                                       err_msg=name)
            assert got.hit.any()


@pytest.mark.parametrize("yaw_only", [False, True])
@pytest.mark.parametrize("pattern", ["cone", "spherical"])
def test_ray_caster_matches_jax(terrains, yaw_only, pattern):
    for name, jt, t, lo_hi in terrains:
        jc, c = JRaycasterCfg(), RaycasterCfg()
        for cfg in (jc, c):
            cfg.ray_pattern, cfg.attach_yaw_only = pattern, yaw_only
        pos, quat = poses(t, lo_hi, seed=3 + yaw_only)
        jcaster, caster = JRayCaster(jc, jt), RayCaster(c, t, device="cpu")
        jp, jq = jnp.asarray(pos.numpy()), jnp.asarray(quat.numpy())
        want, got = jcaster.cast(jp, jq), caster.cast(pos, quat)
        np.testing.assert_array_equal(got.hit.numpy(), np.asarray(want.hit))
        np.testing.assert_allclose(got.distance.numpy(), np.asarray(want.distance), atol=1e-4,
                                   err_msg=name)
        np.testing.assert_allclose(got.points.numpy(), np.asarray(want.points), atol=1e-4,
                                   err_msg=name)
        obs = caster.observations(pos, quat)
        np.testing.assert_allclose(obs.numpy(), np.asarray(jcaster.observations(jp, jq)),
                                   atol=1e-5)
        assert obs.shape == (B, caster.num_rays) and 0.0 <= float(obs.min()) <= float(obs.max()) <= 1.0
        assert got.hit.any() and not got.hit.all()


# -------------------------------------------------------------- depth camera
@pytest.mark.parametrize("original, resized", [([48, 24], [32, 16]), ([60, 30], [56, 28])])
def test_depth_camera_matches_jax(terrains, original, resized):
    for name, jt, t, lo_hi in terrains:
        jc, c = JDepthCfg(), DepthCfg()
        for cfg in (jc, c):
            cfg.camera_type, cfg.original, cfg.resized = "Warp", original, resized
        jcam, cam = jdc.make_depth_camera(jc, B, jt), dc.make_depth_camera(c, B, t, device="cpu")
        assert isinstance(cam, dc.DepthCameraRaycast)
        pos, quat = poses(t, lo_hi, seed=7)
        want = np.asarray(jcam.render(jnp.asarray(pos.numpy()), jnp.asarray(quat.numpy())))
        got = cam.render(pos, quat)
        assert got.shape == (B, resized[1], resized[0]) == want.shape
        np.testing.assert_allclose(got.numpy(), want, atol=1e-4, err_msg=name)
        # the frames see ground and sky; the resize's normalized weights can
        # overshoot [0, 1] by float32 rounding, in JAX too
        assert -1e-6 <= float(got.min()) < 0.5 < float(got.max()) <= 1.0 + 1e-6
        buf = cam.push(cam.init_buffer(), got)
        assert buf.shape == (B, c.buffer_len, resized[1], resized[0]) and torch.equal(buf[:, -1], got)


def test_depth_noise_and_fake_camera_match_jax():
    jc, c = JDepthCfg(), DepthCfg()
    for cfg in (jc, c):
        cfg.dis_noise, cfg.invert, cfg.scale, cfg.near_clip = 0.05, False, 2.0, 0.1
    depth = np.random.default_rng(4).uniform(0.0, 2.5, (B, 30, 60)).astype(np.float32)
    key = jax.random.PRNGKey(9)
    jcam, cam = jdc.DepthCameraBase(jc, B), dc.DepthCameraBase(c, B, device="cpu")
    cam._draw_noise = lambda shape: torch.as_tensor(np.array(jax.random.normal(key, shape)))
    np.testing.assert_allclose(cam.process(torch.as_tensor(depth), noise=True).numpy(),
                               np.asarray(jcam.process(jnp.asarray(depth), key)), atol=1e-5)
    np.testing.assert_allclose(cam.process(torch.as_tensor(depth)).numpy(),
                               np.asarray(jcam.process(jnp.asarray(depth))), atol=1e-5)
    c.camera_type = "Fake"
    fake = dc.make_depth_camera(c, B, flat_terrain(), device="cpu")
    assert isinstance(fake, dc.DepthCameraFake)
    assert torch.equal(fake.render(torch.zeros(B, 3), torch.zeros(B, 4)), torch.zeros(B, 28, 56))
    c.camera_type = None
    assert dc.make_depth_camera(c, B, flat_terrain(), device="cpu") is None


def test_pinhole_grid_matches_jax():
    for w, h, fov in ((48, 24, 100.0), (60, 30, 87.0)):
        np.testing.assert_allclose(dc.pinhole_ray_grid(w, h, fov), jdc.pinhole_ray_grid(w, h, fov),
                                   atol=1e-6)


# ------------------------------------------------- ceilings and meshes
@dataclasses.dataclass(frozen=True, eq=False)
class _CeilingTerrain(TerrainData):
    has_ceiling: bool = True


@dataclasses.dataclass(frozen=True, eq=False)
class _MeshTerrain(TerrainData):
    trimesh: object = "mesh"


@pytest.mark.parametrize("cls, match", [(_CeilingTerrain, "ceiling"), (_MeshTerrain, "triangle mesh")])
def test_ceiling_and_trimesh_terrains_are_refused(cls, match):
    """Terrains with a ceiling or a triangle mesh were refused before the
    confined slice; now ``raycast`` and the sensor take them: the ray casts
    of a two-layer grid (``match`` "ceiling") or of its wall-corrected mesh
    ("triangle mesh") agree with the JAX package to 1e-4 m, hits exactly
    (tests/test_torch_trimesh.py holds the mesh queries closer)."""
    from extended_legged_gym_tpu.perception.trimesh import trimesh_from_heightfield as jmesh_of
    from extended_legged_gym_tpu.terrain import from_numpy as jfrom_numpy
    from extended_legged_gym_tpu_torch.perception.trimesh import trimesh_from_heightfield

    rng = np.random.default_rng(0)
    g = (0.1 * rng.standard_normal((16, 16))).astype(np.float32)
    c = (g + 1.2).astype(np.float32)
    c[:, :4] = 1e6
    mesh = trimesh_from_heightfield(g, 0.25, ceiling=c, slope_threshold=1.5) \
        if cls is _MeshTerrain else None
    jmesh = jmesh_of(g, 0.25, ceiling=c, slope_threshold=1.5) if cls is _MeshTerrain else None
    terrain = from_numpy(g, 0.25, ceiling=c, trimesh=mesh)
    jterrain = jfrom_numpy(g, 0.25, ceiling=c, trimesh=jmesh)
    assert terrain.has_ceiling and (terrain.trimesh is not None) == (cls is _MeshTerrain)
    cfg, jcfg = RaycasterCfg(), JRaycasterCfg()
    for x in (cfg, jcfg):
        x.ray_pattern, x.spherical_num_azimuth, x.spherical_num_elevation = "spherical", 8, 4
        x.max_distance = 3.0
    pos = np.concatenate([rng.uniform(0.5, 3.2, (B, 2)), rng.uniform(0.3, 0.8, (B, 1))], 1)
    quat = rng.standard_normal((B, 4))
    quat /= np.linalg.norm(quat, axis=1, keepdims=True)
    pos, quat = pos.astype(np.float32), quat.astype(np.float32)
    res = RayCaster(cfg, terrain, device="cpu").cast(torch.as_tensor(pos), torch.as_tensor(quat))
    jres = JRayCaster(jcfg, jterrain).cast(jnp.asarray(pos), jnp.asarray(quat))
    np.testing.assert_array_equal(res.hit.numpy(), np.asarray(jres.hit))
    np.testing.assert_allclose(res.distance.numpy(), np.asarray(jres.distance), atol=1e-4)
    assert res.hit.any() and not res.hit.all(), match
