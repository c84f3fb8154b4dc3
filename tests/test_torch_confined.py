"""The confined, OBJ and obstacle terrains against the JAX package, bit for
bit: each of the six confined generators (with the random ones seeded: the
JAX package draws from numpy's global stream, the port from a
``RandomState`` of the same seed), the curriculum grid over all six types
and its spawn origins, ``to_device`` (layers, corner textures, the
wall-corrected mesh's bucketing), the spawn levels the env draws next from
the same stream, the OBJ parser and rasterizer on an inline mesh (mirrors
tests/test_terrain.py::test_obj_rasterization_box) and ``stamp_obstacles``.
Sampling the ceiling layer agrees to 1e-6."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from extended_legged_gym_tpu.envs.legged_robot_config import TerrainCfg as JTerrainCfg
from extended_legged_gym_tpu.terrain import confined as jconf
from extended_legged_gym_tpu.terrain import heightfield as jhf
from extended_legged_gym_tpu.terrain import mesh as jmesh
from extended_legged_gym_tpu.terrain import obstacles as jobs
from extended_legged_gym_tpu_torch.envs.legged_robot_config import TerrainCfg
from extended_legged_gym_tpu_torch.terrain import confined as conf
from extended_legged_gym_tpu_torch.terrain import heightfield as hf
from extended_legged_gym_tpu_torch.terrain import mesh
from extended_legged_gym_tpu_torch.terrain import obstacles

GENERATORS = ("tunnel_terrain", "barrier_terrain", "timber_piles_terrain",
              "confined_gap_terrain", "column_obstacles_terrain", "wall_with_gap_terrain")
KWARGS = {
    "tunnel_terrain": [{}, dict(tunnel_width=1.8, tunnel_height=0.6)],
    "barrier_terrain": [{}, dict(barrier_width=0.5, barrier_height=0.3, gap_height=0.4)],
    "timber_piles_terrain": [{}, dict(timber_spacing=0.5, timber_size=0.4, pile_height=0.6,
                                      hanging_obstacles=True, position_noise=0.3)],
    "confined_gap_terrain": [{}, dict(gap_width=1.2)],
    "column_obstacles_terrain": [{}, dict(column_spacing=0.3, density=0.8)],
    "wall_with_gap_terrain": [{}, dict(gap_width=2.0, gap_height=0.2, gap_center_height=0.7,
                                       wall_thickness=0.1)],
}


@pytest.mark.parametrize("name", GENERATORS)
def test_generators_match_bit_for_bit(name):
    for k, kw in enumerate(KWARGS[name]):
        np.random.seed(10 + k)
        jt = getattr(jconf, name)(jconf.SubTerrainConfined(60, 70, 0.005, 0.1), **kw)
        t = getattr(conf, name)(conf.SubTerrainConfined(60, 70, 0.005, 0.1),
                                np.random.RandomState(10 + k), **kw)
        np.testing.assert_array_equal(t.ground, jt.ground, err_msg=f"{name} {kw}")
        np.testing.assert_array_equal(t.ceiling, jt.ceiling, err_msg=f"{name} {kw}")
        assert t.ground.dtype == jt.ground.dtype == np.float32


def grid_cfgs(rows, cols, props, length=4.0, border=1.0):
    out = []
    for Cfg in (JTerrainCfg, TerrainCfg):
        c = Cfg()
        c.num_rows, c.num_cols = rows, cols
        c.terrain_length = c.terrain_width = length
        c.border_size = border
        c.confined_terrain_proportions = list(props)
        out.append(c)
    return out


@pytest.mark.parametrize("rows, cols, props", [
    (2, 6, [1 / 6, 2 / 6, 3 / 6, 4 / 6, 5 / 6, 1.0]),     # all six types
    (3, 4, [0.25, 0.5, 0.75, 1.0]),                          # the default four, rising difficulty
    (3, 3, [0.0, 0.0, 1.0, 1.0]),                            # the timber-pile nav arena
])
def test_curriculum_grid_and_to_device(rows, cols, props):
    jc, c = grid_cfgs(rows, cols, props, length=6.0 if rows == 3 and cols == 3 else 4.0,
                      border=3.0 if rows == 3 and cols == 3 else 1.0)
    jt = jconf.TerrainConfined(jc, num_envs=8, seed=3)
    t = conf.TerrainConfined(c, num_envs=8, seed=3)
    np.testing.assert_array_equal(t.ground, jt.ground)
    np.testing.assert_array_equal(t.ceiling, jt.ceiling)
    np.testing.assert_array_equal(t.env_origins, jt.env_origins)
    # the env's spawn levels continue the same stream
    np.testing.assert_array_equal(t.rng.randint(0, rows, 16), np.random.randint(0, rows, 16))

    jd, d = jt.to_device(friction=0.8), t.to_device(friction=0.8)
    assert d.has_ceiling == jd.has_ceiling and d.is_flat == jd.is_flat
    np.testing.assert_array_equal(d.height, np.asarray(jd.height))
    np.testing.assert_array_equal(d.ceiling, np.asarray(jd.ceiling))
    np.testing.assert_array_equal(d.corner_tex, np.asarray(jd.corner_tex))
    np.testing.assert_array_equal(d.ceiling_tex, np.asarray(jd.ceiling_tex))
    assert (d.hscale, d.origin, d.friction) == (float(jd.hscale), tuple(map(float, jd.origin)),
                                                float(jd.friction))
    for k in ("v0", "e1", "e2", "normal", "cell_tris"):
        np.testing.assert_array_equal(getattr(d.trimesh, k), np.asarray(getattr(jd.trimesh, k)))
    rng = np.random.default_rng(0)
    xy = rng.uniform(-1.0, rows * t.env_length + 1.0, (512, 2)).astype(np.float32)
    np.testing.assert_allclose(hf.sample_ceiling(d, torch.as_tensor(xy)).numpy(),
                               np.asarray(jhf.sample_ceiling(jd, jnp.asarray(xy))), atol=1e-6)
    np.testing.assert_allclose(hf.sample_height(d, torch.as_tensor(xy)).numpy(),
                               np.asarray(jhf.sample_height(jd, jnp.asarray(xy))), atol=1e-6)
    assert t.to_device(attach_trimesh=False).trimesh is None


def box_scene_obj(path):
    """A 4 x 4 floor, a 1 x 1 platform at 0.3 m and a ceiling slab at 1.2 m,
    written as an OBJ with one quad face (fan-triangulated) and triangles."""
    with open(path, "w") as f:
        for v in ([0, 0, 0], [4, 0, 0], [4, 4, 0], [0, 4, 0], [1.5, 1.5, 0.3], [2.5, 1.5, 0.3],
                  [2.5, 2.5, 0.3], [1.5, 2.5, 0.3], [0, 0, 1.2], [4, 0, 1.2], [4, 4, 1.2],
                  [0, 4, 1.2]):
            f.write("v {} {} {}\n".format(*v))
        f.write("f 1/1 2/2 3/3 4/4\nf 5 6 7\nf 5 7 8\nf 9 10 11\nf 9 11 12\n")


def test_obj_rasterization_and_terrain(tmp_path):
    path = str(tmp_path / "scene.obj")
    box_scene_obj(path)
    (jv, jf), (v, f) = jmesh.load_obj(path), mesh.load_obj(path)
    np.testing.assert_array_equal(v, jv)
    np.testing.assert_array_equal(f, jf)
    for hscale, z_ref, pad in ((0.25, 0.6, 0.0), (0.1, 0.5, 0.5)):
        jg, jc, jvmin = jmesh.rasterize_mesh(jv, jf, hscale, z_ref, pad)
        g, c, vmin = mesh.rasterize_mesh(v, f, hscale, z_ref, pad)
        np.testing.assert_array_equal(g, jg)
        np.testing.assert_array_equal(c, jc)
        np.testing.assert_array_equal(vmin, jvmin)
    i, j = int((2.0 - vmin[0]) / 0.1), int((2.0 - vmin[1]) / 0.1)
    assert abs(g[i, j] - 0.3) < 0.05 and abs(c[i, j] - 1.2) < 0.05
    jt, t = jmesh.TerrainObj(path, hscale=0.2), mesh.TerrainObj(path, hscale=0.2)
    pos = np.array([[2.0, 2.0, 0.0], [0.5, 0.5, 0.0], [3.9, 0.1, 0.0]])
    for cast in (-1, 1):
        np.testing.assert_array_equal(t.get_heights_batch(pos, cast),
                                      jt.get_heights_batch(pos, cast))
    jd, d = jt.to_device(), t.to_device()
    assert d.has_ceiling and d.trimesh is not None
    np.testing.assert_array_equal(d.ceiling_tex, np.asarray(jd.ceiling_tex))
    for k in ("v0", "cell_tris"):
        np.testing.assert_array_equal(getattr(d.trimesh, k), np.asarray(getattr(jd.trimesh, k)))


def test_stamp_obstacles_match():
    h = np.zeros((120, 100), np.float32)
    h[40:60] = 0.2
    origins = np.array([[3.0, 3.0, 0.0], [8.0, 5.0, 0.2], [1.0, 9.0, 0.0]])
    for seed in (0, 5):
        jcfg, cfg = jobs.ObstacleGenConfig(), obstacles.ObstacleGenConfig()
        for c in (jcfg, cfg):
            c.cluster_probability = 0.6
        out = obstacles.stamp_obstacles(h, 0.1, (0.0, -0.5), origins, cfg, seed=seed)
        jout = jobs.stamp_obstacles(h, 0.1, (0.0, -0.5), origins, jcfg, seed=seed)
        np.testing.assert_array_equal(out, jout)
        assert (out > h).any() and out.dtype == np.float32
