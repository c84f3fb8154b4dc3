"""The triangle-mesh queries against the JAX package: bucketing, ray casts
and signed distances (perception/trimesh.py), the blended SDF
(perception/sdf.py), ray casts under a ceiling and on meshes through
``raycast``, and the ceiling and mesh contacts (physics/contact.py).

Bucketing is host numpy and must be identical (``cell_tris``, ``v0``,
``e1``, ``e2``, normals).  Queries run in float32 on the same inputs:
distances, SDF values, hit and nearest points to 1e-5 m (one float32 ulp of
a few meters is ~5e-7; the two libraries order their sums differently),
hits and normals exactly (normals to 1e-6), gradients to 1e-4.  The
analytic checks mirror tests/test_trimesh.py: a lateral wall, inside
negative, a tessellated sphere, heightfield / mesh consistency, confined
walls seen laterally."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from extended_legged_gym_tpu.envs.legged_robot_config import TerrainCfg as JTerrainCfg
from extended_legged_gym_tpu.perception import sdf as jsdf
from extended_legged_gym_tpu.perception import trimesh as jtm
from extended_legged_gym_tpu.perception.raycast import raycast as jraycast
from extended_legged_gym_tpu.physics.contact import default_contact_params as jcontact_params
from extended_legged_gym_tpu.physics.contact import sphere_terrain_contact as jcontact
from extended_legged_gym_tpu.terrain import heightfield as jhf
from extended_legged_gym_tpu.terrain.confined import TerrainConfined as JTerrainConfined
from extended_legged_gym_tpu_torch.envs.legged_robot_config import TerrainCfg
from extended_legged_gym_tpu_torch.perception import sdf
from extended_legged_gym_tpu_torch.perception import trimesh as tm
from extended_legged_gym_tpu_torch.perception.raycast import raycast
from extended_legged_gym_tpu_torch.physics.contact import (default_contact_params,
                                                           sphere_terrain_contact)
from extended_legged_gym_tpu_torch.terrain import heightfield as hf
from extended_legged_gym_tpu_torch.terrain.confined import TerrainConfined
from torch_parity import one_torch_thread  # noqa: F401 (autouse)

ATOL = 1e-5


def box_mesh(cx, cy, z0, z1, hx, hy):
    """Axis-aligned box [cx±hx, cy±hy, z0..z1] as 12 outward-wound triangles."""
    x0, x1, y0, y1 = cx - hx, cx + hx, cy - hy, cy + hy
    v = np.array([[x0, y0, z0], [x1, y0, z0], [x1, y1, z0], [x0, y1, z0],
                  [x0, y0, z1], [x1, y0, z1], [x1, y1, z1], [x0, y1, z1]], dtype=np.float64)
    f = np.array([[0, 2, 1], [0, 3, 2], [4, 5, 6], [4, 6, 7], [0, 1, 5], [0, 5, 4],
                  [2, 3, 7], [2, 7, 6], [1, 2, 6], [1, 6, 5], [3, 0, 4], [3, 4, 7]])
    return v, f


def ground_plane(size=10.0, z=0.0):
    v = np.array([[-size, -size, z], [size, -size, z], [size, size, z], [-size, size, z]])
    return v, np.array([[0, 1, 2], [0, 2, 3]])


def merge(*meshes):
    vs, fs, off = [], [], 0
    for v, f in meshes:
        vs.append(v)
        fs.append(np.asarray(f) + off)
        off += v.shape[0]
    return np.concatenate(vs), np.concatenate(fs)


def icosphere(levels=3):
    v = np.array([[1, 0, 0], [-1, 0, 0], [0, 1, 0], [0, -1, 0], [0, 0, 1], [0, 0, -1]],
                 dtype=np.float64)
    f = np.array([[0, 2, 4], [2, 1, 4], [1, 3, 4], [3, 0, 4],
                  [2, 0, 5], [1, 2, 5], [3, 1, 5], [0, 3, 5]])
    for _ in range(levels):
        nv, nf, cache = list(v), [], {}

        def mid(a, b):
            key = (min(a, b), max(a, b))
            if key not in cache:
                m = v[a] + v[b]
                cache[key] = len(nv)
                nv.append(m / np.linalg.norm(m))
            return cache[key]
        for a, b, c in f:
            ab, bc, ca = mid(a, b), mid(b, c), mid(c, a)
            nf += [[a, ab, ca], [ab, b, bc], [ca, bc, c], [ab, bc, ca]]
        v, f = np.asarray(nv), np.asarray(nf)
    return v, f


def both(v, f, **kw):
    return jtm.build_trimesh(v, f, **kw), tm.build_trimesh(v, f, **kw)


def assert_same_bucketing(jmesh, mesh):
    for k in ("v0", "e1", "e2", "normal", "cell_tris"):
        np.testing.assert_array_equal(getattr(mesh, k), np.asarray(getattr(jmesh, k)), err_msg=k)
    assert (mesh.nx, mesh.ny, mesh.cell_size) == (jmesh.nx, jmesh.ny, jmesh.cell_size)
    np.testing.assert_array_equal(np.float32(mesh.origin), np.asarray(jmesh.origin))


def random_rays(rng, n, lo, hi):
    o = rng.uniform(lo, hi, (n, 3)).astype(np.float32)
    d = rng.standard_normal((n, 3))
    d[: n // 4, 2] = -np.abs(d[: n // 4, 2]) - 2.0          # some steep downward rays
    d[n // 4: n // 2, 2] = 0.0                               # some horizontal ones
    d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    return o, d


def assert_raycast_matches(jmesh, mesh, o, d, max_distance):
    jd, jh, jp, jn = jtm.raycast_trimesh(jmesh, jnp.asarray(o), jnp.asarray(d), max_distance)
    dist, hit, pts, nrm = tm.raycast_trimesh(mesh, torch.as_tensor(o), torch.as_tensor(d),
                                             max_distance)
    np.testing.assert_array_equal(hit.numpy(), np.asarray(jh))
    np.testing.assert_allclose(dist.numpy(), np.asarray(jd), atol=ATOL)
    np.testing.assert_allclose(pts.numpy(), np.asarray(jp), atol=ATOL)
    np.testing.assert_allclose(nrm.numpy(), np.asarray(jn), atol=1e-6)
    return dist.numpy(), hit.numpy(), pts.numpy(), nrm.numpy()


def assert_sdf_matches(jmesh, mesh, p):
    js, jg, jn = jtm.query_sdf_trimesh(jmesh, jnp.asarray(p))
    s, g, n = tm.query_sdf_trimesh(mesh, torch.as_tensor(p))
    np.testing.assert_allclose(s.numpy(), np.asarray(js), atol=ATOL)
    np.testing.assert_allclose(g.numpy(), np.asarray(jg), atol=1e-4)
    np.testing.assert_allclose(n.numpy(), np.asarray(jn), atol=ATOL)
    return s.numpy(), g.numpy(), n.numpy()


@pytest.fixture(scope="module")
def wall_scene():
    """Ground plane and a 2 m wall slab at x in [2.0, 2.4]."""
    return both(*merge(ground_plane(), box_mesh(2.2, 0.0, 0.0, 2.0, 0.2, 5.0)), cell_size=0.5)


def test_bucketing_is_identical(wall_scene):
    assert_same_bucketing(*wall_scene)
    # default cell size, and a mesh large enough to loop its big triangles
    assert_same_bucketing(*both(*icosphere(2)))
    assert_same_bucketing(*both(*merge(ground_plane(40.0), box_mesh(0, 0, 0, 1, 0.3, 0.3)),
                                cell_size=0.25))


def test_raycast_lateral_wall_down_and_oblique(wall_scene):
    jmesh, mesh = wall_scene
    o = np.array([[0.0, 0.0, 1.0], [0.0, 0.0, 1.0], [0.0, 0.0, 1.0], [1.0, 0.0, 0.5]], np.float32)
    d = np.array([[1.0, 0.0, 0.0], [0.0, 0.0, -1.0], [0.0, 0.0, 1.0],
                  [1 / np.sqrt(2.0), 0.0, 1 / np.sqrt(2.0)]], np.float32)
    dist, hit, pts, nrm = assert_raycast_matches(jmesh, mesh, o, d, 10.0)
    np.testing.assert_array_equal(hit, [True, True, False, True])
    np.testing.assert_allclose(dist, [2.0, 1.0, 10.0, np.sqrt(2.0)], atol=1e-3)
    np.testing.assert_allclose(nrm[0], [-1.0, 0.0, 0.0], atol=1e-5)
    np.testing.assert_allclose(pts[3], [2.0, 0.0, 1.5], atol=1e-3)


def test_raycast_random_rays_and_thin_feature(wall_scene):
    """Random rays from above and beside the wall, and a 2 cm floating slab
    that a vertical ray must hit."""
    rng = np.random.default_rng(0)
    o, d = random_rays(rng, 512, [-3.0, -3.0, 0.1], [4.0, 3.0, 2.5])
    _, hit, _, _ = assert_raycast_matches(*wall_scene, o, d, 6.0)
    assert 0.3 < hit.mean() < 1.0
    jmesh, mesh = both(*merge(ground_plane(), box_mesh(0.0, 0.0, 1.0, 1.02, 1.0, 1.0)),
                       cell_size=0.5)
    dist, hit, _, _ = assert_raycast_matches(
        jmesh, mesh, np.array([[0.0, 0.0, 3.0]], np.float32),
        np.array([[0.0, 0.0, -1.0]], np.float32), 10.0)
    assert hit[0] and abs(dist[0] - 1.98) < 1e-3


def test_sdf_wall_inside_and_ground(wall_scene):
    jmesh, mesh = wall_scene
    p = np.array([[1.7, 0.0, 1.0], [2.1, 0.0, 1.0], [0.0, 0.0, 0.25]], np.float32)
    s, g, n = assert_sdf_matches(jmesh, mesh, p)
    np.testing.assert_allclose(s, [0.3, -0.1, 0.25], atol=1e-3)
    np.testing.assert_allclose(g[0], [-1.0, 0.0, 0.0], atol=1e-3)
    np.testing.assert_allclose(g[2], [0.0, 0.0, 1.0], atol=1e-3)
    np.testing.assert_allclose(n[0], [2.0, 0.0, 1.0], atol=1e-3)
    # random points around the slab, beyond the radius and off the mesh
    rng = np.random.default_rng(1)
    p = rng.uniform([-12.0, -6.0, -0.5], [12.0, 6.0, 2.5], (2048, 3)).astype(np.float32)
    s, _, _ = assert_sdf_matches(jmesh, mesh, p)
    assert (s < 0).any() and (s == mesh.sdf_radius).any()


def test_sdf_sphere_grid():
    """A tessellated unit sphere on a 7^3 grid: against JAX, and within 0.02
    of |p| - 1 in the exact band."""
    jmesh, mesh = both(*icosphere(3), cell_size=0.4)
    pts = np.stack(np.meshgrid(*[np.linspace(-1.3, 1.3, 7)] * 3), -1).reshape(-1, 3)
    r = np.linalg.norm(pts, axis=-1)
    keep = np.abs(r - 1.0) < 0.35
    s, _, _ = assert_sdf_matches(jmesh, mesh, pts[keep].astype(np.float32))
    np.testing.assert_allclose(s, r[keep] - 1.0, atol=0.02)


def test_heightfield_trimesh_consistency():
    """A 1 m step, wall-corrected: identical meshes, down rays read the
    grid heights, a lateral ray hits the vertical face."""
    h = np.zeros((12, 12), dtype=np.float32)
    h[6:, :] = 1.0
    jmesh = jtm.trimesh_from_heightfield(h, 0.1, origin=(0.0, 0.0), slope_threshold=0.9)
    mesh = tm.trimesh_from_heightfield(h, 0.1, origin=(0.0, 0.0), slope_threshold=0.9)
    assert_same_bucketing(jmesh, mesh)
    o = np.array([[0.3, 0.5, 2.0], [0.9, 0.5, 2.0], [0.3, 0.5, 0.5]], np.float32)
    d = np.array([[0.0, 0.0, -1.0], [0.0, 0.0, -1.0], [1.0, 0.0, 0.0]], np.float32)
    dist, hit, pts, _ = assert_raycast_matches(jmesh, mesh, o, d, 5.0)
    assert hit.all()
    np.testing.assert_allclose(dist[:2], [2.0, 1.0], atol=1e-3)
    assert 0.45 <= pts[2, 0] <= 0.62


def confined_pair(props, rows=1, cols=1, length=4.0, border=0.0, seed=0):
    out = []
    for Cfg, Gen in ((JTerrainCfg, JTerrainConfined), (TerrainCfg, TerrainConfined)):
        c = Cfg()
        c.num_rows, c.num_cols = rows, cols
        c.terrain_length = c.terrain_width = length
        c.border_size = border
        c.confined_terrain_proportions = props
        out.append(Gen(c, num_envs=1, seed=seed))
    return out


def test_confined_terrain_sees_walls():
    """A barrier terrain's mesh: identical bucketing; the SDF beside an
    overhead barrier measures its lateral face; random queries and rays on
    the confined scene agree with JAX."""
    jt, t = confined_pair([0.0, 1.0, 0.0, 0.0])
    jterrain, terrain = jt.to_device(), t.to_device()
    assert terrain.trimesh is not None and terrain.has_ceiling
    assert_same_bucketing(jterrain.trimesh, terrain.trimesh)
    cs = t.ceiling[:, t.ceiling.shape[1] // 2]
    i_edge = np.where(cs < 1e5)[0][0]
    p = np.array([[i_edge * 0.1 - 0.08, (t.ceiling.shape[1] // 2) * 0.1, cs[i_edge] + 0.5]],
                 np.float32)
    assert float(sdf.query_sdf(terrain, torch.as_tensor(p)).sdf[0]) < 0.2
    rng = np.random.default_rng(2)
    p = rng.uniform([0.0, 0.0, -0.2], [4.0, 4.0, 1.5], (1024, 3)).astype(np.float32)
    res, jres = sdf.query_sdf(terrain, torch.as_tensor(p)), jsdf.query_sdf(jterrain, jnp.asarray(p))
    np.testing.assert_allclose(res.sdf.numpy(), np.asarray(jres.sdf), atol=ATOL)
    np.testing.assert_allclose(res.gradient.numpy(), np.asarray(jres.gradient), atol=1e-4)
    np.testing.assert_allclose(res.nearest.numpy(), np.asarray(jres.nearest), atol=ATOL)
    o, d = random_rays(rng, 512, [0.5, 0.5, 0.1], [3.5, 3.5, 1.2])
    r = raycast(terrain, torch.as_tensor(o), torch.as_tensor(d), 5.0)
    jr = jraycast(jterrain, jnp.asarray(o), jnp.asarray(d), 5.0)
    np.testing.assert_array_equal(r.hit.numpy(), np.asarray(jr.hit))
    np.testing.assert_allclose(r.distance.numpy(), np.asarray(jr.distance), atol=ATOL)


def ceiling_pair(seed=3):
    """An 8 x 8 grid at 0.25 m: bumpy ground and a ceiling 1 m above with
    some open-sky cells."""
    rng = np.random.default_rng(seed)
    g = (0.1 * rng.standard_normal((8, 8))).astype(np.float32)
    c = (g + 1.0 + 0.1 * rng.standard_normal((8, 8))).astype(np.float32)
    c[:2] = 1e6
    return (jhf.from_numpy(g, 0.25, origin=(-1.0, -1.0), ceiling=c),
            hf.from_numpy(g, 0.25, origin=(-1.0, -1.0), ceiling=c))


def test_raycast_and_sdf_under_a_ceiling():
    """Two-layer heightfields (no mesh): the march's free space ends at the
    ceiling; the SDF takes the nearer layer."""
    jterrain, terrain = ceiling_pair()
    assert terrain.has_ceiling and jterrain.has_ceiling
    rng = np.random.default_rng(4)
    o = np.concatenate([rng.uniform(-0.8, 0.8, (256, 2)), rng.uniform(0.3, 0.6, (256, 1))],
                       1).astype(np.float32)
    d = rng.standard_normal((256, 3))
    d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    r = raycast(terrain, torch.as_tensor(o), torch.as_tensor(d), 2.0)
    jr = jraycast(jterrain, jnp.asarray(o), jnp.asarray(d), 2.0)
    np.testing.assert_array_equal(r.hit.numpy(), np.asarray(jr.hit))
    np.testing.assert_allclose(r.distance.numpy(), np.asarray(jr.distance), atol=ATOL)
    up = r.hit.numpy() & (d[:, 2] > 0.5)
    assert up.any(), "some upward rays must hit the ceiling"
    res, jres = sdf.query_sdf(terrain, torch.as_tensor(o)), jsdf.query_sdf(jterrain, jnp.asarray(o))
    for k in ("sdf", "gradient", "nearest"):
        np.testing.assert_allclose(getattr(res, k).numpy(), np.asarray(getattr(jres, k)),
                                   atol=ATOL, err_msg=k)
    flat = hf.from_numpy(np.zeros((4, 4), np.float32), 1.0, ceiling=np.full((4, 4), 1.0))
    s = sdf.query_sdf(flat, torch.tensor([[0.5, 0.5, 0.2], [0.5, 0.5, 0.8]]))
    np.testing.assert_allclose(s.sdf.numpy(), [0.2, 0.2], atol=1e-6)
    np.testing.assert_allclose(s.gradient.numpy(), [[0, 0, 1], [0, 0, -1]], atol=1e-6)


def wall_contact_scene():
    """Ground z = 0 and a wall at x = 1 facing -x, as triangles on a flat
    heightfield, mesh contacts on."""
    verts = np.array([[-2, -2, 0], [2, -2, 0], [2, 2, 0], [-2, 2, 0],
                      [1, -2, 0], [1, 2, 0], [1, 2, 2], [1, -2, 2]], dtype=np.float32)
    tris = np.array([[0, 1, 2], [0, 2, 3], [4, 6, 5], [4, 7, 6]], dtype=np.int64)
    jmesh, mesh = both(verts, tris, cell_size=0.5)
    jterrain = jhf.flat_terrain(size=8.0, hscale=1.0).replace(trimesh=jmesh, contact_trimesh=True)
    return jterrain, hf.flat_terrain().replace(trimesh=mesh, contact_trimesh=True)


def assert_contact_matches(jterrain, terrain, pos, vel, r, anchor):
    jc = jcontact(jterrain, jcontact_params(), jnp.asarray(pos), jnp.asarray(vel), jnp.asarray(r),
                  jnp.asarray(anchor))
    c = sphere_terrain_contact(terrain, default_contact_params(), torch.as_tensor(pos),
                               torch.as_tensor(vel), torch.as_tensor(r), torch.as_tensor(anchor))
    for k in ("depth", "n", "anchor", "kt", "kd_minus_kt"):
        np.testing.assert_allclose(getattr(c, k).numpy(), np.asarray(getattr(jc, k)), atol=1e-5,
                                   rtol=1e-5, err_msg=k)
    np.testing.assert_allclose(c.f_el.numpy(), np.asarray(jc.f_el), rtol=1e-4, atol=1e-2)
    return c


def test_mesh_contact_pushes_along_the_wall_normal():
    jterrain, terrain = wall_contact_scene()
    r = np.array([0.1], np.float32)
    pos = np.array([[0.95, 0.0, 1.0]], np.float32)
    vel = np.zeros((1, 3), np.float32)
    c = assert_contact_matches(jterrain, terrain, pos, vel, r, pos[:, :2])
    f = (c.f_el - c.apply_D(torch.as_tensor(vel)))[0].numpy()
    assert f[0] < 0.0 and abs(abs(f[0]) - 3.0e4 * 0.05) < 0.05 * 3.0e4 * 0.05
    np.testing.assert_allclose(c.n[0].numpy(), [-1.0, 0.0, 0.0], atol=0.05)
    # random spheres over the ground, at the wall and far from both
    rng = np.random.default_rng(5)
    pos = rng.uniform([-1.5, -1.5, -0.05], [1.3, 1.5, 1.5], (64, 3)).astype(np.float32)
    vel = rng.standard_normal((64, 3)).astype(np.float32)
    rad = rng.uniform(0.03, 0.15, 64).astype(np.float32)
    anchor = (pos[:, :2] + 0.01 * rng.standard_normal((64, 2))).astype(np.float32)
    c = assert_contact_matches(jterrain, terrain, pos, vel, rad, anchor)
    assert (c.depth > 0).sum() >= 4


def test_ceiling_contact():
    """Spheres touching a two-layer heightfield's ground or its ceiling:
    the ceiling pushes down (n = -z) where its gap is the deeper one."""
    jterrain, terrain = ceiling_pair()
    rng = np.random.default_rng(6)
    xy = rng.uniform(-0.8, 0.8, (64, 2))
    g = np.asarray(jhf.sample_height(jterrain, jnp.asarray(xy)))
    c = np.asarray(jhf.sample_ceiling(jterrain, jnp.asarray(xy)))
    z = np.where(rng.uniform(size=64) < 0.5, g + 0.05, np.minimum(c, 5.0) - 0.05)
    pos = np.concatenate([xy, z[:, None]], 1).astype(np.float32)
    vel = rng.standard_normal((64, 3)).astype(np.float32)
    rad = np.full(64, 0.08, np.float32)
    res = assert_contact_matches(jterrain, terrain, pos, vel, rad, pos[:, :2])
    down = res.n[:, 2].numpy() == -1.0
    assert down.sum() >= 4 and (res.depth[down] > 0).all()


def test_zero_gap_barriers_tie_between_coincident_faces():
    """The barrier generator's hardest row has a gap of 0.5 (1 - 1.0) = 0:
    its ground and ceiling faces coincide at the barrier's top and sides,
    facing opposite ways.  A ray meeting them, or a point nearest them, has two
    right answers at one distance, and float32 rounding picks one: JAX and
    the port (and float32 and float64) may disagree there, and only there.
    Distances, hits, hit points, SDF magnitudes and nearest points agree to
    1e-5; every normal or SDF sign that differs is exactly negated (such
    ties stay rare: under 1% of these 2048 rays and points)."""
    jt, t = confined_pair([0.0, 1.0, 1.0, 1.0], rows=2, cols=1, length=6.0, border=1.0)
    assert ((t.ceiling - t.ground) == 0).any()
    jd, d = jt.to_device(), t.to_device()
    rng = np.random.default_rng(0)
    o, dd = random_rays(rng, 2048, [0.0, 0.0, 0.4], [13.0, 8.0, 1.0])
    jr = jtm.raycast_trimesh(jd.trimesh, jnp.asarray(o), jnp.asarray(dd), 10.0)
    r = tm.raycast_trimesh(d.trimesh, torch.as_tensor(o), torch.as_tensor(dd), 10.0)
    np.testing.assert_array_equal(r[1].numpy(), np.asarray(jr[1]))
    np.testing.assert_allclose(r[0].numpy(), np.asarray(jr[0]), atol=ATOL)
    np.testing.assert_allclose(r[2].numpy(), np.asarray(jr[2]), atol=ATOL)
    n, jn = r[3].numpy(), np.asarray(jr[3])
    flip = np.abs(n - jn).max(-1) > 1e-6
    np.testing.assert_allclose(n[flip], -jn[flip], atol=1e-6)
    assert flip.mean() < 0.01
    p = rng.uniform([0, 0, 0.25], [13, 8, 0.6], (2048, 3)).astype(np.float32)
    js, jg, jnear = jtm.query_sdf_trimesh(jd.trimesh, jnp.asarray(p))
    s, g, near = tm.query_sdf_trimesh(d.trimesh, torch.as_tensor(p))
    np.testing.assert_allclose(np.abs(s.numpy()), np.abs(np.asarray(js)), atol=ATOL)
    np.testing.assert_allclose(near.numpy(), np.asarray(jnear), atol=ATOL)
    sflip = np.sign(s.numpy()) != np.sign(np.asarray(js))
    np.testing.assert_allclose(g.numpy()[sflip], -np.asarray(jg)[sflip], atol=1e-5)
    assert sflip.mean() < 0.01


def test_sdf_gradient_is_a_unit_vector_at_edges():
    """Points 3e-6 to 3e-4 m from a timber-pile arena's mesh, half of them
    at triangle vertices and edges.  The triangle that sets the sign may lie
    up to 1e-4 farther than the nearest one; the JAX package divides its
    vector by the nearest distance, so its gradient is longer than 1 there
    (up to ~20 here).  The port divides by the vector's own length: its
    gradient is a unit vector everywhere and points the way JAX's does (to
    1e-6), the SDF values and nearest points are JAX's.  A sphere there gets
    a unit contact normal and a positive semidefinite damper
    kt I + (kd - kt) n nᵀ, which a longer normal makes indefinite."""
    jt, t = confined_pair([0.0, 0.0, 1.0], rows=2, cols=1, length=6.0, border=1.0)
    jd, d = jt.to_device(), t.to_device()
    mesh, n = d.trimesh, 4096
    rng = np.random.default_rng(0)
    tri = rng.integers(0, mesh.num_triangles, n)
    a, b = rng.random(n), rng.random(n)
    a[: n // 2] = 0.0
    b[: n // 4] = 0.0
    flip = a + b > 1
    a[flip], b[flip] = 1 - a[flip], 1 - b[flip]
    surf = mesh.v0[tri] + a[:, None] * mesh.e1[tri] + b[:, None] * mesh.e2[tri]
    off = rng.standard_normal((n, 3))
    off *= 10 ** rng.uniform(-5.5, -3.5, n)[:, None] / np.linalg.norm(off, axis=1, keepdims=True)
    p = (surf + off).astype(np.float32)
    js, jg, jnear = (np.asarray(x) for x in jtm.query_sdf_trimesh(jd.trimesh, jnp.asarray(p)))
    s, g, near = tm.query_sdf_trimesh(mesh, torch.as_tensor(p))
    np.testing.assert_allclose(s.numpy(), js, atol=ATOL)
    np.testing.assert_allclose(near.numpy(), jnear, atol=ATOL)
    jlen = np.linalg.norm(jg, axis=-1)
    assert (jlen > 1.001).sum() >= 10, "no point where the JAX gradient is longer than 1"
    np.testing.assert_allclose(g.norm(dim=-1).numpy(), 1.0, atol=1e-6)
    np.testing.assert_allclose(g.numpy(), jg / jlen[:, None], atol=1e-6)

    rad = (np.abs(s.numpy()) + 0.01).astype(np.float32)
    vel = rng.standard_normal((n, 3)).astype(np.float32)
    c = sphere_terrain_contact(d.replace(contact_trimesh=True), default_contact_params(),
                               torch.as_tensor(p),
                               torch.as_tensor(vel), torch.as_tensor(rad))
    assert (c.depth > 0).all()
    np.testing.assert_allclose(c.n.norm(dim=-1).numpy(), 1.0, atol=1e-6)
    D = (c.kt[:, None, None] * torch.eye(3)
         + c.kd_minus_kt[:, None, None] * c.n[:, :, None] * c.n[:, None, :])
    assert float(torch.linalg.eigvalsh(D.double()).min()) > -1e-6 * float(c.kt.max())
