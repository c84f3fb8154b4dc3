"""The CUDA kernels' cooperative per-env body (csrc/physics_step.cu,
``env_control_step``, B1 flat and B2 on a heightfield) compiled for the host
with a C++ compiler and held to the plain version (physics/aba.py via
DecimatedEnvStep.plain).

The kernel itself runs only on a card (tests/test_torch_kernel_cuda.py and
chip_smoke.py cover that); this test keeps the arithmetic of the exact kernel
source under the CPU gate.  Without __CUDACC__ the source's FOR_LANES runs
the 32 lanes of each phase one after another and SYNC() is empty, so the
host build runs the warp-cooperative body itself over a host array that
stands for the env's shared-memory workspace (filled with NaN first, so a
read of a word no phase wrote shows).  Running the lanes in reverse order
must give the same bits: no lane may read what another writes in the same
phase.  The harness feeds the body the wrapper's own tables and SoA layout.
Each check runs with ANYmal-C's tables (13 bodies, 12 joints, 36 spheres, 4
feet) and B1's with the ElSpider Air hexapod's (19 bodies, 18 joints, 6
children at the base, 46 spheres in two 32-lane passes, 6 feet); the
fixed-base regime (the int table's TI_FIX) with the Franka arm's (8 bodies in
a chain, 7 joints, one sphere on the base, no feet) on flat ground and a
slope, and with ANYmal-C's tables under a fixed base on the slope (legs in
contact).  One case, marked slow as tests/test_physics_kernel.py is, holds
the fixed-base regime to the JAX package's Pallas body run in interpret
mode."""
import ctypes
import shutil
import subprocess

import numpy as np
import pytest
import torch

from extended_legged_gym_tpu_torch.ops import physics_kernel as pk
from extended_legged_gym_tpu_torch.physics import EnvPhysParams, initial_state, load_model
from extended_legged_gym_tpu_torch.physics.engine import default_sim_params
from extended_legged_gym_tpu_torch.envs.legged_robot_config import TerrainCfg
from extended_legged_gym_tpu_torch.scripts.bench_kernel import (STAND_HEIGHT, at_rest,
                                                                elspider_step, franka_step,
                                                                near_standing, rough_env)
from extended_legged_gym_tpu_torch.terrain import Terrain, flat_terrain, from_numpy, sample_height

MODEL = "extended_legged_gym_tpu/robots/data/anymal_c.json"
HARNESS = r"""
#include "%s"
#include <limits>
#include <vector>
template <bool ROUGH>
int host_loop(const float* state_in, const float* act, const float* fric, const float* delta,
              const float* tf, const int* ti, const float* tex, float* state_out, float* tau_out,
              float* gf_out, float* fpos_out, float* fvel_out, int B) {
  const int nj = ti[TI_NJ], ng = ti[TI_NG], nf = ti[TI_NF];
  const WsLayout L = ws_layout(ti[TI_NB], nj, ng, nf, ROUGH);
  const int NS = 13 + 2 * nj + 2 * ng;
  std::vector<float> ws(L.words);
  for (int e = 0; e < B; ++e) {
    std::fill(ws.begin(), ws.end(), std::numeric_limits<float>::quiet_NaN());
    for (int r = 0; r < NS; ++r) ws[L.S + r] = state_in[r * B + e];
    for (int j = 0; j < nj; ++j) ws[L.ACT + j] = act[j * B + e] * tf[TF_ASCALE];
    ws[L.FRIC] = fric[e];
    ws[L.DELTA] = delta[e];
    env_control_step<ROUGH>(tf, ti, reinterpret_cast<const float4*>(tex), ws.data());
    for (int r = 0; r < NS; ++r) state_out[r * B + e] = ws[L.S + r];
    for (int j = 0; j < nj; ++j) tau_out[j * B + e] = ws[L.TAU + j];
    for (int r = 0; r < 3 * ng; ++r) gf_out[r * B + e] = ws[L.GF + r];
    for (int r = 0; r < 3 * nf; ++r) {
      fpos_out[r * B + e] = ws[L.FP + r];
      fvel_out[r * B + e] = ws[L.FV + r];
    }
  }
  return 0;
}
extern "C" int host_step(const float* state_in, const float* act, const float* fric,
                         const float* delta, const float* tf, const int* ti, const float* tex,
                         float* state_out, float* tau_out, float* gf_out, float* fpos_out,
                         float* fvel_out, int B, int rough, int lanes_reversed) {
  phys_lanes_reversed = lanes_reversed;
  return rough ? host_loop<true>(state_in, act, fric, delta, tf, ti, tex, state_out, tau_out,
                                 gf_out, fpos_out, fvel_out, B)
               : host_loop<false>(state_in, act, fric, delta, tf, ti, tex, state_out, tau_out,
                                  gf_out, fpos_out, fvel_out, B);
}
"""
TOLS = dict(base_pos=1e-4, base_quat=1e-4, joint_pos=5e-4, base_lin_vel=2e-2,
            base_ang_vel=2e-2, joint_vel=5e-2, contact_anchor=1e-4)


@pytest.fixture(scope="module")
def host_lib(tmp_path_factory):
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        pytest.skip("no host C++ compiler")
    d = tmp_path_factory.mktemp("kernel_host")
    src = d / "harness.cpp"
    src.write_text(HARNESS % pk.SOURCE)
    lib = d / "libkernel_host.so"
    subprocess.run([cxx, "-O2", "-std=c++17", "-shared", "-fPIC", "-o", str(lib), str(src)],
                   check=True, capture_output=True, timeout=300)
    h = ctypes.CDLL(str(lib))
    h.host_step.argtypes = [ctypes.c_void_p] * 12 + [ctypes.c_int] * 3
    h.host_step.restype = ctypes.c_int
    h.physics_workspace_bytes.argtypes = [ctypes.c_int] * 5
    h.physics_workspace_bytes.restype = ctypes.c_int
    return h


def _run_host(h, step, st, act, ep, lanes_reversed=False):
    """The wrapper's SoA packing around the host-compiled kernel body."""
    B, nj, ng, nf = st.base_pos.shape[0], step.model.nj, step.model.ng, step.nf
    state = torch.cat([st.base_pos.T, st.base_quat.T, st.joint_pos.T, st.base_lin_vel.T,
                       st.base_ang_vel.T, st.joint_vel.T, st.contact_anchor.reshape(B, -1).T]).contiguous()
    a = act.T.contiguous()
    out, tau = torch.empty_like(state), torch.empty(nj, B)
    gf, fp, fv = torch.empty(3 * ng, B), torch.empty(3 * nf, B), torch.empty(3 * nf, B)
    tf, ti = torch.as_tensor(step.tf_host), torch.as_tensor(step.ti_host)
    tex = (torch.as_tensor(step.terrain.corner_tex) if step.rough else torch.zeros(4))
    h.host_step(state.data_ptr(), a.data_ptr(), ep.friction_scale.data_ptr(),
                ep.base_mass_delta.data_ptr(), tf.data_ptr(), ti.data_ptr(), tex.data_ptr(),
                out.data_ptr(), tau.data_ptr(), gf.data_ptr(), fp.data_ptr(), fv.data_ptr(), B,
                int(step.rough), int(lanes_reversed))
    o = out.T
    new = st.replace(base_pos=o[:, :3], base_quat=o[:, 3:7], joint_pos=o[:, 7:7 + nj],
                     base_lin_vel=o[:, 7 + nj:10 + nj], base_ang_vel=o[:, 10 + nj:13 + nj],
                     joint_vel=o[:, 13 + nj:13 + 2 * nj],
                     contact_anchor=o[:, 13 + 2 * nj:].reshape(B, ng, 2))
    return new, tau.T, gf.T.reshape(B, ng, 3), fp.T.reshape(B, nf, 3), fv.T.reshape(B, nf, 3)


@pytest.mark.parametrize("control_type", ["P", "T"])
def test_kernel_body_matches_plain(host_lib, control_type):
    model = load_model(MODEL)
    step = pk.make_decimated_env_step(model, default_sim_params(), flat_terrain(), 4,
                                      np.full(12, 80.0, np.float32), np.full(12, 2.0, np.float32),
                                      model.default_dof_pos, 0.5, control_type=control_type)
    B = 64
    rng = np.random.default_rng(0)
    t = lambda a: torch.as_tensor(a.astype(np.float32))
    st = initial_state(model, B, pos=(0.0, 0.0, 0.54), device="cpu")
    st = st.replace(base_pos=st.base_pos + t(0.05 * rng.standard_normal((B, 3))),
                    joint_pos=st.joint_pos + t(0.1 * rng.standard_normal((B, 12))),
                    joint_vel=t(0.5 * rng.standard_normal((B, 12))),
                    base_lin_vel=t(0.3 * rng.standard_normal((B, 3))),
                    base_ang_vel=t(0.3 * rng.standard_normal((B, 3))))
    ep = EnvPhysParams(t(rng.uniform(0.5, 1.25, B)), t(rng.uniform(-1.0, 1.0, B)))
    act = t(rng.standard_normal((B, 12)) * (1.0 if control_type == "P" else 10.0))
    new, tau, gf, fp, fv = _run_host(host_lib, step, st, act, ep)
    ref, tau_r, rep = step.plain(st, act, ep)
    for name, atol in TOLS.items():
        np.testing.assert_allclose(getattr(new, name).numpy(), getattr(ref, name).numpy(),
                                   atol=atol, err_msg=name)
    np.testing.assert_allclose(tau.numpy(), tau_r.numpy(), atol=1e-2)
    np.testing.assert_allclose(fp.numpy(), rep.foot_pos.numpy(), atol=1e-4)
    np.testing.assert_allclose(fv.numpy(), rep.foot_vel.numpy(), atol=1e-2)
    np.testing.assert_allclose(gf.numpy(), rep.geom_forces.numpy(), atol=0.5)


def _assert_body_matches_plain(host_lib, step, st, act, ep):
    new, tau, gf, fp, fv = _run_host(host_lib, step, st, act, ep)
    ref, tau_r, rep = step.plain(st, act, ep)
    for name, atol in TOLS.items():
        np.testing.assert_allclose(getattr(new, name).numpy(), getattr(ref, name).numpy(),
                                   atol=atol, err_msg=name)
    np.testing.assert_allclose(tau.numpy(), tau_r.numpy(), atol=1e-2)
    np.testing.assert_allclose(fp.numpy(), rep.foot_pos.numpy(), atol=1e-4)
    np.testing.assert_allclose(fv.numpy(), rep.foot_vel.numpy(), atol=1e-2)
    np.testing.assert_allclose(gf.numpy(), rep.geom_forces.numpy(), atol=0.5)
    return rep


@pytest.mark.parametrize("control_type", ["P", "T"])
def test_elspider_kernel_body_matches_plain(host_lib, control_type):
    """B1's per-env body with the hexapod's tables (the elspider_air_flat
    env's fused step; its 18 joints, 19-body tree with six legs on the base
    and 46 geoms) against the plain version from near-standing states."""
    step = elspider_step("cpu")
    if control_type == "T":
        step = pk.make_decimated_env_step(step.model, step.sp, step.terrain, 4,
                                          step._host["p"], step._host["d"], step._host["ddp"],
                                          0.5, control_type="T")
    B = 64
    st, ep, act = near_standing(step.model, B, 0, "cpu", height=STAND_HEIGHT["elspider_air"])
    if control_type == "T":
        act = 10.0 * act
    rep = _assert_body_matches_plain(host_lib, step, st, act, ep)
    assert float(rep.geom_forces[..., 2].sum()) > 50.0 * B      # the robots stand on the ground


def test_elspider_kernel_body_is_lane_order_free(host_lib):
    """As test_kernel_body_is_lane_order_free, with the hexapod's tables."""
    step = elspider_step("cpu")
    st, ep, act = near_standing(step.model, 16, 3, "cpu", height=STAND_HEIGHT["elspider_air"])
    fwd = _run_host(host_lib, step, st, act, ep)
    rev = _run_host(host_lib, step, st, act, ep, lanes_reversed=True)
    for a, b in zip(fwd[1:], rev[1:]):
        assert torch.equal(a, b)
    for name in TOLS:
        assert torch.equal(getattr(fwd[0], name), getattr(rev[0], name)), name


def test_elspider_workspace_size_matches_source(host_lib):
    """The hexapod's workspace: the wrapper's formula is the CUDA source's
    layout, and a block of 4 envs fits (69628 bytes: 3 blocks per SM)."""
    nb, nj, ng, nf = 19, 18, 46, 6
    for rough in (0, 1):
        assert 4 * pk.workspace_words(nb, nj, ng, nf, bool(rough)) == \
            host_lib.physics_workspace_bytes(nb, nj, ng, nf, rough)
    assert pk.block_shared_bytes(nb, nj, ng, nf) == 69628
    assert elspider_step("cpu").ws_bytes == 4 * pk.workspace_words(nb, nj, ng, nf)


def _slope():
    """Planar slope h = 0.15 x - 0.08 y (tests/test_physics_kernel.py:150-158)."""
    xs = np.arange(48) * 0.25 - 6.0
    return from_numpy((0.15 * xs[:, None] - 0.08 * xs[None, :]).astype(np.float32), 0.25,
                      origin=(-6.0, -6.0))


def _grid():
    """A generated 2 x 3 grid: slopes, rough slope, stairs, discrete."""
    c = TerrainCfg()
    c.num_rows, c.num_cols, c.terrain_length, c.terrain_width, c.border_size = 2, 3, 4.0, 4.0, 1.0
    return Terrain(c, 4, seed=1).to_device()


def _over(terrain, B, seed):
    """Spawn points [B, 3] over the terrain interior, at its height."""
    lo = np.array(terrain.origin) + 1.0
    hi = np.array(terrain.origin) + np.array(terrain.shape) * terrain.hscale - 1.0
    xy = torch.as_tensor(np.random.default_rng(seed).uniform(lo, hi, (B, 2)).astype(np.float32))
    return torch.cat([xy, sample_height(terrain, xy)[:, None]], dim=-1)


@pytest.mark.parametrize("terrain", ["slope", "grid", "rough_cfg_spawn"])
def test_rough_kernel_body_matches_plain(host_lib, terrain):
    """B2's per-env body against the plain version on a slope, on a
    generated grid and on the rough config's 900 x 900 grid at its spawn
    origins, near-standing states with random actions."""
    model = load_model(MODEL)
    B = 64
    if terrain == "rough_cfg_spawn":
        env = rough_env(B, "cpu")
        step, origins = env.decimated_step, env.reset_all(seed=0).env_origins
    else:
        td = _slope() if terrain == "slope" else _grid()
        step = pk.make_decimated_env_step(model, default_sim_params(), td, 4,
                                          np.full(12, 80.0, np.float32),
                                          np.full(12, 2.0, np.float32), model.default_dof_pos, 0.5)
        origins = _over(td, B, seed=1)
    assert step.rough
    st, ep, act = near_standing(model, B, 0, "cpu", origins)
    new, tau, gf, fp, fv = _run_host(host_lib, step, st, act, ep)
    ref, tau_r, rep = step.plain(st, act, ep)
    assert float(rep.geom_forces[..., 2].sum()) > 100.0 * B      # the robots stand on the terrain
    for name, atol in TOLS.items():
        np.testing.assert_allclose(getattr(new, name).numpy(), getattr(ref, name).numpy(),
                                   atol=atol, err_msg=name)
    np.testing.assert_allclose(tau.numpy(), tau_r.numpy(), atol=1e-2)
    np.testing.assert_allclose(fp.numpy(), rep.foot_pos.numpy(), atol=1e-4)
    np.testing.assert_allclose(fv.numpy(), rep.foot_vel.numpy(), atol=1e-2)
    np.testing.assert_allclose(gf.numpy(), rep.geom_forces.numpy(), atol=0.5)


@pytest.mark.parametrize("rough", [False, True])
def test_kernel_body_is_lane_order_free(host_lib, rough):
    """The lanes of every phase run last to first give the same bits as first
    to last: within a phase no lane reads what another lane writes, so the
    warp's lanes may run in any order (the kernel's summation orders are
    fixed, no atomics)."""
    model = load_model(MODEL)
    B = 16
    if rough:
        env = rough_env(B, "cpu")
        step, origins = env.decimated_step, env.reset_all(seed=0).env_origins
    else:
        step = pk.make_decimated_env_step(model, default_sim_params(), flat_terrain(), 4,
                                          np.full(12, 80.0, np.float32),
                                          np.full(12, 2.0, np.float32), model.default_dof_pos, 0.5)
        origins = None
    st, ep, act = near_standing(model, B, 3, "cpu", origins)
    fwd = _run_host(host_lib, step, st, act, ep)
    rev = _run_host(host_lib, step, st, act, ep, lanes_reversed=True)
    for a, b in zip(fwd[1:], rev[1:]):
        assert torch.equal(a, b)
    for name in TOLS:
        assert torch.equal(getattr(fwd[0], name), getattr(rev[0], name)), name
    assert bool(torch.isfinite(fwd[2]).all()) and float(fwd[2][..., 2].sum()) > 100.0 * B


def test_workspace_size_matches_formula(host_lib):
    """The wrapper's shared-memory size for ANYmal-C is its formula and the
    CUDA source's layout; a model whose block would not fit is refused with
    its sizes."""
    model = load_model(MODEL)
    nb, nj, ng, nf = 13, 12, 36, 4
    up4 = lambda n: (n + 3) // 4 * 4
    flat_words = up4(up4(up4(92 * nb + (13 + 2 * nj + 2 * ng) + 3 * nj + 2) + 36)
                     + 28 * max(ng, nb) + 9 * ng)
    assert flat_words == 2712 and pk.workspace_words(nb, nj, ng, nf) == flat_words
    assert pk.workspace_words(nb, nj, ng, nf, rough=True) == flat_words + 4 * ng
    step = pk.make_decimated_env_step(model, default_sim_params(), flat_terrain(), 4,
                                      np.full(12, 80.0, np.float32), np.full(12, 2.0, np.float32),
                                      model.default_dof_pos, 0.5)
    assert step.ws_bytes == 4 * flat_words == host_lib.physics_workspace_bytes(nb, nj, ng, nf, 0)
    tables = 4 * (pk.TF_SIZE + pk.TI_FULL)
    assert pk.block_shared_bytes(nb, nj, ng, nf, True) == pk.ENVS_PER_BLOCK * 4 * (flat_words + 144) + tables
    for sizes in ((20, 19, 60, 4), (32, 31, 64, 8), (5, 4, 3, 1)):
        for rough in (0, 1):
            assert 4 * pk.workspace_words(*sizes, bool(rough)) == host_lib.physics_workspace_bytes(
                *sizes, rough)
    with pytest.raises(ValueError, match=r"nb=40 nj=39 ng=400 nf=4: a block of 4 envs needs \d+ bytes"):
        pk.block_shared_bytes(40, 39, 400, 4, rough=True)


@pytest.mark.parametrize("control_type", ["P", "T"])
def test_fixed_base_kernel_body_matches_plain(host_lib, control_type):
    """The fixed-base regime with the arm's tables: zero base acceleration, no
    base solve, no feet, the one geom on the base; joints as the plain
    fixed-base step, the base pose unchanged bit for bit."""
    step = franka_step("cpu", control_type)
    assert step.model.fix_base and step.nf == 0 and int(step.ti_host[pk.TI_FIX]) == 1
    st, ep, act = at_rest(step.model, 64, 0, "cpu")
    if control_type == "T":
        act = 20.0 * act
    new, tau, gf, fp, fv = _run_host(host_lib, step, st, act, ep)
    ref, tau_r, rep = step.plain(st, act, ep)
    for name, atol in TOLS.items():
        np.testing.assert_allclose(getattr(new, name).numpy(), getattr(ref, name).numpy(),
                                   atol=atol, err_msg=name)
    np.testing.assert_allclose(tau.numpy(), tau_r.numpy(), atol=1e-2)
    np.testing.assert_allclose(gf.numpy(), rep.geom_forces.numpy(), atol=0.5)
    assert fp.shape == fv.shape == rep.foot_pos.shape == (64, 0, 3)
    for name in ("base_pos", "base_quat", "base_lin_vel", "base_ang_vel"):
        assert torch.equal(getattr(new, name), getattr(st, name)), name
        assert torch.equal(getattr(ref, name), getattr(st, name)), name
    assert float(new.joint_vel.abs().max()) > 0.5           # the arm moves


@pytest.mark.parametrize("robot", ["franka", "anymal_c"])
def test_fixed_base_rough_kernel_body_matches_plain(host_lib, robot):
    """The fixed-base regime of B2 on the slope: the arm at rest on the slope
    (its base sphere in contact), and ANYmal-C held with its base fixed just
    above the slope, legs in contact."""
    td = _slope()
    if robot == "franka":
        step = franka_step("cpu", terrain=td)
        origins = _over(td, 64, seed=2)
    else:
        model = load_model(MODEL)
        model = model.__class__(**{**{f: getattr(model, f) for f in model.__dataclass_fields__
                                      if f != "_tensors"}, "fix_base": True})
        step = pk.make_decimated_env_step(model, default_sim_params(), td, 4,
                                          np.full(12, 80.0, np.float32),
                                          np.full(12, 2.0, np.float32), model.default_dof_pos, 0.5)
        origins = _over(td, 64, seed=2) + torch.tensor([0.0, 0.0, 0.5])
    assert step.rough and int(step.ti_host[pk.TI_FIX]) == 1
    st, ep, act = at_rest(step.model, 64, 1, "cpu", origins)
    new, tau, gf, fp, fv = _run_host(host_lib, step, st, act, ep)
    ref, tau_r, rep = step.plain(st, act, ep)
    assert float(rep.geom_forces[..., 2].sum()) > 10.0 * 64      # in contact with the slope
    for name, atol in TOLS.items():
        np.testing.assert_allclose(getattr(new, name).numpy(), getattr(ref, name).numpy(),
                                   atol=atol, err_msg=name)
    np.testing.assert_allclose(tau.numpy(), tau_r.numpy(), atol=1e-2)
    np.testing.assert_allclose(gf.numpy(), rep.geom_forces.numpy(), atol=0.5)
    np.testing.assert_allclose(fp.numpy(), rep.foot_pos.numpy(), atol=1e-4)
    assert torch.equal(new.base_pos, st.base_pos) and torch.equal(new.base_quat, st.base_quat)


def test_fixed_base_kernel_body_is_lane_order_free(host_lib):
    """As test_kernel_body_is_lane_order_free, with the arm's tables."""
    step = franka_step("cpu")
    st, ep, act = at_rest(step.model, 16, 3, "cpu")
    fwd = _run_host(host_lib, step, st, act, ep)
    rev = _run_host(host_lib, step, st, act, ep, lanes_reversed=True)
    for a, b in zip(fwd[1:], rev[1:]):
        assert torch.equal(a, b)
    for name in TOLS:
        assert torch.equal(getattr(fwd[0], name), getattr(rev[0], name)), name


def test_fixed_base_flag_switches_only_the_base(host_lib):
    """ANYmal-C's int table differs from its fixed-base twin's in TI_FIX
    alone; with the flag off the body follows the floating plain step (the
    base accelerates), with it on the fixed-base plain step (the base keeps
    its velocities bit for bit), from the same states."""
    model = load_model(MODEL)
    fixed = model.__class__(**{**{f: getattr(model, f) for f in model.__dataclass_fields__
                                  if f != "_tensors"}, "fix_base": True})
    mk = lambda m: pk.make_decimated_env_step(m, default_sim_params(), flat_terrain(), 4,
                                              np.full(12, 80.0, np.float32),
                                              np.full(12, 2.0, np.float32), m.default_dof_pos, 0.5)
    free, fix = mk(model), mk(fixed)
    diff = np.nonzero(free.ti_host != fix.ti_host)[0]
    assert diff.tolist() == [pk.TI_FIX] and int(free.ti_host[pk.TI_FIX]) == 0
    np.testing.assert_array_equal(free.tf_host, fix.tf_host)
    st, ep, act = near_standing(model, 16, 4, "cpu")
    for step in (free, fix):
        new = _run_host(host_lib, step, st, act, ep)[0]
        ref = step.plain(st, act, ep)[0]
        for name, atol in TOLS.items():
            np.testing.assert_allclose(getattr(new, name).numpy(), getattr(ref, name).numpy(),
                                       atol=atol, err_msg=name)
        kept = (torch.equal(new.base_lin_vel, st.base_lin_vel)
                 and torch.equal(new.base_ang_vel, st.base_ang_vel))
        assert kept == (step is fix)


def test_fixed_base_and_cyberdog2_workspaces_match_source(host_lib):
    """The arm's and CyberDog2's workspaces: the wrapper's formula is the
    source's layout; CyberDog2's block of 4 envs takes 54716 bytes."""
    for sizes in ((8, 7, 1, 0), (13, 12, 37, 4)):
        for rough in (0, 1):
            assert 4 * pk.workspace_words(*sizes, bool(rough)) == \
                host_lib.physics_workspace_bytes(*sizes, rough)
    assert pk.block_shared_bytes(13, 12, 37, 4) == 54716
    assert franka_step("cpu").ws_bytes == 4 * pk.workspace_words(8, 7, 1, 0)


@pytest.mark.slow
def test_fixed_base_matches_the_pallas_kernel_in_interpret_mode(host_lib):
    """The JAX package's Pallas body (build_flat_physics_kernel, interpret
    mode, its `if model.fix_base` branch) against the port's plain fixed-base
    step and the host build of the CUDA body, one substep with torques in,
    on ANYmal-C with its base fixed at 0.5 m: legs in contact, so the
    contact forces reach the joint dynamics through the bias terms, whose
    order of operations differs (the Pallas body sums them with its own
    ordering; the port follows physics/aba.py).  Tolerances are
    tests/test_physics_kernel.py's for the Pallas body against ABA
    (positions 1e-4 to 5e-4, velocities 2e-2 to 5e-2: float32 ordering
    noise through the contact solve), and its 20% + 30 N on the summed normal
    forces (the Pallas report is explicit, the port's implicit-consistent).
    Marked slow as that file is: the interpret-mode trace takes about two
    minutes on a CPU."""
    import jax
    import jax.numpy as jnp
    from extended_legged_gym_tpu.ops.physics_kernel import (LANE, TILE, build_flat_physics_kernel,
                                                            pack_rows, pack_state, unpack_state)
    from extended_legged_gym_tpu.physics import default_sim_params as jdefault_sim_params
    from extended_legged_gym_tpu.physics.engine import PhysState as JPhysState
    from extended_legged_gym_tpu.physics.serialize import load_model as jload_model

    jm = jload_model(MODEL).replace(fix_base=True)
    model = load_model(MODEL)
    model = model.__class__(**{**{f: getattr(model, f) for f in model.__dataclass_fields__
                                  if f != "_tensors"}, "fix_base": True})
    B, nj, ng = TILE, model.nj, model.ng
    rng = np.random.default_rng(7)
    f32 = lambda a: np.asarray(a, np.float32)
    tilt = 0.05 * rng.standard_normal((B, 3))
    quat = np.concatenate([0.5 * tilt, np.ones((B, 1))], axis=1)
    base = np.tile([0.0, 0.0, 0.5], (B, 1)) + 0.01 * rng.standard_normal((B, 3))
    arrs = dict(base_pos=f32(base), base_quat=f32(quat / np.linalg.norm(quat, axis=1, keepdims=True)),
                joint_pos=f32(model.default_dof_pos + 0.1 * rng.standard_normal((B, nj))),
                base_lin_vel=np.zeros((B, 3), np.float32), base_ang_vel=np.zeros((B, 3), np.float32),
                joint_vel=f32(0.5 * rng.standard_normal((B, nj))),
                contact_anchor=f32(np.repeat(base[:, None, :2], ng, axis=1)))
    tau = f32(5.0 * rng.standard_normal((B, nj)))

    kernel = jax.jit(build_flat_physics_kernel(jm, jdefault_sim_params(), 0.0, interpret=True))
    jst = JPhysState(**{k: jnp.asarray(v) for k, v in arrs.items()})
    ones, zeros = jnp.ones((1, B // LANE, LANE)), jnp.zeros((1, B // LANE, LANE))
    packed, jgf, jfp, _ = kernel(pack_state(jst, nj), pack_rows(jnp.asarray(tau)), ones, zeros)
    jnew = unpack_state(packed, nj)
    nf = jfp.shape[0] // 3
    jfp = np.asarray(jfp).reshape(3 * nf, -1).T.reshape(B, nf, 3)
    jfz = np.asarray(jgf).reshape(3 * ng, -1).T.reshape(B, ng, 3)[..., 2].sum(axis=1)

    step = pk.make_env_step(model, default_sim_params())
    assert int(step.ti_host[pk.TI_FIX]) == 1 and step.nf == nf
    idx = np.array([0, 5, 300, 1023])
    st = initial_state(model, len(idx), device="cpu").replace(
        **{k: torch.as_tensor(v[idx]) for k, v in arrs.items()})
    ep = EnvPhysParams(friction_scale=torch.ones(len(idx)), base_mass_delta=torch.zeros(len(idx)))
    act = torch.as_tensor(tau[idx])
    ref, _, rep = step.plain(st, act, ep)
    host = _run_host(host_lib, step, st, act, ep)
    assert float(rep.geom_forces[..., 2].sum(dim=1).min()) > 100.0    # every env's legs in contact
    tols = dict(base_pos=1e-4, base_quat=1e-4, joint_pos=5e-4, base_lin_vel=2e-2,
                base_ang_vel=2e-2, joint_vel=5e-2)
    for name, atol in tols.items():
        want = np.asarray(getattr(jnew, name))[idx]
        for got in (ref, host[0]):
            np.testing.assert_allclose(getattr(got, name).numpy(), want, atol=atol, err_msg=name)
    # the base stays where it was (its quaternion is renormalized: one rounding)
    for name in ("base_pos", "base_lin_vel", "base_ang_vel"):
        np.testing.assert_array_equal(np.asarray(getattr(jnew, name))[idx], arrs[name][idx])
    for got in (rep.foot_pos, host[3]):
        np.testing.assert_allclose(got.numpy(), jfp[idx], atol=1e-4)
    for got in (rep.geom_forces, host[2]):
        np.testing.assert_allclose(got[..., 2].sum(dim=1).numpy(), jfz[idx], rtol=0.2, atol=30.0)
