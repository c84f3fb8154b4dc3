"""The CUDA kernels' cooperative per-env body (csrc/physics_step.cu,
``env_control_step``, B1 flat and B2 on a heightfield) compiled for the host
with a C++ compiler and held to the plain version (physics/aba.py via
DecimatedEnvStep.plain).

The kernel itself runs only on a card (tests/test_torch_kernel_cuda.py and
chip_smoke.py cover that); this test keeps the arithmetic of the exact kernel
source under the CPU gate.  Without __CUDACC__ the harness runs each of a
warp's 32 lanes as a coroutine (ucontext) with its own registers and stack;
the source's SYNC() returns to the harness, which resumes the lanes of each
phase one after another, so the host build runs the warp-cooperative body
itself, a warp per env (32 lanes) or two envs per warp (16 lanes each), over
host arrays that stand for the warp's shared-memory workspaces (filled with
NaN first, so a read of a word no phase wrote shows).  Running the lanes in
another order (reversed, the two groups swapped, interleaved) must give the
same bits: no lane may read what another writes in the same phase.  The
harness feeds the body the wrapper's own tables and SoA layout.
Each check runs with ANYmal-C's tables (13 bodies, 12 joints, 36 spheres, 4
feet) and B1's with the ElSpider Air hexapod's (19 bodies, 18 joints, 6
children at the base, 46 spheres in two 32-lane passes, 6 feet); the
fixed-base regime (the int table's TI_FIX) with the Franka arm's (8 bodies in
a chain, 7 joints, one sphere on the base, no feet) on flat ground and a
slope, and with ANYmal-C's tables under a fixed base on the slope (legs in
contact).  The plain LeggedRobot family's new tables: B2 with the hexapod's
and Go2's on their own rough tasks' grids from the spawn origins, B1 with
A1's, and the fixed-base regime with the hanging hexapod's (the
``foot_track_elspider_air_hang`` task's tables) with its base held low
enough that all six legs bear load.  One case, marked slow as
tests/test_physics_kernel.py is, holds the fixed-base regime to the JAX
package's Pallas body run in interpret mode."""
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
                                                                franka_step, near_standing,
                                                                rough_env, task_env,
                                                                task_states, task_step)
from extended_legged_gym_tpu_torch.terrain import Terrain, flat_terrain, from_numpy, sample_height

MODEL = "extended_legged_gym_tpu/robots/data/anymal_c.json"
HARNESS = r"""
#include <ucontext.h>
#include "%s"
#include <algorithm>
#include <limits>
#include <vector>
// A warp of the card: each lane a coroutine on its own stack.  A phase resumes
// the lanes in `order` one at a time; each runs to its next SYNC() (which
// returns here) or to the end of its env's step.
int phys_host_lane = 0;
static ucontext_t g_sched, g_lane[WARP];
static bool g_done[WARP];
static std::vector<char> g_stacks(WARP * (64 << 10));
static struct { const float *tf, *tex; const int* ti; float* ws; int words; } g_warp;
void phys_host_sync() { swapcontext(&g_lane[phys_host_lane], &g_sched); }
template <bool ROUGH, int G>
static void lane_main() {
  const int lane = phys_host_lane;
  env_control_step<ROUGH, G>(g_warp.tf, g_warp.ti, reinterpret_cast<const float4*>(g_warp.tex),
                             g_warp.ws + lane / G * g_warp.words, 0u);
  g_done[lane] = true;
}
// The lanes of `nenv` envs (G lanes each) through every phase; -1 if lanes
// disagree on the number of phases.
template <bool ROUGH, int G>
static int run_warp(int nenv, const int* order) {
  const int n = nenv * G;
  for (int t = 0; t < n; ++t) {
    getcontext(&g_lane[t]);
    g_lane[t].uc_stack.ss_sp = g_stacks.data() + (size_t)t * (64 << 10);
    g_lane[t].uc_stack.ss_size = 64 << 10;
    g_lane[t].uc_link = &g_sched;
    makecontext(&g_lane[t], (void (*)())lane_main<ROUGH, G>, 0);
    g_done[t] = false;
  }
  for (;;) {
    int finished = 0;
    for (int k = 0; k < WARP; ++k) {
      const int t = order[k];
      if (t >= n) continue;
      phys_host_lane = t;
      swapcontext(&g_sched, &g_lane[t]);
      finished += g_done[t];
    }
    if (finished) return finished == n ? 0 : -1;
  }
}
template <bool ROUGH, int G>
int host_loop(const float* state_in, const float* act, const float* fric, const float* delta,
              const float* tf, const int* ti, const float* tex, float* state_out, float* tau_out,
              float* gf_out, float* fpos_out, float* fvel_out, int B, const int* order) {
  const int nj = ti[TI_NJ], ng = ti[TI_NG], nf = ti[TI_NF];
  const WsLayout L = ws_layout(ti[TI_NB], nj, ng, nf, ROUGH);
  const int NS = 13 + 2 * nj + 2 * ng, per = WARP / G;
  std::vector<float> ws(per * L.words);        // the warp's envs side by side, as in a block
  g_warp.tf = tf; g_warp.ti = ti; g_warp.tex = tex; g_warp.ws = ws.data(); g_warp.words = L.words;
  for (int e0 = 0; e0 < B; e0 += per) {
    const int n = std::min(per, B - e0);
    std::fill(ws.begin(), ws.end(), std::numeric_limits<float>::quiet_NaN());
    for (int k = 0; k < n; ++k) {
      float* w = ws.data() + k * L.words;
      const int e = e0 + k;
      for (int r = 0; r < NS; ++r) w[L.S + r] = state_in[r * B + e];
      for (int j = 0; j < nj; ++j) w[L.ACT + j] = act[j * B + e] * tf[TF_ASCALE];
      w[L.FRIC] = fric[e];
      w[L.DELTA] = delta[e];
    }
    if (run_warp<ROUGH, G>(n, order)) return -1;
    for (int k = 0; k < n; ++k) {
      const float* w = ws.data() + k * L.words;
      const int e = e0 + k;
      for (int r = 0; r < NS; ++r) state_out[r * B + e] = w[L.S + r];
      for (int j = 0; j < nj; ++j) tau_out[j * B + e] = w[L.TAU + j];
      for (int r = 0; r < 3 * ng; ++r) gf_out[r * B + e] = w[L.GF + r];
      for (int r = 0; r < 3 * nf; ++r) {
        fpos_out[r * B + e] = w[L.FP + r];
        fvel_out[r * B + e] = w[L.FV + r];
      }
    }
  }
  return 0;
}
extern "C" int host_step(const float* state_in, const float* act, const float* fric,
                         const float* delta, const float* tf, const int* ti, const float* tex,
                         float* state_out, float* tau_out, float* gf_out, float* fpos_out,
                         float* fvel_out, int B, int rough, int group, const int* order) {
#define HOST_LOOP(R, G) host_loop<R, G>(state_in, act, fric, delta, tf, ti, tex, state_out, \
                                        tau_out, gf_out, fpos_out, fvel_out, B, order)
  if (group == 16) return rough ? HOST_LOOP(true, 16) : HOST_LOOP(false, 16);
  return rough ? HOST_LOOP(true, WARP) : HOST_LOOP(false, WARP);
#undef HOST_LOOP
}
"""
# orders in which a phase runs the 32 lanes of a warp
ORDERS = {"forward": list(range(32)), "reversed": list(range(31, -1, -1)),
          "groups_swapped": list(range(16, 32)) + list(range(16)),
          "interleaved": [t for k in range(16) for t in (k, 16 + k)]}
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
    h.host_step.argtypes = [ctypes.c_void_p] * 12 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
    h.host_step.restype = ctypes.c_int
    h.physics_workspace_bytes.argtypes = [ctypes.c_int] * 5
    h.physics_workspace_bytes.restype = ctypes.c_int
    h.physics_block_bytes.argtypes = [ctypes.c_int] * 2
    h.physics_block_bytes.restype = ctypes.c_int
    h.physics_max_block_envs.argtypes = [ctypes.c_int]
    h.physics_max_block_envs.restype = ctypes.c_int
    return h


def _run_host(h, step, st, act, ep, lanes_reversed=False, group=32, order=None):
    """The wrapper's SoA packing around the host-compiled kernel body, at
    ``group`` lanes per env (16: two envs per warp), the lanes of each phase
    run in ``order`` (a key of ``ORDERS``; ``lanes_reversed``: "reversed",
    else "forward")."""
    B, nj, ng, nf = st.base_pos.shape[0], step.model.nj, step.model.ng, step.nf
    state = torch.cat([st.base_pos.T, st.base_quat.T, st.joint_pos.T, st.base_lin_vel.T,
                       st.base_ang_vel.T, st.joint_vel.T, st.contact_anchor.reshape(B, -1).T]).contiguous()
    a = act.T.contiguous()
    out, tau = torch.empty_like(state), torch.empty(nj, B)
    gf, fp, fv = torch.empty(3 * ng, B), torch.empty(3 * nf, B), torch.empty(3 * nf, B)
    tf, ti = torch.as_tensor(step.tf_host), torch.as_tensor(step.ti_host)
    tex = (torch.as_tensor(step.terrain.corner_tex) if step.rough else torch.zeros(4))
    lanes = torch.tensor(ORDERS[order or ("reversed" if lanes_reversed else "forward")],
                         dtype=torch.int32)
    rc = h.host_step(state.data_ptr(), a.data_ptr(), ep.friction_scale.data_ptr(),
                     ep.base_mass_delta.data_ptr(), tf.data_ptr(), ti.data_ptr(), tex.data_ptr(),
                     out.data_ptr(), tau.data_ptr(), gf.data_ptr(), fp.data_ptr(), fv.data_ptr(),
                     B, int(step.rough), group, lanes.data_ptr())
    assert rc == 0, "the lanes of a warp ran different numbers of phases"
    o = out.T
    new = st.replace(base_pos=o[:, :3], base_quat=o[:, 3:7], joint_pos=o[:, 7:7 + nj],
                     base_lin_vel=o[:, 7 + nj:10 + nj], base_ang_vel=o[:, 10 + nj:13 + nj],
                     joint_vel=o[:, 13 + nj:13 + 2 * nj],
                     contact_anchor=o[:, 13 + 2 * nj:].reshape(B, ng, 2))
    return new, tau.T, gf.T.reshape(B, ng, 3), fp.T.reshape(B, nf, 3), fv.T.reshape(B, nf, 3)


@pytest.mark.parametrize("control_type,group", [("P", 32), ("T", 32), ("P", 16), ("T", 16)],
                         ids=["P", "T", "P-packed", "T-packed"])
def test_kernel_body_matches_plain(host_lib, control_type, group):
    """B1's body with ANYmal-C's tables against the plain version, a warp per
    env and two envs per warp (63 envs: the last warp's second env absent)."""
    model = load_model(MODEL)
    step = pk.make_decimated_env_step(model, default_sim_params(), flat_terrain(), 4,
                                      np.full(12, 80.0, np.float32), np.full(12, 2.0, np.float32),
                                      model.default_dof_pos, 0.5, control_type=control_type)
    B = 64 if group == 32 else 63
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
    new, tau, gf, fp, fv = _run_host(host_lib, step, st, act, ep, group=group)
    ref, tau_r, rep = step.plain(st, act, ep)
    for name, atol in TOLS.items():
        np.testing.assert_allclose(getattr(new, name).numpy(), getattr(ref, name).numpy(),
                                   atol=atol, err_msg=name)
    np.testing.assert_allclose(tau.numpy(), tau_r.numpy(), atol=1e-2)
    np.testing.assert_allclose(fp.numpy(), rep.foot_pos.numpy(), atol=1e-4)
    np.testing.assert_allclose(fv.numpy(), rep.foot_vel.numpy(), atol=1e-2)
    np.testing.assert_allclose(gf.numpy(), rep.geom_forces.numpy(), atol=0.5)


def _assert_body_matches_plain(host_lib, step, st, act, ep, plain_dtype=None, group=32):
    """The host body at ``group`` lanes per env against the plain step run in
    ``plain_dtype`` (default float32; its outputs come back as float32);
    returns the plain step's report."""
    new, tau, gf, fp, fv = _run_host(host_lib, step, st, act, ep, group=group)
    ref, tau_r, rep = step.plain(st, act, ep, dtype=plain_dtype)
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
    step = task_step("elspider_air_flat", "cpu")
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
    step = task_step("elspider_air_flat", "cpu")
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
    assert task_step("elspider_air_flat", "cpu").ws_bytes == 4 * pk.workspace_words(nb, nj, ng, nf)


@pytest.mark.parametrize("task,group", [("elspider_air_rough", 32), ("go2_rough", 32), ("a1_flat", 32),
                                        ("go2_rough", 16), ("a1_flat", 16)],
                         ids=["elspider_air_rough", "go2_rough", "a1_flat", "go2_rough-packed",
                              "a1_flat-packed"])
def test_family_kernel_body_matches_plain(host_lib, task, group):
    """B2's per-env body with the hexapod's and Go2's tables on their rough
    tasks' grids (spawn origins, levels 0..max_init_terrain_level), and
    B1's with A1's, against the plain version from near-standing states:
    the robots stand on the ground; Go2 and A1 also two envs per warp."""
    B = 64
    env = task_env(task, "cpu", B)
    step = env.decimated_step
    assert step.rough == (task != "a1_flat") and not step.model.fix_base
    st, ep, act = task_states(env, B, 0, "cpu")
    rep = _assert_body_matches_plain(host_lib, step, st, act, ep, group=group)
    assert float(rep.geom_forces[..., 2].sum()) > 20.0 * B


def _hang_loaded(B, seed):
    """The hanging hexapod's fixed-base step with its base held at 0.175 m,
    where the feet at the default pose press 9 mm into the ground."""
    env = task_env("foot_track_elspider_air_hang", "cpu", 1)
    step = env.decimated_step
    origins = torch.tensor([0.0, 0.0, 0.175]).expand(B, 3)
    return step, at_rest(step.model, B, seed, "cpu", origins)


def test_hanging_hexapod_fixed_base_body_matches_plain(host_lib):
    """The fixed-base regime with the hexapod's tables, its legs in contact:
    joints as the plain fixed-base step run in float64 (as chip_smoke.py
    holds the hexapod's launches: on stiff, loaded contacts the float32
    plain's own rounding is the larger error), the
    base unchanged bit for bit, the lanes in either order."""
    step, (st, ep, act) = _hang_loaded(64, 0)
    assert step.model.fix_base and int(step.ti_host[pk.TI_FIX]) == 1 and not step.rough
    rep = _assert_body_matches_plain(host_lib, step, st, act, ep, torch.float64)
    feet = rep.geom_forces[:, step.model.foot_geom, 2]
    assert float((feet > 1.0).float().mean()) > 0.5             # the legs bear load
    new = _run_host(host_lib, step, st, act, ep)[0]
    for name in ("base_pos", "base_quat", "base_lin_vel", "base_ang_vel"):
        assert torch.equal(getattr(new, name), getattr(st, name)), name
    fwd = _run_host(host_lib, step, st, act, ep, lanes_reversed=True)[0]
    for name in TOLS:
        assert torch.equal(getattr(fwd, name), getattr(new, name)), name


def test_family_workspaces_match_source(host_lib):
    """The shared memory of a block of 4 envs for the new tables: the
    wrapper's formula is the source's layout."""
    want = {(13, 12, 24, 4): (46524, 48060), (13, 12, 56, 4): (66492, 70076),
            (13, 12, 34, 4): (None, 54972), (13, 12, 9, 2): (None, 39612),
            (19, 18, 46, 6): (69628, 72572)}
    for sizes, (flat, rough) in want.items():
        for r in (0, 1):
            assert 4 * pk.workspace_words(*sizes, bool(r)) == \
                host_lib.physics_workspace_bytes(*sizes, r)
        if flat is not None:
            assert pk.block_shared_bytes(*sizes) == flat, sizes
        assert pk.block_shared_bytes(*sizes, rough=True) == rough, sizes
    for task, sizes in (("a1", (13, 12, 24, 4)), ("go2_rough", (13, 12, 56, 4)),
                        ("anymal_b", (13, 12, 34, 4)), ("cassie", (13, 12, 9, 2)),
                        ("elspider_air_rough", (19, 18, 46, 6))):
        m = task_env(task, "cpu").model
        assert (m.nb, m.nj, m.ng, m.num_feet) == sizes, task


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


@pytest.mark.parametrize("terrain,group", [("slope", 32), ("grid", 32), ("rough_cfg_spawn", 32),
                                           ("slope", 16), ("rough_cfg_spawn", 16)],
                         ids=["slope", "grid", "rough_cfg_spawn", "slope-packed",
                              "rough_cfg_spawn-packed"])
def test_rough_kernel_body_matches_plain(host_lib, terrain, group):
    """B2's per-env body against the plain version on a slope, on a
    generated grid and on the rough config's 900 x 900 grid at its spawn
    origins, near-standing states with random actions; a warp per env and
    two envs per warp."""
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
    new, tau, gf, fp, fv = _run_host(host_lib, step, st, act, ep, group=group)
    ref, tau_r, rep = step.plain(st, act, ep)
    assert float(rep.geom_forces[..., 2].sum()) > 100.0 * B      # the robots stand on the terrain
    for name, atol in TOLS.items():
        np.testing.assert_allclose(getattr(new, name).numpy(), getattr(ref, name).numpy(),
                                   atol=atol, err_msg=name)
    np.testing.assert_allclose(tau.numpy(), tau_r.numpy(), atol=1e-2)
    np.testing.assert_allclose(fp.numpy(), rep.foot_pos.numpy(), atol=1e-4)
    np.testing.assert_allclose(fv.numpy(), rep.foot_vel.numpy(), atol=1e-2)
    np.testing.assert_allclose(gf.numpy(), rep.geom_forces.numpy(), atol=0.5)


LANE_ORDERS = [(False, 32, "reversed"), (True, 32, "reversed")] + [
    (rough, 16, order) for rough in (False, True)
    for order in ("reversed", "groups_swapped", "interleaved")]


@pytest.mark.parametrize("rough,group,order", LANE_ORDERS,
                         ids=["False", "True"] + [f"{r}-packed-{o}" for r, _, o in LANE_ORDERS[2:]])
def test_kernel_body_is_lane_order_free(host_lib, rough, group, order):
    """The lanes of every phase run last to first give the same bits as first
    to last: within a phase no lane reads what another lane writes, so the
    warp's lanes may run in any order (the kernel's summation orders are
    fixed, no atomics).  Two envs per warp (15 envs: the last warp's second
    env absent): the same bits with the lanes reversed, the two groups
    swapped or interleaved lane by lane, so no lane reads what a lane of
    either group writes in the same phase, and the same bits as a warp per
    env."""
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
    if group == 16:
        B = 15
    st, ep, act = near_standing(model, B, 3, "cpu", origins)
    fwd = _run_host(host_lib, step, st, act, ep, group=group)
    rev = _run_host(host_lib, step, st, act, ep, group=group, order=order)
    _assert_same_bits(fwd, rev)
    if group == 16:
        _assert_same_bits(_run_host(host_lib, step, st, act, ep), fwd)
    assert bool(torch.isfinite(fwd[2]).all()) and float(fwd[2][..., 2].sum()) > 100.0 * B


def _assert_same_bits(a, b):
    """Two ``_run_host`` results agree bit for bit."""
    for x, y in zip(a[1:], b[1:]):
        assert torch.equal(x, y)
    for name in TOLS:
        assert torch.equal(getattr(a[0], name), getattr(b[0], name)), name


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


@pytest.mark.parametrize("control_type,group", [("P", 32), ("T", 32), ("P", 16)],
                         ids=["P", "T", "P-packed"])
def test_fixed_base_kernel_body_matches_plain(host_lib, control_type, group):
    """The fixed-base regime with the arm's tables: zero base acceleration, no
    base solve, no feet, the one geom on the base; joints as the plain
    fixed-base step, the base pose unchanged bit for bit; a warp per env and
    two envs per warp."""
    step = franka_step("cpu", control_type)
    assert step.model.fix_base and step.nf == 0 and int(step.ti_host[pk.TI_FIX]) == 1
    st, ep, act = at_rest(step.model, 64, 0, "cpu")
    if control_type == "T":
        act = 20.0 * act
    new, tau, gf, fp, fv = _run_host(host_lib, step, st, act, ep, group=group)
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


PACKED_TASKS = ["anymal_c_flat", "a1_flat", "go2_flat", "cyberdog2_walk", "anymal_b", "cassie",
                "franka"]


@pytest.mark.parametrize("task", PACKED_TASKS)
def test_packed_body_matches_warp_body(host_lib, task):
    """Every robot of at most 16 bodies whose joints and base fit 16 lanes
    (B1 on ANYmal-C, A1, Go2 and CyberDog2, B2 on ANYmal-B's and Cassie's
    grids, the fixed-base regime on the arm): two envs per warp give the bits
    of a warp per env on the same inputs, with the lanes of each phase run
    first to last, last to first, group by group swapped and interleaved
    (37 envs: the last warp's second env absent)."""
    B = 37
    if task == "franka":
        step = franka_step("cpu")
        states = at_rest(step.model, B, 5, "cpu")
    else:
        env = task_env(task, "cpu", B)
        step = env.decimated_step
        states = task_states(env, B, 5, "cpu")
    assert step.packable
    st, ep, act = states
    warp = _run_host(host_lib, step, st, act, ep)
    for order in ORDERS:
        _assert_same_bits(warp, _run_host(host_lib, step, st, act, ep, group=16, order=order))


@pytest.mark.parametrize("task", ["elspider_air_flat", "foot_track_elspider_air_hang"])
def test_wide_models_keep_a_warp_per_env(task):
    """The hexapods' 19 bodies do not fit half a warp: their steps never
    pack."""
    step = task_env(task, "cpu", 1).decimated_step
    assert step.model.nb == 19 and not step.packable


def test_packed_block_matches_source(host_lib):
    """A block of two envs per warp holds 8 envs, or as many as one block's
    shared memory holds up to ``PACKED_MAX_ENVS``: the wrapper's bytes are the
    source's, 97404 for 8 of ANYmal-C's B1 envs (2 blocks per SM), 227580 for
    its full block of 20 (one per SM, 19 in B2), and a packed block of 8 envs
    of the largest model the tables hold fits one block's shared memory."""
    assert host_lib.physics_max_block_envs(32) == pk.ENVS_PER_BLOCK
    assert host_lib.physics_max_block_envs(16) == pk.PACKED_MAX_ENVS
    sizes_list = ((13, 12, 36, 4), (13, 12, 24, 4), (13, 12, 56, 4), (13, 12, 37, 4),
                  (13, 12, 9, 2), (8, 7, 1, 0), (16, 15, 64, 8), (32, 31, 64, 8))
    for sizes in sizes_list:
        for rough in (False, True):
            ws = 4 * pk.workspace_words(*sizes, rough)
            for envs in (pk.ENVS_PER_BLOCK, pk.PACKED_ENVS_PER_BLOCK):
                nbytes = pk.block_shared_bytes(*sizes, rough, envs=envs)
                assert nbytes == host_lib.physics_block_bytes(ws, envs), (sizes, rough, envs)
                assert nbytes == envs * ws + 4 * (pk.TF_SIZE + pk.TI_FULL)
    assert pk.block_shared_bytes(13, 12, 36, 4, envs=8) == 97404
    assert 2 * (97404 + 1024) <= 233472 < 3 * (97404 + 1024)    # an H100 SM: 228 KB
    model = load_model(MODEL)
    for rough, full in ((False, 20), (True, 19)):
        terrain = (from_numpy(np.arange(64, dtype=np.float32).reshape(8, 8) * 0.01, 0.1) if rough
                   else flat_terrain())
        step = pk.make_decimated_env_step(model, default_sim_params(), terrain, 4,
                                          np.full(12, 80.0, np.float32),
                                          np.full(12, 2.0, np.float32), model.default_dof_pos, 0.5)
        assert step.rough == rough and step.packable and step.full_envs == full
        nbytes = pk.block_shared_bytes(13, 12, 36, 4, rough, envs=full)
        assert nbytes == host_lib.physics_block_bytes(step.ws_bytes, full) <= pk.SMEM_PER_BLOCK
        assert nbytes + step.ws_bytes > pk.SMEM_PER_BLOCK or full == pk.PACKED_MAX_ENVS
    assert pk.block_shared_bytes(13, 12, 36, 4, envs=20) == 227580


@pytest.mark.parametrize("resident,B,shape", [
    ((132, 12, 16, 20), 64, (32, 4)), ((132, 12, 16, 20), 1584, (32, 4)),
    ((132, 12, 16, 20), 2112, (16, 8)), ((132, 12, 16, 20), 10559, (16, 8)),
    ((132, 12, 16, 20), 10560, (16, 20)), ((132, 12, 16, 20), 262144, (16, 20)),
    ((132, 16, 16, 19), 4096, (16, 8)), ((132, 12, 8, 15), 4096, (32, 4)),
    ((132, 12, 8, 15), 262144, (16, 20))],
    ids=["B1-64", "B1-wave", "B1-2112", "B1-below-full", "B1-full", "B1-262144", "B2-4096",
         "wide-workspace-4096", "wide-workspace-262144"])
def test_launch_shape_follows_residency(resident, B, shape):
    """The wrapper's launch shape from the card's SMs and the envs an SM
    holds at a warp per env, in packed blocks of 8 and in full packed blocks
    (given here as the occupancy calculator's readings): a warp per env up
    to one wave, packed blocks of 8 above it, full blocks from
    ``FULL_BLOCK_WAVES`` waves of them up, and a warp per env wherever the
    packed layout would hold fewer envs per SM; the hexapod never packs."""
    model = load_model(MODEL)
    step = pk.make_decimated_env_step(model, default_sim_params(), flat_terrain(), 4,
                                      np.full(12, 80.0, np.float32), np.full(12, 2.0, np.float32),
                                      model.default_dof_pos, 0.5)
    lib = type("Lib", (), {"packed": True})()
    step._resident[(id(lib), "cuda:0")] = resident
    assert step.launch_shape(B, torch.device("cuda:0"), lib) == shape
    wide = task_env("elspider_air_flat", "cpu", 1).decimated_step
    assert wide.launch_shape(B, torch.device("cuda:0"), lib) == (32, 4)
