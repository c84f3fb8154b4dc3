"""The CUDA kernel's per-env arithmetic (csrc/physics_step.cu,
``env_control_step``) compiled for the host with a C++ compiler and held to
the plain version (physics/aba.py via DecimatedEnvStep.plain).

The kernel itself runs only on a card (tests/test_torch_physics.py and
chip_smoke.py cover that); this test keeps the arithmetic of the exact kernel
source under the CPU gate.  It compiles a small host loop that includes the
.cu file (without __CUDACC__ only the per-env function is seen) and feeds it
the wrapper's own tables and SoA layout."""
import ctypes
import shutil
import subprocess

import numpy as np
import pytest
import torch

from extended_legged_gym_tpu_torch.ops import physics_kernel as pk
from extended_legged_gym_tpu_torch.physics import EnvPhysParams, initial_state, load_model
from extended_legged_gym_tpu_torch.physics.engine import default_sim_params
from extended_legged_gym_tpu_torch.terrain import flat_terrain

MODEL = "extended_legged_gym_tpu/robots/data/anymal_c.json"
HARNESS = r"""
#include "%s"
extern "C" int host_step(const float* state_in, const float* act, const float* fric,
                         const float* delta, const float* tf, const int* ti, float* state_out,
                         float* tau_out, float* gf_out, float* fpos_out, float* fvel_out, int B) {
  const int nj = ti[TI_NJ], ng = ti[TI_NG], nf = ti[TI_NF];
  const int NS = 13 + 2 * nj + 2 * ng;
  for (int e = 0; e < B; ++e) {
    float s[13 + 2 * MAX_NJ + 2 * MAX_NG], a[MAX_NJ], tau[MAX_NJ];
    float gf[3 * MAX_NG], fp[3 * MAX_NF], fv[3 * MAX_NF];
    for (int r = 0; r < NS; ++r) s[r] = state_in[r * B + e];
    for (int j = 0; j < nj; ++j) a[j] = act[j * B + e] * tf[TF_ASCALE];
    env_control_step(tf, ti, s, a, fric[e], delta[e], tau, gf, fp, fv);
    for (int r = 0; r < NS; ++r) state_out[r * B + e] = s[r];
    for (int j = 0; j < nj; ++j) tau_out[j * B + e] = tau[j];
    for (int r = 0; r < 3 * ng; ++r) gf_out[r * B + e] = gf[r];
    for (int r = 0; r < 3 * nf; ++r) { fpos_out[r * B + e] = fp[r]; fvel_out[r * B + e] = fv[r]; }
  }
  return 0;
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
    h.host_step.argtypes = [ctypes.c_void_p] * 11 + [ctypes.c_int]
    h.host_step.restype = ctypes.c_int
    return h


def _run_host(h, step, st, act, ep):
    """The wrapper's SoA packing around the host-compiled kernel body."""
    B, nj, ng, nf = st.base_pos.shape[0], 12, 36, step.nf
    state = torch.cat([st.base_pos.T, st.base_quat.T, st.joint_pos.T, st.base_lin_vel.T,
                       st.base_ang_vel.T, st.joint_vel.T, st.contact_anchor.reshape(B, -1).T]).contiguous()
    a = act.T.contiguous()
    out, tau = torch.empty_like(state), torch.empty(nj, B)
    gf, fp, fv = torch.empty(3 * ng, B), torch.empty(3 * nf, B), torch.empty(3 * nf, B)
    tf, ti = torch.as_tensor(step.tf_host), torch.as_tensor(step.ti_host)
    h.host_step(state.data_ptr(), a.data_ptr(), ep.friction_scale.data_ptr(),
                ep.base_mass_delta.data_ptr(), tf.data_ptr(), ti.data_ptr(), out.data_ptr(),
                tau.data_ptr(), gf.data_ptr(), fp.data_ptr(), fv.data_ptr(), B)
    o = out.T
    new = st.replace(base_pos=o[:, :3], base_quat=o[:, 3:7], joint_pos=o[:, 7:19],
                     base_lin_vel=o[:, 19:22], base_ang_vel=o[:, 22:25], joint_vel=o[:, 25:37],
                     contact_anchor=o[:, 37:].reshape(B, ng, 2))
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
