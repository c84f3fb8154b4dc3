"""The fused CUDA physics kernel against its plain version, on the card.

Needs a CUDA card and nvcc; skips without a card.  Imports no JAX, so it runs
on a machine without it:
    python -m pytest tests/test_torch_kernel_cuda.py -o addopts="" --noconftest -q
Tolerances of tests/test_physics_kernel.py:66-84."""
import numpy as np
import pytest
import torch

from extended_legged_gym_tpu_torch.ops import physics_kernel as pk
from extended_legged_gym_tpu_torch.physics import (EnvPhysParams, default_sim_params,
                                                   initial_state, load_model)
from extended_legged_gym_tpu_torch.terrain import flat_terrain

MODEL = "extended_legged_gym_tpu/robots/data/anymal_c.json"
TOLS = dict(base_pos=1e-4, base_quat=1e-4, joint_pos=5e-4, base_lin_vel=2e-2,
            base_ang_vel=2e-2, joint_vel=5e-2, contact_anchor=1e-4)

pytestmark = pytest.mark.cuda


@pytest.fixture(scope="module")
def setup():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU build")
    dev = torch.device("cuda")
    model = load_model(MODEL)
    step = pk.make_decimated_env_step(model, default_sim_params(), flat_terrain(), 4,
                                      np.full(12, 80.0, np.float32), np.full(12, 2.0, np.float32),
                                      model.default_dof_pos, 0.5)
    B = 300                                                  # not a multiple of the block
    rng = np.random.default_rng(0)
    t = lambda a: torch.as_tensor(a.astype(np.float32), device=dev)
    st = initial_state(model, B, pos=(0.0, 0.0, 0.54), device=dev)
    st = st.replace(base_pos=st.base_pos + t(0.05 * rng.standard_normal((B, 3))),
                    joint_pos=st.joint_pos + t(0.1 * rng.standard_normal((B, 12))),
                    joint_vel=t(0.5 * rng.standard_normal((B, 12))),
                    base_lin_vel=t(0.3 * rng.standard_normal((B, 3))),
                    base_ang_vel=t(0.3 * rng.standard_normal((B, 3))))
    ep = EnvPhysParams(t(rng.uniform(0.5, 1.25, B)), t(rng.uniform(-1.0, 1.0, B)))
    return step, st, ep, t(rng.standard_normal((B, 12)))


def test_kernel_matches_plain_on_card(setup):
    step, st, ep, act = setup
    before = pk.DecimatedEnvStep.launches
    sk, tk, rk = step(st, act, ep)
    assert pk.DecimatedEnvStep.launches == before + 1
    sp, tp, rp = step.plain(st, act, ep)
    torch.cuda.synchronize()
    for name, atol in TOLS.items():
        torch.testing.assert_close(getattr(sk, name), getattr(sp, name), atol=atol, rtol=0)
    torch.testing.assert_close(rk.foot_pos, rp.foot_pos, atol=1e-4, rtol=0)
    torch.testing.assert_close(tk, tp, atol=1e-2, rtol=0)
    fz_k, fz_p = rk.geom_forces[..., 2].sum(1), rp.geom_forces[..., 2].sum(1)
    assert ((fz_k - fz_p).abs() <= 30.0 + 0.2 * fz_p.abs()).all()


def test_kernel_rejects_mixed_devices(setup):
    step, st, ep, act = setup
    with pytest.raises(ValueError, match="actions"):
        step(st, act.cpu(), ep)
