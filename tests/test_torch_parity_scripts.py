"""The port's parity scripts (scripts/eval_parity.py, diag_parity.py,
compare_reference_reward.py) on the CPU, at a few envs and steps, on a
synthetic rsl_rl ``.pt`` (the repository holds no reference checkpoint):
each exits cleanly with the JAX script's output keys, and each fails naming
the path where the ``.pt`` is absent (their default is the reference
repository's checkpoint)."""
import os

import numpy as np
import pytest

from extended_legged_gym_tpu_torch.scripts import (compare_reference_reward, diag_parity,
                                                   eval_parity)
from test_torch_torch_compat import write_pt

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OURS = "logs/flat_anymal_c/Aug20_20-45-05_r3_walk/model_final.pkl"
SHORT = ["--steps", "3", "--warmup", "2", "--envs", "2", "--device", "cpu"]


@pytest.fixture(scope="module")
def pt(tmp_path_factory):
    return write_pt(tmp_path_factory.mktemp("ckpt") / "plane_walk_200.pt")


def test_eval_parity_runs_on_a_synthetic_pt(pt):
    """Through the ANYdrive SEA network (the default) and without it."""
    for extra in ([], ["--no-actuator-net"]):
        out = eval_parity.main(["--ckpt", pt, *SHORT, *extra])
        assert {"achieved_over_command", "base_height_mean", "duty_factor_per_foot",
                "duty_spread", "mirror_check", "physx_like_stiffness_check", "resets",
                "tolerances"} <= set(out)
        assert out["n_envs"] == 2 and out["n_steps"] == 3
        assert len(out["duty_factor_per_foot"]) == 4
        assert np.isfinite(out["base_height_mean"]) and np.isfinite(out["achieved_mps"])


def test_diag_parity_runs_on_a_synthetic_pt(pt, capsys):
    o = diag_parity.main(["--ckpt", pt, *SHORT, "--kp", "5e4"])
    text = capsys.readouterr().out
    assert "contact params: 50000.0" in text and "resets over 3 steps x 2 envs" in text
    assert o["contact"].shape == (3, 2, 4) and np.isfinite(o["h"]).all()


def test_compare_reference_reward_runs(pt, monkeypatch):
    """--ref '' --ours on the committed checkpoint, then both sides."""
    monkeypatch.chdir(ROOT)
    outs = compare_reference_reward.main(["--ref", "", "--ours", OURS, "--steps", "3",
                                          "--device", "cpu"])
    assert [o["label"] for o in outs] == ["ours"]
    assert np.isfinite(outs[0]["mean_step_reward"]) and outs[0]["per_term_reward_rate"]
    outs = compare_reference_reward.main(["--ref", pt, "--ours", OURS, "--steps", "3",
                                          "--device", "cpu"])
    assert [o["label"] for o in outs] == ["ours", "reference"]
    assert outs[1]["per_term_reward_rate"].keys() == outs[0]["per_term_reward_rate"].keys()


@pytest.mark.parametrize("script", ["eval_parity", "diag_parity", "compare_reference_reward"])
def test_absent_pt_fails_naming_it(script, tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)                  # the default path is relative: absent here
    main = {"eval_parity": eval_parity.main, "diag_parity": diag_parity.main,
            "compare_reference_reward": compare_reference_reward.main}[script]
    with pytest.raises(FileNotFoundError, match="plane_walk_200.pt"):
        main(["--device", "cpu"])
    with pytest.raises(FileNotFoundError, match="nowhere.pt"):
        main(["--device", "cpu", "--ref" if script == "compare_reference_reward" else "--ckpt",
              str(tmp_path / "nowhere.pt")])
