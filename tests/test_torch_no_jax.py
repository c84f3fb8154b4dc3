"""The port must run where JAX is not installed: every module of
extended_legged_gym_tpu_torch, and chip_smoke.py, import with jax, jaxlib,
flax, optax and the JAX package blocked, and the committed warm-start
checkpoint (whose optimizer state pickles optax objects) loads."""
import os
import subprocess
import sys
import textwrap

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CKPT = "logs/flat_anymal_c/Aug21_12-38-39_r5_ft4/model_final.pkl"

SCRIPT = textwrap.dedent(f"""
    import importlib, importlib.abc, pkgutil, sys
    BLOCKED = {{"jax", "jaxlib", "flax", "optax", "extended_legged_gym_tpu"}}

    class Block(importlib.abc.MetaPathFinder):
        def find_spec(self, name, path=None, target=None):
            if name.split(".")[0] in BLOCKED:
                raise ImportError(f"blocked import of {{name}}")
            return None

    sys.meta_path.insert(0, Block())
    sys.path.insert(0, {ROOT!r})
    import extended_legged_gym_tpu_torch as pkg
    names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
    for n in names:
        importlib.import_module(n)
    import chip_smoke
    from extended_legged_gym_tpu_torch.models.networks import ActorCritic, load_jax_checkpoint
    sd = load_jax_checkpoint({CKPT!r})
    net = ActorCritic(48, 12, (128, 64, 32), (128, 64, 32))
    net.load_state_dict(sd)
    leaked = sorted(m for m in sys.modules if m.split(".")[0] in BLOCKED)
    assert not leaked, leaked
    print("imported", len(names), "modules; actor", tuple(sd["actor.0.weight"].shape))
""")


def test_port_imports_and_loads_checkpoint_without_jax():
    proc = subprocess.run([sys.executable, "-c", SCRIPT], cwd=ROOT, capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "actor (128, 48)" in proc.stdout
    n = int(proc.stdout.split("imported ")[1].split()[0])
    assert n >= 20


def test_chip_smoke_refuses_without_cuda():
    """Without a CUDA card, chip_smoke.py exits non-zero and prints no
    result line; with a card the test skips."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    proc = subprocess.run([sys.executable, "chip_smoke.py"], cwd=ROOT, capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout and '"kernels"' not in proc.stdout
