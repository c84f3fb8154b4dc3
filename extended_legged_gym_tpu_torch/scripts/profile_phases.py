"""Where the time goes inside the fused physics kernels: SM-clock cycles of
each phase of one env's control step, on one card.

Builds ``csrc/physics_step.cu`` a second time with ``-DPHYS_PROFILE``.  One
launch of B1 (flat, ANYmal-C, B envs) and of B2 (rough grid) after a
warm-up gives one stamp list each (block 0, lane 0: the kernel's entry, the
end of its staging, every phase boundary, the end of the block's work and of
its stores); the script names the phases from the model's tree (its depth
levels) and sums them over the substeps, and reports the launch shape the
wrapper chose at B (``launch_shape``: lanes per env, 32 for a warp per env or
16 for two envs per warp, and envs per block) with the envs an SM holds at
once.  It also counts each kernel's SASS
instructions in the plain build (``cuobjdump``).  The stamps cost a few
cycles each.  Usage, from the repository root:

  python -m extended_legged_gym_tpu_torch.scripts.profile_phases [--batch B]

Prints one JSON object.
"""
import argparse
import ctypes
import json
import re
import shutil
import subprocess
from collections import OrderedDict

import numpy as np
import torch

from extended_legged_gym_tpu_torch.ops import physics_kernel as pk
from extended_legged_gym_tpu_torch.robots.anymal_c_traj import (AnymalCTrajGradSampling,
                                                               anymal_c_traj_sampling_cfg)
from extended_legged_gym_tpu_torch.scripts.bench_kernel import near_standing, rough_env


def phase_names(model, decimation):
    """Names of the stamped phases in kernel order."""
    parent = list(model.parent)
    depth = [0] * model.nb
    for i in range(1, model.nb):
        depth[i] = depth[parent[i]] + 1
    maxd = max(depth)
    names = ["stage in (tables, state)", "base inertia"]
    for _ in range(decimation):
        names += ["kinematics, torques", "contacts", "body sums: IA, pA"]
        names += [f"backward level {d}" for d in range(maxd, 0, -1)]
        names += ["base: children, Cholesky", "forward sweep", "report, integration"]
    return names + ["wait for the block", "stage out"]


def sass_counts(lib_path):
    """SASS instructions per kernel of a built library (cuobjdump), or None."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    try:
        out = subprocess.run([tool, "-sass", lib_path], capture_output=True, text=True,
                             timeout=300).stdout
    except OSError:
        return None
    counts, fn = {}, None
    for line in out.splitlines():
        m = re.match(r"\s*Function : (\S+)", line)
        if m:
            fn = m.group(1)
            counts[fn] = 0
        elif fn and re.match(r"\s*/\*[0-9a-f]{4,}\*/", line):
            counts[fn] += 1
    return counts


def profile(lib, step, states, reps=3):
    st, ep, act = states
    buf = (ctypes.c_longlong * 4096)()
    for _ in range(reps):
        step.launch(st, act, ep, lib=lib)
    lib.physics_profile_read(ctypes.addressof(buf), 4096)
    step.launch(st, act, ep, lib=lib)
    n = lib.physics_profile_read(ctypes.addressof(buf), 4096)
    stamps = np.array(buf[:n], dtype=np.int64)
    names = phase_names(step.model, step.decimation)
    if n != len(names) + 1:
        raise RuntimeError(f"{n} stamps for {len(names)} phases")
    cyc = np.diff(stamps)
    by_name = OrderedDict()
    for name, c in zip(names, cyc):
        by_name[name] = by_name.get(name, 0) + int(c)
    per_sub = int(cyc[2:-2].sum()) // step.decimation
    group, envs = step.launch_shape(st.base_pos.shape[0], st.base_pos.device, lib)
    return {"launch_shape": [group, envs],
            "resident_envs_per_sm": lib.physics_resident_envs(int(step.rough), group, envs),
            "cycles_launch": int(stamps[-1] - stamps[0]), "cycles_per_substep": per_sub,
            "cycles_by_phase_all_substeps": by_name}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--batch", type=int, default=8)
    args = ap.parse_args()
    dev = torch.device("cuda")
    lib = pk.load_library(pk.SOURCE, ("-DPHYS_PROFILE",))
    lib.physics_profile_read.argtypes = [ctypes.c_void_p, ctypes.c_int]
    lib.physics_profile_read.restype = ctypes.c_int
    flat = AnymalCTrajGradSampling(anymal_c_traj_sampling_cfg(1), device=dev).decimated_step
    renv = rough_env(max(args.batch, 32), dev)
    origins = renv.reset_all(seed=0).env_origins
    out = {"batch": args.batch}
    for name, step, org in (("B1", flat, None), ("B2", renv.decimated_step, origins)):
        out[name] = profile(lib, step, near_standing(step.model, args.batch, 0, dev, org))
    out["sass_instructions"] = sass_counts(pk.build_library())
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit,clocks.sm,clocks.max.sm",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60).stdout.strip()
    out["card"] = smi
    print(json.dumps(out))


if __name__ == "__main__":
    main()
