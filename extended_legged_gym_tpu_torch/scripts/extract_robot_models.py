"""Extract robot morphologies from URDF into the JSON model format (port of
``scripts/extract_robot_models.py``).

Run once against a legged_gym-style resources tree (the reference
repository's ``legged_gym/resources/robots``); each robot of ``ROBOTS``
whose URDF is there is loaded (``physics/urdf.load_urdf``), given its feet
(``attach_feet``) and written with ``physics/serialize.save_model`` as
``<out_dir>/<name>.json``, the layout ``load_model`` reads.  The committed
models the port loads are the JAX package's
(``extended_legged_gym_tpu/robots/data``).

Usage: python -m extended_legged_gym_tpu_torch.scripts.extract_robot_models
           [resources_root] [out_dir]
"""
from __future__ import annotations

import os
import sys

from ..physics.serialize import save_model
from ..physics.urdf import attach_feet, load_urdf

DEFAULT_ROOT = "legged_gym/resources/robots"
DEFAULT_OUT = os.path.join(os.path.dirname(__file__), "..", "robots", "data")

# (name, urdf relpath, foot link pattern, base height, default joint angles)
ROBOTS = {
    "anymal_c": dict(
        urdf="anymal_c/urdf/anymal_c.urdf", foot="FOOT", height=0.6,
        angles={"LF_HAA": 0.0, "LH_HAA": 0.0, "RF_HAA": -0.0, "RH_HAA": -0.0,
                "LF_HFE": 0.4, "LH_HFE": -0.4, "RF_HFE": 0.4, "RH_HFE": -0.4,
                "LF_KFE": -0.8, "LH_KFE": 0.8, "RF_KFE": -0.8, "RH_KFE": 0.8}),
    "anymal_b": dict(
        urdf="anymal_b/urdf/anymal_b.urdf", foot="FOOT", height=0.6,
        angles={"LF_HAA": 0.0, "LH_HAA": 0.0, "RF_HAA": -0.0, "RH_HAA": -0.0,
                "LF_HFE": 0.4, "LH_HFE": -0.4, "RF_HFE": 0.4, "RH_HFE": -0.4,
                "LF_KFE": -0.8, "LH_KFE": 0.8, "RF_KFE": -0.8, "RH_KFE": 0.8}),
    "a1": dict(
        urdf="a1/urdf/a1.urdf", foot="foot", height=0.42,
        angles={"FL_hip_joint": 0.1, "RL_hip_joint": 0.1, "FR_hip_joint": -0.1,
                "RR_hip_joint": -0.1, "FL_thigh_joint": 0.8, "RL_thigh_joint": 1.0,
                "FR_thigh_joint": 0.8, "RR_thigh_joint": 1.0,
                "FL_calf_joint": -1.5, "RL_calf_joint": -1.5,
                "FR_calf_joint": -1.5, "RR_calf_joint": -1.5}),
    "go2": dict(
        urdf="go2/urdf/go2_description.urdf", foot="foot", height=0.42,
        angles={"FL_hip_joint": 0.1, "RL_hip_joint": 0.1, "FR_hip_joint": -0.1,
                "RR_hip_joint": -0.1, "FL_thigh_joint": 0.8, "RL_thigh_joint": 1.0,
                "FR_thigh_joint": 0.8, "RR_thigh_joint": 1.0,
                "FL_calf_joint": -1.5, "RL_calf_joint": -1.5,
                "FR_calf_joint": -1.5, "RR_calf_joint": -1.5}),
    "cassie": dict(
        urdf="cassie/urdf/cassie.urdf", foot="toe", height=1.0,
        angles={"hip_abduction_left": 0.1, "hip_rotation_left": 0.0,
                "hip_flexion_left": 1.0, "thigh_joint_left": -1.8,
                "ankle_joint_left": 1.57, "toe_joint_left": -1.57,
                "hip_abduction_right": -0.1, "hip_rotation_right": 0.0,
                "hip_flexion_right": 1.0, "thigh_joint_right": -1.8,
                "ankle_joint_right": 1.57, "toe_joint_right": -1.57}),
    "cyberdog2": dict(
        urdf="cyberdog2/urdf/cyberdog2_v2.urdf", foot="foot", height=0.35,
        angles={"FL_hip_joint": 0.0, "RL_hip_joint": 0.0, "FR_hip_joint": -0.0,
                "RR_hip_joint": -0.0, "FL_thigh_joint": 0.8, "RL_thigh_joint": 1.0,
                "FR_thigh_joint": 0.8, "RR_thigh_joint": 1.0,
                "FL_calf_joint": -1.5, "RL_calf_joint": -1.5,
                "FR_calf_joint": -1.5, "RR_calf_joint": -1.5}),
    "elspider_air": dict(
        urdf="el_mini/urdf/el_mini_collsp.urdf", foot="FOOT", height=0.4,
        angles={"RF_HAA": 0.0, "RM_HAA": 0.0, "RB_HAA": 0.0, "LF_HAA": 0.0,
                "LM_HAA": 0.0, "LB_HAA": 0.0, "RF_HFE": 0.6, "RM_HFE": 0.6,
                "RB_HFE": 0.6, "LF_HFE": 0.6, "LM_HFE": 0.6, "LB_HFE": 0.6,
                "RF_KFE": 0.6, "RM_KFE": 0.6, "RB_KFE": 0.6, "LF_KFE": 0.6,
                "LM_KFE": 0.6, "LB_KFE": 0.6}),
    "franka": dict(
        urdf="franka/urdf/franka_panda.urdf", foot="finger", height=0.0,
        fix_base=True,
        angles={"panda_joint1": 0.0, "panda_joint2": -0.3, "panda_joint3": 0.0,
                "panda_joint4": -1.8, "panda_joint5": 0.0, "panda_joint6": 1.6,
                "panda_joint7": 0.8}),
}


def main(resources_root: str = DEFAULT_ROOT, out_dir: str = DEFAULT_OUT):
    """Write every robot whose URDF is under ``resources_root``; a missing
    URDF is skipped and a failing one reported, as the JAX script does.
    Returns the names written."""
    os.makedirs(out_dir, exist_ok=True)
    written = []
    for name, spec in ROBOTS.items():
        path = os.path.join(resources_root, spec["urdf"])
        if not os.path.exists(path):
            print(f"skip {name}: {path} missing")
            continue
        try:
            model = load_urdf(path, default_joint_angles=spec["angles"],
                              base_init_height=spec["height"],
                              fix_base=spec.get("fix_base", False))
            model = attach_feet(model, spec["foot"])
            out = os.path.join(out_dir, f"{name}.json")
            save_model(model, out)
            written.append(name)
            print(f"{name}: nb={model.nb} nj={model.nj} geoms={model.geom_radius.shape[0]} "
                  f"feet={model.foot_names} mass={float(sum(model.mass)):.1f}kg -> {out}")
        except Exception as e:
            print(f"FAIL {name}: {type(e).__name__}: {e}")
    return written


if __name__ == "__main__":
    main(*sys.argv[1:3])
