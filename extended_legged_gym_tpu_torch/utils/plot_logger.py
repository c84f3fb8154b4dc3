"""State and reward traces of a policy playing, saved as JSON and plotted to
PNG (port of ``utils/plot_logger.py``, after the reference's
``utils/logger.py``).

Host-side numpy: ``log_env_step`` reads env 0's trace set from an
:class:`EnvState` with one device-to-host copy per step.  ``plot_states``
renders the reference's 3 x 3 grid (tracking, joint states, contact forces,
torque-velocity) with matplotlib's Agg backend and returns ``None`` where
matplotlib is not installed; ``save_json`` writes the JAX layout ``{"dt",
"states", "rewards", "num_episodes"}``.
"""
from __future__ import annotations

import json
import os
from collections import defaultdict
from typing import Dict, Optional

import numpy as np
import torch


class Logger:
    def __init__(self, dt: float):
        self.state_log = defaultdict(list)
        self.rew_log = defaultdict(list)
        self.dt = dt
        self.num_episodes = 0

    def log_state(self, key: str, value):
        self.state_log[key].append(np.asarray(value))

    def log_states(self, d: Dict):
        for key, value in d.items():
            self.log_state(key, value)

    def log_rewards(self, d: Dict, num_episodes: int):
        for key, value in d.items():
            if "rew_" in key:
                self.rew_log[key].append(float(np.asarray(value)) * num_episodes)
        self.num_episodes += num_episodes

    def reset(self):
        self.state_log.clear()
        self.rew_log.clear()

    def log_env_step(self, env, state, joint_index: int = 0):
        """The reference play script's trace set of env 0 (its joint
        ``joint_index``), read from the device in one copy."""
        nf = len(env.feet_geoms)
        row = torch.cat([
            state.actions[0, joint_index:joint_index + 1], env.default_dof_pos[joint_index:joint_index + 1],
            state.phys.joint_pos[0, joint_index:joint_index + 1],
            state.phys.joint_vel[0, joint_index:joint_index + 1],
            state.torques[0, joint_index:joint_index + 1], state.commands[0, :3],
            state.base_lin_vel[0], state.base_ang_vel[0, 2:3],
            state.geom_forces[0, env.feet_geoms, 2]]).to(torch.float32).cpu().numpy()
        act, ddp, jp, jv, tq = row[:5]
        self.log_states({
            "dof_pos_target": np.float32(act * env.cfg.control.action_scale + ddp),
            "dof_pos": jp, "dof_vel": jv, "dof_torque": tq,
            "command_x": row[5], "command_y": row[6], "command_yaw": row[7],
            "base_vel_x": row[8], "base_vel_y": row[9], "base_vel_z": row[10],
            "base_vel_yaw": row[11],
            "contact_forces_z": row[12:12 + nf],
        })

    def save_json(self, path: str):
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        payload = {
            "dt": self.dt,
            "states": {k: np.stack(v).tolist() for k, v in self.state_log.items()},
            "rewards": {k: v for k, v in self.rew_log.items()},
            "num_episodes": self.num_episodes,
        }
        with open(path, "w") as f:
            json.dump(payload, f)
        return path

    def plot_states(self, save_path: Optional[str] = None):
        """Render the reference's 3 x 3 grid to a PNG: the path, or ``None``
        where matplotlib is not installed or nothing was logged."""
        try:
            import matplotlib
            matplotlib.use("Agg")
            import matplotlib.pyplot as plt
        except Exception:
            return None

        log = self.state_log
        n = max((len(v) for v in log.values()), default=0)
        if n == 0:
            return None
        time = np.linspace(0, n * self.dt, n)
        fig, axs = plt.subplots(3, 3, figsize=(14, 10))

        def series(key):
            return np.stack(log[key]) if log.get(key) else None

        panels = [
            ((0, 0), [("base_vel_x", "measured"), ("command_x", "commanded")],
             "base lin vel [m/s]", "Base velocity x"),
            ((0, 1), [("base_vel_y", "measured"), ("command_y", "commanded")],
             "base lin vel [m/s]", "Base velocity y"),
            ((0, 2), [("base_vel_yaw", "measured"), ("command_yaw", "commanded")],
             "base ang vel [rad/s]", "Base velocity yaw"),
            ((1, 0), [("dof_pos", "measured"), ("dof_pos_target", "target")],
             "Position [rad]", "DOF Position"),
            ((1, 1), [("dof_vel", "measured"), ("dof_vel_target", "target")],
             "Velocity [rad/s]", "Joint Velocity"),
            ((1, 2), [("base_vel_z", "measured")],
             "base lin vel [m/s]", "Base velocity z"),
            ((2, 2), [("dof_torque", "measured")],
             "Joint Torque [Nm]", "Torque"),
        ]
        for (r, c), keys, ylabel, title in panels:
            a = axs[r, c]
            for key, label in keys:
                v = series(key)
                if v is not None:
                    a.plot(time[: len(v)], v, label=label)
            a.set(xlabel="time [s]", ylabel=ylabel, title=title)
            a.legend(fontsize=6)
        # vertical contact forces
        a = axs[2, 0]
        v = series("contact_forces_z")
        if v is not None:
            for i in range(v.shape[1]):
                a.plot(time[: len(v)], v[:, i], label=f"force {i}")
        a.set(xlabel="time [s]", ylabel="Forces z [N]", title="Vertical Contact forces")
        a.legend(fontsize=6)
        # torque-velocity scatter
        a = axs[2, 1]
        tv, tq = series("dof_vel"), series("dof_torque")
        if tv is not None and tq is not None:
            a.plot(tv, tq, "x", label="measured")
        a.set(xlabel="Joint vel [rad/s]", ylabel="Joint Torque [Nm]",
              title="Torque/velocity curves")
        a.legend(fontsize=6)

        fig.tight_layout()
        save_path = save_path or "play_states.png"
        os.makedirs(os.path.dirname(save_path) or ".", exist_ok=True)
        fig.savefig(save_path, dpi=110)
        plt.close(fig)
        return save_path

    def print_rewards(self):
        print("Average rewards per second:")
        for key, values in self.rew_log.items():
            mean = np.sum(np.array(values)) / max(self.num_episodes, 1)
            print(f" - {key}: {mean}")
        print(f"Total number of episodes: {self.num_episodes}")
