"""Sampling-MPC cells: ``mpc_step`` of the configuration's task over the
traffic's main envs and samples, the plan warm-started from the committed
RL policy, every step replanned from the current state.

Set-up builds the env, fits the first plan to the policy's rollout and runs
``check_steps`` steps (the first with the configuration's initial number of
diffusion steps) through the same call with recorders in place.  The check
then follows those steps: the physics step on recorded rows of every launch
(rollouts, polish, main step) with the rollout reward of the same rows, and
the plan's arithmetic (samples, AVWBFO update, fd polish) step by step from
the program's inputs with the noise drawn again from the env's generator."""
from __future__ import annotations

from typing import Dict, List, Optional

import torch

from .. import check
from ..record import PhysicsRows, patched, to_cpu
from ..reference.mpc import RolloutReward, Sampler, body_frame
from ..reference.physics import ControlStep, Ground
from ..reference.robot import Robot
from .common import Driver, verify_config

# what a rollout env carries into its reward besides its physics step's outputs
CARRIED = ("commands", "last_actions", "last_dof_vel", "feet_air_time", "last_contacts")


class MPCDriver(Driver):
    FAULTS = ("unchanged", "half", "altered")

    def build(self):
        import extended_legged_gym_tpu_torch.robots  # noqa: F401 (registers the tasks)
        from extended_legged_gym_tpu_torch.ops.physics_kernel import DecimatedEnvStep
        from extended_legged_gym_tpu_torch.utils.task_registry import task_registry

        c, t = self.config, self.traffic
        cfg, _ = task_registry.get_cfgs(c["task"])
        cfg.env.num_envs = t["num_envs"]
        cfg.trajectory_opt.num_samples = t["num_samples"]
        cfg.seed = self.prog_seed
        cfg.rl_warmstart.policy_checkpoint = self.path(c["warm_start"])
        verify_config(c, cfg)
        self.env, _ = task_registry.make_env(c["task"], env_cfg=cfg, device=self.device)
        self.env.setup_rl_warmstart()
        self.state = self.env.reset_all()
        self.nodes = self.env.init_trajectories_from_rl(self.state)
        self.kernel = DecimatedEnvStep
        self.bad = torch.zeros((), dtype=torch.int64, device=self.device)

    def end_to_end(self, res: dict) -> dict:
        """The window's milliseconds over the steps it completed."""
        return {"mpc_step_ms": {"value": res["seconds"] * 1e3 / res["steps"], "unit": "ms"}}

    def step(self) -> bool:
        self.state, self.nodes, _ = self.env.mpc_step(self.state, self.nodes)
        self.bad += (~torch.isfinite(self.nodes).all()).to(torch.int64)
        return True

    def window(self, seconds: float, traced: bool) -> dict:
        self.bad.zero_()
        out = super().window(seconds, traced)
        out["failed"] = int(self.bad)
        return out

    def counter_values(self) -> Dict[str, float]:
        return dict(physics_launches=float(self.kernel.launches + self.kernel.rough_launches))

    # ------------------------------------------------------------ check steps
    def check_steps(self):
        env, sampler = self.env, self.env.traj_sampler
        t = self.traffic
        phys = PhysicsRows(t["check_rows_per_step"], self.row_gen)
        rew_rows: List[dict] = []
        calls: List[dict] = []

        def reward_wrap(fn):
            # a rollout step's reward follows its physics step: the same rows
            def wrapped(rs):
                rs_out, rew = fn(rs)
                idx = phys.last_idx
                rec = {k: getattr(rs, k)[idx].clone() for k in CARRIED}
                rec["rew"] = rew[idx].clone()
                rec["row"] = torch.arange(phys.rows_before, phys.rows_before + len(idx))
                rew_rows.append(rec)
                return rs_out, rew
            return wrapped

        def optimize_wrap(fn):
            def wrapped(state, nodes, generator=None, **kw):
                gen = generator or env.generator
                calls.append(dict(gen_state=gen.get_state(), nodes_in=nodes.clone(),
                                  updates=[], polish=None))
                return fn(state, nodes, generator, **kw)
            return wrapped

        def update_wrap(fn):
            def wrapped(nodes, samples, rewards):
                out = fn(nodes, samples, rewards)
                calls[-1]["updates"].append(to_cpu(dict(nodes_in=nodes, samples=samples,
                                                        rewards=rewards, nodes_out=out)))
                return out
            return wrapped

        def polish_wrap(fn):
            def wrapped(nodes, rollout_fn, n_iters, lr, eps=0.05):
                batches = []

                def recorded(all_us):
                    r = rollout_fn(all_us)
                    batches.append(to_cpu(dict(all_us=all_us, rewards=r)))
                    return r
                out, info = fn(nodes, recorded, n_iters, lr, eps=eps)
                calls[-1]["polish"] = dict(nodes_in=to_cpu(nodes), nodes_out=to_cpu(out),
                                           batches=batches)
                return out, info
            return wrapped

        to = self.config["trajectory_opt"]
        with patched(env, "decimated_step", phys), \
                patched(env, "_compute_rollout_reward", reward_wrap), \
                patched(env, "optimize_all_trajectories", optimize_wrap), \
                patched(sampler, "update_fn", update_wrap), \
                patched(sampler, "polish_fd", polish_wrap):
            for i in range(t["check_steps"]):
                self.state, self.nodes, _ = env.mpc_step(
                    self.state, self.nodes,
                    n_diffuse=to["num_diffuse_steps_init"] if i == 0 else None)
        if not torch.isfinite(self.nodes).all():
            raise RuntimeError("a check step's plan is not finite")
        for c in calls:
            c["nodes_in"] = to_cpu(c["nodes_in"])
        self.records = dict(physics=to_cpu(phys.stacked()),
                            rewards={k: torch.cat([to_cpu(r[k]) for r in rew_rows])
                                     for k in rew_rows[0]},
                            calls=calls)
        self.num_actions = env.num_actions

    def release(self):
        del self.env, self.state, self.nodes

    # ------------------------------------------------------------ reference
    def _robot(self) -> Robot:
        if not hasattr(self, "_robot_"):
            self._robot_ = Robot(self.path(self.config["robot"]))
        return self._robot_

    def _step(self) -> ControlStep:
        if not hasattr(self, "_control_step"):
            t = self.config["terrain"]
            if t["mesh_type"] not in ("plane", "none"):
                raise ValueError("the MPC reference runs on a plane")
            self._control_step = ControlStep(self._robot(), Ground.plane(
                friction=t["static_friction"]), self.config)
        return self._control_step

    def _dev(self, tree):
        return {k: v.to(self.device) for k, v in tree.items()}

    def _plan(self, fault: Optional[str]) -> dict:
        """The reference's plan step by step from the program's inputs:
        samples and update of each diffusion iteration, then the polish's
        stencils, candidates and accepted nodes."""
        smp = Sampler(self.config["trajectory_opt"], self.num_actions, self.device)
        out = dict(samples=[], updates=[], dense=[], polish_out=[])
        E = None
        for c in self.records["calls"]:
            gen = torch.Generator(device=self.device)
            gen.set_state(c["gen_state"])
            for i, u in enumerate(c["updates"]):
                nodes = u["nodes_in"].to(self.device)
                E, S = nodes.shape[0], u["samples"].shape[1]
                eps = torch.randn((E, S - 1) + tuple(nodes.shape[1:]), generator=gen,
                                  device=self.device)
                s = smp.samples(nodes, i, eps)
                out["samples"].append(s)
                new = smp.update(s, u["rewards"].to(self.device), half=fault == "half")
                out["updates"].append(nodes if fault == "unchanged" else new)
            p = c["polish"]
            if p is None:
                continue
            nodes = p["nodes_in"].to(self.device)
            b = p["batches"]
            for k in range(len(b) // 2):
                out["dense"].append(smp.dense(smp.stencil(nodes)))
                cands, J_old = smp.candidates(nodes, b[2 * k]["rewards"].to(self.device))
                out["dense"].append(smp.dense(cands))
                nodes = smp.accept(nodes, cands, J_old, b[2 * k + 1]["rewards"].to(self.device))
            out["polish_out"].append(nodes)
        return out

    def _rewards(self, physics: Dict[str, torch.Tensor], fault: Optional[str]) -> torch.Tensor:
        """The rollout rewards of the recorded rows from a control step's
        outputs (``physics``) and what the rollout env carried in."""
        rec = self._dev(self.records["rewards"])
        row = rec["row"]
        lin, ang, grav = body_frame(physics["out.base_quat"][row], physics["out.base_lin_vel"][row],
                                    physics["out.base_ang_vel"][row])
        s = {k: rec[k] for k in CARRIED}
        s.update(base_lin_vel=lin, base_ang_vel=ang, projected_gravity=grav,
                 torques=physics["tau"][row], joint_vel=physics["out.joint_vel"][row],
                 geom_forces=physics["geom_forces"][row], actions=self._dev(
                     self.records["physics"])["actions"][row])
        r = RolloutReward(self.config, self._robot(), self.device)(s)
        return r + 0.1 if fault == "altered" else r

    def candidate(self, kind: str) -> dict:
        """The program's records (``program``), or the reference in its place
        in TF32 (``control``) or with a planted fault (``unchanged``,
        ``half``, ``altered``)."""
        if kind == "program":
            r = self.records
            dense, pol = [], []
            for c in r["calls"]:
                if c["polish"] is not None:
                    dense += [b["all_us"] for b in c["polish"]["batches"]]
                    pol.append(c["polish"]["nodes_out"])
            return dict(physics=r["physics"], rewards=r["rewards"]["rew"],
                        samples=[u["samples"] for c in r["calls"] for u in c["updates"]],
                        updates=[u["nodes_out"] for c in r["calls"] for u in c["updates"]],
                        dense=dense, polish_out=pol)
        fault = None if kind == "control" else kind
        with check.precision(kind == "control"):
            out = self._plan(fault)
            out["physics"] = check.physics_outputs(self._step(), self._dev(self.records["physics"]))
            out["rewards"] = self._rewards(out["physics"], fault)
        return out

    def numbers(self, cand: dict) -> Dict[str, float]:
        if not hasattr(self, "_ref"):
            with check.precision(False):
                self._ref = self._plan(None)
                self._ref["physics"] = check.physics_outputs(
                    self._step(), self._dev(self.records["physics"]))
                self._ref["rewards"] = self._rewards(self._ref["physics"], None)
        ref, dev = self._ref, self.device
        plan = 0.0
        for key in ("samples", "updates", "dense", "polish_out"):
            for a, b in zip(cand[key], ref[key]):
                plan = max(plan, check.rel_gap(a.to(dev), b))
        # a rollout row's gap: its control step's, and where the row took a
        # reward, the reward's gap over the rewards' root mean square
        gaps = check.row_gaps(self._dev(cand["physics"]), ref["physics"],
                              self._dev(self.records["physics"]))
        row = self.records["rewards"]["row"].to(dev)
        scale = max(check.rms(ref["rewards"]), 1e-12)
        rew = (cand["rewards"].to(dev) - ref["rewards"]).abs() / scale
        gaps[row] = torch.maximum(gaps[row], rew)
        return dict(rollout_gap=check.quantile(gaps, 0.9), plan_gap=plan)

    # ------------------------------------------------------------ work
    def work(self) -> dict:
        """Env control steps of one ``mpc_step`` and their physics work: the
        diffusion rollouts, the fd polish's stencil and candidate rollouts,
        and the main step (the near-fall re-plans are counted where the
        traced window saw them)."""
        from ..flops import control_step_bytes, control_step_flops

        robot = self._robot()
        to, t = self.config["trajectory_opt"], self.traffic
        E, S = t["num_envs"], t["num_samples"] + 1
        H1 = to["horizon_samples"] + 1
        D = to["horizon_nodes"] * self.config["env"]["num_actions"]
        env_steps = (H1 * to["num_diffuse_steps"] * E * S
                     + to["polish_iters"] * H1 * E * (2 * D + 1 + 3) + E)
        dec = self.config["control"]["decimation"]
        return dict(env_steps=env_steps, replan_env_steps=H1 * E,
                    flops_per_env_step=control_step_flops(robot.nb, robot.nj, robot.ng, robot.nf,
                                                          dec),
                    bytes_per_env_step=control_step_bytes(robot.nj, robot.ng, robot.nf, dec))

    def trace_timers(self):
        return [(self.env, "optimize_all_trajectories", "optimize_s")]

    def trace_ranges(self):
        env = self.env
        return [(env, "optimize_all_trajectories", "optimize"), (env, "rollout_batch", "rollout_batch"),
                (env.traj_sampler, "polish_fd", "polish"), (env, "step", "env.step"),
                (env, "init_trajectories_from_rl", "replan"), (env, "decimated_step", "physics_step")]


DRIVER = MPCDriver
