"""PPO training cells: ``OnPolicyRunner`` on the configuration's task at the
traffic's number of envs, iterated as ``OnPolicyRunner.learn`` does without
a log directory (one ``train_iteration`` and the host read of its metrics
per iteration).

Set-up builds the env and the runner from the seed and runs the first
``check_iterations`` iterations through the same call with recorders in
place; the reference then follows those iterations (``reference/ppo.py``)
and checks the physics step on recorded rows (``reference/physics.py``)."""
from __future__ import annotations

import math
from typing import Dict, List, Optional

import torch

from .. import check
from ..record import PhysicsRows, patched, to_cpu
from ..reference.physics import ControlStep, Ground
from ..reference.ppo import PPOParams, follow
from ..reference.robot import Robot
from ..reference.terrain import curriculum_ground
from .common import Driver, verify_config


class PPODriver(Driver):
    @property
    def FAULTS(self):
        # across cards also the reductions left out ("exchange")
        return ("unchanged", "half") + (("exchange",) if self.world > 1 else ())

    def build(self):
        import extended_legged_gym_tpu_torch.robots  # noqa: F401 (registers the tasks)
        from extended_legged_gym_tpu_torch.rl.runner import OnPolicyRunner
        from extended_legged_gym_tpu_torch.utils.task_registry import task_registry

        c, t = self.config, self.traffic
        env_cfg, train_cfg = task_registry.get_cfgs(c["task"])
        env_cfg.env.num_envs = t["num_envs"]
        env_cfg.seed = train_cfg.seed = self.prog_seed
        verify_config(c, env_cfg, train_cfg)
        # with a mesh, num_envs is global: each rank builds its share, its env
        # seed offset by its rank
        self.env, _ = task_registry.make_env(c["task"], env_cfg=env_cfg, device=self.device,
                                             mesh=self.mesh)
        self.runner = OnPolicyRunner(self.env, train_cfg, log_dir=None, seed=self.prog_seed,
                                     mesh=self.mesh)
        self.work_per_step = t["num_envs"] * train_cfg.runner.num_steps_per_env

    def end_to_end(self, res: dict) -> dict:
        """Env control steps of every iteration, on every card, over the
        window's seconds (``.dp`` across cards: its own metric and bound)."""
        name = "train_env_steps_per_s" + (".dp" if self.world > 1 else "")
        return {name: {"value": res["steps"] * self.work_per_step / res["seconds"],
                       "unit": "steps/s"}}

    def step(self) -> bool:
        """One iteration as ``learn`` runs it; False where its metrics are
        not finite."""
        metrics = self.runner.train_iteration()
        names = list(metrics)
        values = torch.stack([metrics[k].to(torch.float32) for k in names]).tolist()
        self.spans.setdefault("collection_s", []).append(self.runner.last_times["collection_s"])
        self.spans.setdefault("update_s", []).append(self.runner.last_times["update_s"])
        return all(math.isfinite(v) for v in values)

    # ------------------------------------------------------------ check steps
    def check_steps(self):
        import extended_legged_gym_tpu_torch.rl.ppo as ppo_mod
        import extended_legged_gym_tpu_torch.rl.runner as runner_mod

        env, runner = self.env, self.runner
        phys = PhysicsRows(self.traffic["check_rows_per_step"], self.row_gen)
        iters: List[dict] = []
        cur: Dict[str, list] = {}
        net = runner.network
        self.prog_start = {k: v.detach().clone() for k, v in net.named_parameters()}

        def step_wrap(step):
            def wrapped(state, actions):
                out = step(state, actions)
                cur.setdefault("rew", []).append(out.rew.clone())
                cur.setdefault("time_out", []).append(out.time_out_buf.clone())
                cur["last_obs"] = out.obs
                return out
            return wrapped

        def update_wrap(update):
            def wrapped(network, cfg, optimizer, batch, advantages, returns, lr, **kw):
                cur.update(obs=batch.obs, actions=batch.actions, values=batch.values,
                           dones=batch.dones, advantages=advantages.clone())
                lr_new, metrics = update(network, cfg, optimizer, batch, advantages, returns,
                                         lr, **kw)
                cur["loss"] = metrics["loss"]
                return lr_new, metrics
            return wrapped

        first = {}

        def loss_wrap(ppo_loss):
            def wrapped(*a, **kw):
                out = ppo_loss(*a, **kw)
                if "loss" not in first:
                    first["loss"] = out[0].detach().clone()
                return out
            return wrapped

        def opt_wrap(opt_step):
            def wrapped(grads, lr, ok):
                if "grad" in first:
                    return opt_step(grads, lr, ok)
                first["grad"] = torch.cat([g.reshape(-1) for g in grads]).clone()
                out = opt_step(grads, lr, ok)
                first["after"] = {k: v.detach().clone() for k, v in net.named_parameters()}
                return out
            return wrapped

        with patched(env, "decimated_step", phys), patched(env, "step", step_wrap), \
                patched(runner_mod, "ppo_update", update_wrap), \
                patched(ppo_mod, "_ppo_loss", loss_wrap), \
                patched(runner.optimizer, "step", opt_wrap):
            for _ in range(self.traffic["check_iterations"]):
                cur = {}
                if not self.step():
                    raise RuntimeError("a check iteration's metrics are not finite")
                iters.append(to_cpu(self.gather(dict(
                    obs=cur["obs"], last_obs=cur["last_obs"], rew=torch.stack(cur["rew"]),
                    time_out=torch.stack(cur["time_out"]), dones=cur["dones"],
                    actions=cur["actions"], values=cur["values"], advantages=cur["advantages"],
                    loss=cur["loss"]))))
        self.records = dict(
            ranks=[[it[r] for it in iters] for r in range(self.world)] if self.rank == 0 else None,
            physics=to_cpu(self.gather(phys.stacked())),
            first_grad=to_cpu(check.split(first["grad"], self.prog_start)),
            first_loss=to_cpu(first["loss"]), after_first=to_cpu(first["after"]),
            start=to_cpu(self.prog_start),
            end=to_cpu({k: v.detach().clone() for k, v in net.named_parameters()}))
        self.num_obs, self.num_actions = env.num_obs, env.num_actions

    def release(self):
        del self.runner, self.env

    # ------------------------------------------------------------ reference
    def _ground(self, seed: int) -> Ground:
        t = self.config["terrain"]
        if t["mesh_type"] in ("heightfield", "trimesh"):
            return curriculum_ground(t, seed)
        return Ground.plane(friction=t["static_friction"])

    def candidate(self, kind: str) -> dict:
        """What is judged: the program's records (``program``), or the
        reference in its place in TF32 (``control``) or with a planted fault
        (``unchanged``, ``half``)."""
        if kind == "program":
            r = self.records
            pick = lambda key: [[rk[k][key] for rk in r["ranks"]] for k in range(len(r["ranks"][0]))]
            return dict(actions=pick("actions"), values=pick("values"),
                        advantages=pick("advantages"), loss=[i["loss"] for i in r["ranks"][0]],
                        first_loss=r["first_loss"], first_grad=r["first_grad"],
                        after_first=r["after_first"], start=r["start"], end=r["end"],
                        physics=r["physics"])
        with check.precision(kind == "control"):
            out = self._follow(None if kind == "control" else kind)
            out["physics"] = self._physics()
        return out

    def _physics(self) -> List[Dict[str, torch.Tensor]]:
        """The reference's control step on each rank's recorded rows, on that
        rank's heightfield (its env seed is offset by its rank)."""
        robot = Robot(self.path(self.config["robot"]))
        if not hasattr(self, "_grounds"):
            self._grounds = [self._ground(self.prog_seed + r) for r in range(self.world)]
        return [check.physics_outputs(ControlStep(robot, g, self.config), self._dev(rows))
                for g, rows in zip(self._grounds, self.records["physics"])]

    def _dev(self, tree):
        return {k: v.to(self.device) for k, v in tree.items()}

    def _follow(self, fault: Optional[str]) -> dict:
        p = PPOParams.from_config(self.config)
        # without the exchange each rank steps alone: rank 0's chain is the
        # single-card chain on its own data
        ranks = self.records["ranks"][:1] if fault == "exchange" else self.records["ranks"]
        return follow(p, ranks, self.num_obs, self.num_actions, self.prog_seed, self.device,
                      fault=None if fault == "exchange" else fault)

    def numbers(self, cand: dict) -> Dict[str, float]:
        if not hasattr(self, "_ref"):
            with check.precision(False):
                self._ref = self._follow(None)
                self._ref_phys = self._physics()
        out = check.train_numbers(cand, self._ref)
        out["state_gap"] = check.state_gap(
            *(check.stack_rows(x) for x in ([self._dev(c) for c in cand["physics"]],
                                            self._ref_phys,
                                            [self._dev(c) for c in self.records["physics"]])))
        return out

    # ------------------------------------------------------------ work
    def work(self) -> dict:
        """One iteration's work on this card."""
        from ..flops import control_step_bytes, control_step_flops, ppo_iteration_flops

        robot = Robot(self.path(self.config["robot"]))
        c, t = self.config, self.traffic
        T = c["runner"]["num_steps_per_env"]
        rough = c["terrain"]["mesh_type"] in ("heightfield", "trimesh")
        dec = c["control"]["decimation"]
        envs = t["num_envs"] // self.world          # this card's share
        env_steps = envs * T
        p = c["policy"]
        return dict(
            physics_env_steps=env_steps,
            physics_flops=env_steps * control_step_flops(robot.nb, robot.nj, robot.ng, robot.nf,
                                                         dec, rough),
            physics_bytes=env_steps * control_step_bytes(robot.nj, robot.ng, robot.nf, dec, rough),
            network_flops=ppo_iteration_flops(envs, T, c["algorithm"]["num_learning_epochs"],
                                              c["env"]["num_observations"],
                                              c["env"]["num_actions"], p["actor_hidden_dims"]))

    def trace_ranges(self):
        import extended_legged_gym_tpu_torch.rl.runner as runner_mod

        return [(self.runner, "_collect", "collect"), (runner_mod, "ppo_update", "update"),
                (self.env, "step", "env.step"), (self.env, "decimated_step", "physics_step")]


DRIVER = PPODriver
