"""Supervised terrain-estimator training (port of
``rl/terrain_estimator_runner.py``).

One iteration steps the env ``num_steps_per_env`` control steps.  Each step
renders the depth camera (``perception/depth_camera.py``), casts the ground
truth rays (``perception/raycast.py``), reads the 9-dim proprioception
(body-frame linear and angular velocity, projected gravity), and steps the
env with the driving policy's actions or ``0.3 * N(0, 1)``.  Then one Adam
step (optax's ``adam``, no clipping) on the window's loss: back-propagation
through the GRU over the whole window from the zero carry, the carry zeroed
after a step whose env reset, MSE / Huber / L1 against the true distances.
The frame buffer of the "stack" and "hist_mlp" encoders restarts from zeros
every iteration, as does the carry.  ``learn`` resets the env at each call,
as the JAX runner's does.

Checkpoints are the JAX runner's pickle, ``{"params": <flax tree of numpy
arrays>}``, read and written both ways.  It runs in one process: the JAX
package shards no estimator training, so it has no data-parallel form
(``OnPolicyRunner`` has one).
"""
from __future__ import annotations

import math
import os
import pickle
import time
from typing import Callable, Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F

from ..envs.legged_robot import EnvState, LeggedRobot
from ..models.networks import read_checkpoint
from ..models.terrain_estimator import (TerrainEstimator, estimator_params_from_jax,
                                        estimator_params_to_jax)
from ..perception.depth_camera import DepthCameraRaycast
from ..perception.raycast import RayCaster
from ..utils.math import quat_rotate, yaw_quat
from ..utils.metrics import MetricsWriter
from .ppo import Adam

PROPRIO_DIM = 9
RANDOM_ACTION_STD = 0.3


class TerrainEstimatorRunner:
    def __init__(self, env: LeggedRobot, log_dir: Optional[str] = None,
                 learning_rate: float = 1e-3, loss_type: str = "mse",
                 num_steps_per_env: int = 24, seed: int = 0,
                 policy: Optional[Callable[[torch.Tensor], torch.Tensor]] = None):
        """``policy``: the driving policy obs -> actions; random actions
        without one."""
        if not env.cfg.raycaster.enable_raycast:
            raise ValueError("terrain-estimator training needs raycast ground truth "
                             "(cfg.raycaster.enable_raycast)")
        self.env = env
        self.device = env.device
        self.writer = MetricsWriter(log_dir) if log_dir else None
        self.loss_type = loss_type
        self.num_steps_per_env = num_steps_per_env
        self.policy = policy
        self.learning_rate = learning_rate

        dcfg = env.cfg.depth
        self.camera = DepthCameraRaycast(dcfg, env.num_envs, env.terrain, device=self.device)
        self.raycaster = RayCaster(env.cfg.raycaster, env.terrain, device=self.device)
        self.encoder_name = dcfg.encoder
        self.buffered = self.encoder_name in ("stack", "hist_mlp")
        T, H, W = int(dcfg.buffer_len), dcfg.resized[1], dcfg.resized[0]
        # the initialisation draws on the CPU: a seed gives the same network on
        # every device
        self.network = TerrainEstimator(
            num_raycast=self.raycaster.num_rays, proprio_dim=PROPRIO_DIM, in_hw=(H, W),
            encoder=self.encoder_name, buffer_len=T,
            generator=torch.Generator().manual_seed(seed)).to(self.device)
        self.optimizer = Adam(self.network.parameters(), max_grad_norm=math.inf)
        self._ok = torch.ones((), dtype=torch.bool, device=self.device)
        self.depth_buf0 = (torch.zeros(env.num_envs, T, H, W, device=self.device)
                           if self.buffered else None)
        self.carry0 = self.network.initialize_carry((env.num_envs,), self.device)
        self.generator = torch.Generator(device=self.device).manual_seed(seed)

    # ------------------------------------------------------------------
    def _proprio(self, state: EnvState) -> torch.Tensor:
        return torch.cat([state.base_lin_vel, state.base_ang_vel, state.projected_gravity],
                         dim=-1)

    def _draw_action_noise(self, shape) -> torch.Tensor:
        """Standard normal draws for the random actions (scaled by 0.3)."""
        return torch.randn(shape, generator=self.generator, device=self.device)

    def _actions(self, state: EnvState, noise: Optional[torch.Tensor]) -> torch.Tensor:
        if self.policy is not None:
            return self.policy(state.obs)
        if noise is None:
            noise = self._draw_action_noise((self.env.num_envs, self.env.num_actions))
        return RANDOM_ACTION_STD * noise

    def _observe(self, state: EnvState, buf: Optional[torch.Tensor]):
        """The estimator's inputs and the ground truth at ``state``:
        ``(depth, buf, proprio, true distances)``; ``depth`` is the frame, or
        the updated buffer for the buffered encoders."""
        pos, quat = state.phys.base_pos, state.phys.base_quat
        frame = self.camera.render(pos, quat)
        if self.buffered:
            buf = self.camera.push(buf, frame)
        depth = buf if self.buffered else frame
        return depth, buf, self._proprio(state), self.raycaster.cast(pos, quat).distance

    def _loss(self, pred: torch.Tensor, gt: torch.Tensor) -> torch.Tensor:
        if self.loss_type == "huber":
            return F.huber_loss(pred, gt, delta=1.0)
        if self.loss_type == "l1":
            return torch.abs(pred - gt).mean()
        return torch.square(pred - gt).mean()

    def collect_and_update(self, env_state: EnvState,
                           action_noise: Optional[torch.Tensor] = None
                           ) -> Tuple[EnvState, torch.Tensor]:
        """One iteration (the JAX ``_collect_and_update``): ``(env_state,
        loss)``, the loss a device scalar.  ``action_noise`` [T, B, A]
        (standard normal) replaces the runner's draws of random actions."""
        rows: Dict[str, List[torch.Tensor]] = {"depth": [], "proprio": [], "gt": [], "done": []}
        buf = self.depth_buf0
        t0 = time.perf_counter()
        with torch.no_grad():
            for t in range(self.num_steps_per_env):
                depth, buf, proprio, gt = self._observe(env_state, buf)
                noise = None if action_noise is None else action_noise[t]
                actions = self._actions(env_state, noise)
                env_state = self.env.step(env_state, actions)
                for k, v in (("depth", depth), ("proprio", proprio), ("gt", gt),
                             ("done", env_state.reset_buf)):
                    rows[k].append(v)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        t1 = time.perf_counter()
        depths, proprios, gts, dones = (torch.stack(rows[k]) for k in ("depth", "proprio", "gt",
                                                                       "done"))
        preds = self.network.predict_sequence(depths, proprios, dones, self.carry0)
        # the mean over steps of each step's loss
        loss = torch.stack([self._loss(preds[t], gts[t]) for t in range(len(gts))]).mean()
        grads = torch.autograd.grad(loss, self.optimizer.params)
        self.optimizer.step(grads, self.learning_rate, self._ok)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.last_times = dict(collection_s=t1 - t0, update_s=time.perf_counter() - t1)
        return env_state, loss.detach()

    # ------------------------------------------------------------------
    def learn(self, num_iterations: int, log_interval: int = 10) -> Dict[str, float]:
        env_state = self.env.reset_all()
        last: Dict[str, float] = {}
        for it in range(num_iterations):
            t0 = time.perf_counter()
            env_state, loss = self.collect_and_update(env_state)
            last = dict(loss=loss.item(), iter_time=time.perf_counter() - t0, **self.last_times)
            if self.writer:
                self.writer.write(it, last)
            if it % log_interval == 0:
                print(f"terrain-est it {it}: loss {last['loss']:.5f}", flush=True)
        if self.writer:
            self.writer.close()
        return last

    def save(self, path: str):
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        with open(path, "wb") as f:
            pickle.dump(dict(params=estimator_params_to_jax(self.network)), f, protocol=4)

    def load(self, path: str):
        estimator_params_from_jax(self.network, read_checkpoint(path)["params"])

    def get_estimator(self):
        """``(depth, proprio, carry) -> (distances, carry)``; it reads the
        network's parameters when called."""
        net = self.network

        @torch.no_grad()
        def estimate(depth, proprio, carry):
            return net(depth, proprio, carry)

        return estimate

    # ------------------------------------------------------------------
    @torch.no_grad()
    def play(self, num_steps: int = 200, log_interval: int = 100) -> Dict[str, float]:
        """Inference loop (reference play mode, headless): step the env with
        the driving policy or random actions, predict the ray distances from
        depth and proprioception and score them against the true ones."""
        env = self.env
        estimate = self.get_estimator()
        env_state = env.reset_all()
        carry, buf = self.carry0, self.depth_buf0
        mses, maes = [], []
        for it in range(num_steps):
            depth, buf, proprio, gt = self._observe(env_state, buf)
            pred, carry = estimate(depth, proprio, carry)
            mses.append(torch.mean(torch.square(pred - gt)))
            maes.append(torch.mean(torch.abs(pred - gt)))
            if it % log_interval == 0:
                print(f"terrain-est play step {it}: MSE={mses[-1].item():.4f} "
                      f"MAE={maes[-1].item():.4f}", flush=True)
            env_state = env.step(env_state, self._actions(env_state, None))
            carry = torch.where(env_state.reset_buf[:, None], torch.zeros_like(carry), carry)
        mse, mae = torch.stack(mses).tolist(), torch.stack(maes).tolist()
        stats = dict(mse=sum(mse) / len(mse), mae=sum(mae) / len(mae), mse_last=mse[-1],
                     mae_last=mae[-1])
        if self.writer:
            self.writer.write(0, {f"play_{k}": v for k, v in stats.items()})
        return stats

    def predictions_to_points(self, distances: torch.Tensor, base_pos: torch.Tensor,
                              base_quat: torch.Tensor) -> torch.Tensor:
        """Predicted distances [B, R] -> world points [B, R, 3] along the
        sensor's rays."""
        rc = self.raycaster
        q = yaw_quat(base_quat) if rc.cfg.attach_yaw_only else base_quat
        origins = base_pos[:, None, :] + quat_rotate(q[:, None, :], rc.ray_starts[None])
        dirs = quat_rotate(q[:, None, :], rc.ray_dirs[None])
        return origins + distances[..., None] * dirs
