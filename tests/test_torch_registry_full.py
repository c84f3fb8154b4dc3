"""The port's task registry is the JAX package's: the same 59 names, the same
env classes (by name), every env and train config equal field by field
(tests/torch_family.assert_cfg_equal), and each of the 17 tasks the last
slice adds builds and steps with finite observations and rewards at two
envs (the generated terrains cut to 2 x 2 grids of 4 m)."""
import pytest
import torch

from extended_legged_gym_tpu.robots import task_registry as jtask_registry
from extended_legged_gym_tpu_torch.envs.pose_adapt import BasePoseAdapt
from extended_legged_gym_tpu_torch.utils.task_registry import task_registry
from torch_family import assert_cfg_equal
from torch_parity import one_torch_thread  # noqa: F401 (autouse)

NEW_TASKS = ("anymal_c_base_pose_adapt", "anymal_c_base_pose_ctrl", "el_mini_base_pose_adapt",
             "el_mini_base_pose_ctrl", "anymal_c_batch_rollout", "anymal_c_batch_rollout_flat",
             "go2_batch_rollout", "go2_batch_rollout_flat", "elspider_air_batch_rollout",
             "elspider_air_batch_rollout_flat", "anymal_c_dialmpc_flat", "go2_dialmpc_flat",
             "elspider_air_dialmpc", "elspider_air_dialmpc_flat", "go2_traj_grad_sampling",
             "cassie_traj_grad_sampling", "elspider_air_traj_grad_sampling")


def test_registry_names_and_classes_equal_jax():
    assert len(NEW_TASKS) == 17
    assert sorted(task_registry.task_classes) == sorted(jtask_registry.task_classes)
    assert len(task_registry.task_classes) == 59
    for name, cls in task_registry.task_classes.items():
        assert cls.__name__ == jtask_registry.task_classes[name].__name__, name


@pytest.mark.parametrize("task", sorted(jtask_registry.task_classes))
def test_configs_equal_jax(task):
    (cfg, tc), (jcfg, jtc) = task_registry.get_cfgs(task), jtask_registry.get_cfgs(task)
    assert_cfg_equal(cfg, jcfg)
    assert (tc is None) == (jtc is None), task
    if tc is not None:
        assert_cfg_equal(tc, jtc)


@pytest.mark.parametrize("task", NEW_TASKS)
def test_new_task_builds_and_steps(task):
    cfg, _ = task_registry.get_cfgs(task)
    cfg.env.num_envs = 2
    if not issubclass(task_registry.task_classes[task], BasePoseAdapt):
        cfg.terrain.num_rows = cfg.terrain.num_cols = 2
        cfg.terrain.terrain_length = cfg.terrain.terrain_width = 4.0
    env, _ = task_registry.make_env(task, env_cfg=cfg, device="cpu")
    s = env.reset_all(seed=0)
    for _ in range(2):
        s = env.step(s, torch.zeros(2, env.num_actions))
    assert s.obs.shape == (2, env.num_obs)
    assert bool(torch.isfinite(s.obs).all()) and bool(torch.isfinite(s.rew).all()), task


def test_elspider_batch_rollout_tasks_keep_the_plain_env_as_in_jax():
    """The JAX package registers elspider_air_batch_rollout(_flat) with the
    plain ElSpider env, which has no rollout_batch (ROADMAP queue 3); the
    port registers the same class, so neither can play a rollout batch."""
    for task in ("elspider_air_batch_rollout", "elspider_air_batch_rollout_flat"):
        assert jtask_registry.task_classes[task].__name__ == "ElSpider"
        assert not hasattr(jtask_registry.task_classes[task], "rollout_batch")
        assert not hasattr(task_registry.task_classes[task], "rollout_batch")
