"""The port's profiler ranges (``utils/tracing.py``): without a profiler a
span opens no range; under one, the control step, the rollout step and the
MPC solve emit their ``elg:`` spans nested and in call order; and the
profiler changes nothing that is computed."""
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from extended_legged_gym_tpu_torch.envs.legged_robot import LeggedRobot
from extended_legged_gym_tpu_torch.robots.anymal_c import anymal_c_flat_cfg, anymal_c_rough_cfg
from extended_legged_gym_tpu_torch.robots.anymal_c_traj import (AnymalCTrajGradSampling,
                                                               anymal_c_traj_sampling_cfg)
from extended_legged_gym_tpu_torch.utils import tracing
from extended_legged_gym_tpu_torch.utils.tracing import span
from extended_legged_gym_tpu_torch.utils.tree import tree_flatten

CKPT = "logs/flat_anymal_c/Aug21_12-38-39_r5_ft4/model_final.pkl"
E, NS, HS, HN, ND, POLISH = 2, 3, 3, 2, 2, 1
STEP_CHILDREN = ["env.physics", "env.derived", "env.commands", "env.termination", "env.reward",
                 "env.reset", "env.obs"]


def flat_env():
    c = anymal_c_flat_cfg()
    c.env.num_envs = 3
    return LeggedRobot(c, device="cpu")


def rough_env():
    c = anymal_c_rough_cfg()
    c.env.num_envs = 3
    c.terrain.num_rows = c.terrain.num_cols = 2
    c.terrain.terrain_length = c.terrain.terrain_width = 4.0
    c.terrain.border_size = 2.0
    return LeggedRobot(c, device="cpu")


def mpc_env():
    cfg = anymal_c_traj_sampling_cfg(E)
    to = cfg.trajectory_opt
    to.num_samples, to.horizon_samples, to.horizon_nodes = NS, HS, HN
    to.num_diffuse_steps, to.polish_iters, to.polish_method = ND, POLISH, "fd"
    cfg.rl_warmstart.policy_checkpoint = CKPT
    env = AnymalCTrajGradSampling(cfg, device="cpu")
    env.setup_rl_warmstart()
    return env


class Node:
    def __init__(self, name, start=0, end=0):
        self.name, self.start, self.end, self.children = name, start, end, []

    def names(self):
        return [c.name for c in self.children]

    def find(self, name):
        return [c for c in self.children if c.name == name]


def span_tree(prof) -> Node:
    """The ``elg:`` ranges of a finished CPU profile as a tree by their
    nesting in time (one thread), each node's children in the order they
    started; the root holds the outermost."""
    evs = sorted(((e.start_ns(), -e.duration_ns(), e.name()[len(tracing.PREFIX):])
                  for e in prof.profiler.kineto_results.events()
                  if e.name().startswith(tracing.PREFIX)))
    root = Node(None, evs[0][0] if evs else 0, max((s - d for s, d, _ in evs), default=0))
    stack = [root]
    for start, neg_dur, name in evs:
        while start >= stack[-1].end and len(stack) > 1:
            stack.pop()
        node = Node(name, start, start - neg_dur)
        stack[-1].children.append(node)
        stack.append(node)
    return root


def traced(fn):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    return out, span_tree(prof)


def leaves(tree):
    return tree_flatten(tree)[0]


def run_steps(env, n=3, seed=7):
    state = env.reset_all(seed)
    acts = torch.linspace(-0.5, 0.5, env.num_envs * env.num_actions).reshape(env.num_envs, -1)
    rews = []
    for i in range(n):
        state = env.step(state, acts * (i + 1))
        rews.append(state.rew)
    return state, rews


def run_mpc(env, seed=11):
    state = env.reset_all(seed)
    nodes = 0.1 * torch.randn(E, HN + 1, env.num_actions,
                              generator=torch.Generator().manual_seed(seed))
    return env.mpc_step(state, nodes, generator=torch.Generator().manual_seed(seed + 1))


def test_a_span_opens_no_range_without_a_profiler(monkeypatch):
    def refuse(*a, **kw):
        raise AssertionError("record_function called without a profiler")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", refuse)
    with span("x"):
        pass
    assert span("x") is span("x")
    run_steps(flat_env(), n=1)
    run_mpc(mpc_env())
    with pytest.raises(AssertionError):
        with profile(activities=[ProfilerActivity.CPU]):
            with span("x"):
                pass


def test_span_as_a_decorator_decides_per_call():
    @span("outer")
    def f(x):
        with span("inner"):
            return x + 1

    assert f(1) == 2 and f.__name__ == "f"
    out, tree = traced(lambda: f(2))
    assert out == 3
    assert tree.names() == ["outer"] and tree.children[0].names() == ["inner"]


@pytest.mark.parametrize("make,heights", [(flat_env, False), (rough_env, True)],
                         ids=["flat", "rough"])
def test_env_step_emits_its_phases_in_order(make, heights):
    env = make()
    state = env.reset_all(3)
    acts = torch.zeros(env.num_envs, env.num_actions)
    _, tree = traced(lambda: env.step(state, acts))
    assert tree.names() == ["env.step"]
    step = tree.children[0]
    assert step.names() == STEP_CHILDREN
    derived = step.find("env.derived")[0]
    assert derived.names() == (["env.heights"] if heights else [])


@pytest.fixture(scope="module")
def mpc_runs():
    """One MPC step from the same state and seeds without, then with the
    profiler: ``(plain, traced, span tree)``."""
    env = mpc_env()
    plain = run_mpc(env)
    out, tree = traced(lambda: run_mpc(env))
    return plain, out, tree


def test_mpc_step_emits_the_solve_nested(mpc_runs):
    tree = mpc_runs[2]
    assert tree.names() == ["mpc.step"]
    step = tree.children[0]
    assert step.names() == ["mpc.optimize", "env.step", "mpc.shift", "mpc.refresh"]
    assert step.find("env.step")[0].names() == STEP_CHILDREN
    opt = step.find("mpc.optimize")[0]
    assert opt.names() == ["mpc.diffuse"] * ND + ["mpc.polish"]
    for diffuse in opt.find("mpc.diffuse"):
        assert diffuse.names() == ["mpc.sample", "rollout", "mpc.update"]
        rollout = diffuse.find("rollout")[0]
        assert rollout.names() == ["rollout.step"] * (HS + 1)
        for rstep in rollout.children:
            assert rstep.names() == ["env.physics", "rollout.derived", "rollout.reward"]
    # the fd polish: the stencil's and the candidates' rollout batch per iteration
    polish = opt.find("mpc.polish")[0]
    assert polish.names() == ["rollout"] * (2 * POLISH)


def same(a, b):
    la, lb = leaves(a), leaves(b)
    return len(la) == len(lb) and all(torch.equal(x, y) for x, y in zip(la, lb))


def test_the_profiler_changes_nothing_computed(mpc_runs):
    env = flat_env()
    plain = run_steps(env)
    out, _ = traced(lambda: run_steps(env))
    assert same(out[0], plain[0]) and same(tuple(out[1]), tuple(plain[1]))
    # the MPC step's state, plan and solve info
    plain, out, _ = mpc_runs
    assert same(out, plain)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the fused physics kernel has no CPU build")
    return "cuda:0"


@pytest.mark.cuda
def test_the_kernel_route_spans_pack_launch_unpack(card):
    c = anymal_c_flat_cfg()
    c.env.num_envs = 8
    env = LeggedRobot(c, device=card)
    state = env.reset_all(3)
    acts = torch.zeros(env.num_envs, env.num_actions, device=card)
    env.step(state, acts)
    _, tree = traced(lambda: env.step(state, acts))
    physics = tree.children[0].find("env.physics")[0]
    assert physics.names() == ["physics.pack", "physics.launch", "physics.unpack"]
