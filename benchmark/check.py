"""The comparison that decides ``correct``: the numbers a run's check reads,
each a gap between what the program produced and what the plain reference
(``reference/``) works out from the same inputs, and their limits.

The same numbers can be read for a candidate other than the program: the
reference itself in a lower precision (the control) or with a planted fault;
``calibrate.py`` reads them so on the chip to set the limits."""
from __future__ import annotations

import contextlib
import json
import os
from typing import Dict, List, Optional

import torch

from .reference.physics import STATE_KEYS, ControlStep

OUT_FIELDS = ("tau", "geom_forces", "foot_pos", "foot_vel")


@contextlib.contextmanager
def precision(tf32: bool):
    """Matrix products in TF32 (``tf32``) or in full float32 for the block."""
    old = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = tf32
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = old


def rms(x: torch.Tensor) -> float:
    return float(torch.sqrt(torch.mean(torch.square(x.double()))))


def rel_gap(cand: torch.Tensor, ref: torch.Tensor) -> float:
    """The widest gap of ``cand`` from ``ref``, over the root mean square of
    ``ref`` (0 where both are 0)."""
    d = (float((cand.to(ref.device).double() - ref.double()).abs().max())
         if ref.numel() else 0.0)
    scale = rms(ref) if ref.numel() else 0.0
    return d / scale if scale > 0 else (0.0 if d == 0 else float("inf"))


def quantile(x: torch.Tensor, q: float) -> float:
    return float(torch.quantile(x.double(), q))


# ---------------------------------------------------------------- physics
def physics_outputs(step: ControlStep, rec: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """The reference's control step from the program's recorded inputs."""
    s = {k: rec["in." + k] for k in STATE_KEYS}
    new, tau, gf, fp, fv = step(s, rec["actions"], rec["friction"], rec["mass_delta"])
    out = {"out." + k: v for k, v in new.items()}
    out.update(tau=tau, geom_forces=gf, foot_pos=fp, foot_vel=fv)
    return out


def row_gaps(cand: Dict[str, torch.Tensor], ref: Dict[str, torch.Tensor],
             rec: Dict[str, torch.Tensor]) -> torch.Tensor:
    """Each recorded row's worst gap of the control step.  A state field's
    gap is measured against the root mean square of the reference's change
    over the step, an output's against that of the reference's output,
    field by field."""
    worst = None
    for k in STATE_KEYS:
        d_ref = ref["out." + k] - rec["in." + k]
        scale = max(rms(d_ref), 1e-12)
        g = (cand["out." + k] - ref["out." + k]).abs().reshape(d_ref.shape[0], -1).amax(1) / scale
        worst = g if worst is None else torch.maximum(worst, g)
    for k in OUT_FIELDS:
        scale = max(rms(ref[k]), 1e-12)
        g = (cand[k] - ref[k]).abs().reshape(ref[k].shape[0], -1).amax(1) / scale
        worst = torch.maximum(worst, g)
    return worst


def state_gap(cand, ref, rec, q: float = 0.9) -> float:
    """The ``q`` quantile over the recorded rows of :func:`row_gaps`: a few
    rows whose contacts switch on one side only do not decide it."""
    return quantile(row_gaps(cand, ref, rec), q)


def stack_rows(parts: List[Dict[str, torch.Tensor]]) -> Dict[str, torch.Tensor]:
    """The rows of several recordings (one per rank) as one."""
    return {k: torch.cat([p[k] for p in parts]) for k in parts[0]}


# ---------------------------------------------------------------- training
def leaf_gaps(cand: Dict[str, torch.Tensor], ref: Dict[str, torch.Tensor],
              keep: Optional[List[str]] = None) -> float:
    """The worst leaf's gap between the norms of ``cand`` and ``ref`` (not the
    norm of their difference), over the larger of the reference leaf's norm
    and the median leaf's."""
    names = keep if keep is not None else list(ref)
    norms_r = {k: float(torch.linalg.norm(ref[k].double())) for k in names}
    med = float(torch.tensor(sorted(norms_r.values())).median())
    worst = 0.0
    for k in names:
        n_c = float(torch.linalg.norm(cand[k].double()))
        worst = max(worst, abs(n_c - norms_r[k]) / max(norms_r[k], med, 1e-30))
    return worst


def split(flat: torch.Tensor, like: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    out, off = {}, 0
    for k, v in like.items():
        out[k] = flat[off:off + v.numel()].view_as(v)
        off += v.numel()
    return out


def train_numbers(cand: dict, ref: dict) -> Dict[str, float]:
    """``cand`` and ``ref`` as ``reference.ppo.follow`` returns them (the
    program's records in the same layout): per iteration and rank the
    actions, values and advantages, per iteration the mean loss, the first
    minibatch loss, the first gradient, the parameters after the first step
    and the parameters before and after, each a dict by parameter name.  A
    candidate with fewer ranks is compared on those it has.

    The ``first_`` numbers end at the first minibatch step (the first
    iteration's rollout, the first loss, the change of the first step):
    rounding has no steps there to grow over, as it has in the chain's
    numbers across the iterations."""
    def widest(key, iters=None):
        return max(rel_gap(a, b) for ca, ra in list(zip(cand[key], ref[key]))[:iters]
                   for a, b in zip(ca, ra))

    def loss_gap(a, b):
        return abs(float(a) - float(b)) / max(abs(float(b)), 1e-30)

    pol = max(widest("actions"), widest("values"))
    gae = widest("advantages")
    loss = max(loss_gap(a, b) for a, b in zip(cand["loss"], ref["loss"]))
    g_ref = {k: v.cpu() for k, v in ref["first_grad"].items()}
    g_cand = {k: v.cpu() for k, v in cand["first_grad"].items()}
    grad = leaf_gaps(g_cand, g_ref)
    # leaves whose reference gradient is nought to rounding move by
    # round-off alone: left out of the change by a rule on that gradient
    g_norm = {k: float(torch.linalg.norm(v.double())) for k, v in g_ref.items()}
    med = float(torch.tensor(sorted(g_norm.values())).median())
    moving = [k for k in g_ref if g_norm[k] >= 1e-3 * med]
    d_ref = {k: (ref["end"][k] - ref["start"][k]).cpu() for k in moving}
    d_cand = {k: (cand["end"][k] - cand["start"][k]).cpu() for k in moving}
    change = leaf_gaps(d_cand, d_ref)
    d1_ref = {k: (ref["after_first"][k] - ref["start"][k]).cpu() for k in moving}
    d1_cand = {k: (cand["after_first"][k] - cand["start"][k]).cpu() for k in moving}
    return dict(policy_gap=pol, gae_gap=gae, loss_gap=loss, grad_gap=grad, change_gap=change,
                first_policy_gap=max(widest("actions", 1), widest("values", 1)),
                first_gae_gap=widest("advantages", 1),
                first_loss_gap=loss_gap(cand["first_loss"], ref["first_loss"]),
                first_change_gap=leaf_gaps(d1_cand, d1_ref))


# ---------------------------------------------------------------- limits
def load_limits(root: str, workload: str) -> Dict[str, float]:
    with open(os.path.join(root, "benchmark", "limits", workload + ".json")) as f:
        return {k: float(v) for k, v in json.load(f)["limits"].items()}


def judge(numbers: Dict[str, float], limits: Dict[str, float]) -> bool:
    """Correct where every number with a limit is finite and within it."""
    missing = set(limits) - set(numbers)
    if missing:
        raise KeyError(f"no reading for the limited numbers {sorted(missing)}")
    return all(numbers[k] == numbers[k] and numbers[k] <= limits[k] for k in limits)
