"""Batched time-varying LQR (iLQR / Riccati) trajectory refinement (port of
``trajopt/riccati.py``).

1. roll the nominal controls through the differentiable dynamics,
2. linearize the dynamics ``f`` and the stage reward ``r`` around the nominal
   trajectory: every step's Jacobians in one call of ``step_fn`` in
   forward mode (``torch.autograd.forward_ad``) on a batch that repeats each
   (env, step) point once per input coordinate, each copy carrying one unit
   tangent, which gives what ``jax.jacfwd`` gives, column by column;
3. run the Riccati backward recursion for the affine feedback gains
   ``(k_t, K_t)`` with a Levenberg-Marquardt floor on ``Q_uu``,
4. forward-pass at every line-search step size in one batch; keep the best
   trajectory per env only where it improves (monotone).  The states the
   forward pass visits at the kept step size are the next iteration's
   nominal trajectory, so an iteration is one linearization and one line
   search (the JAX package rolls the kept controls out again: the same
   states, up to float32 rounding).

The JAX package solves one env and vmaps it; here ``step_fn`` is batched over
a leading axis (the env, or env x step x tangent copies) and every quantity
carries the env axis ``E`` explicitly.

State convention: iLQR works on a flat state vector.  Tree states (which mix
float dynamics with boolean contact flags) are adapted by
:func:`make_flattener`: bool leaves round-trip through ``> 0.5``, integer
leaves through round-and-cast, so their Jacobian rows and columns are zero
while they evolve exactly in the forward pass.
"""
from __future__ import annotations

from typing import Any, Callable, NamedTuple, Tuple

import torch
import torch.autograd.forward_ad as fwAD

from ..utils.tree import tree_flatten, tree_map


# ---------------------------------------------------------------------------
# tree <-> flat-vector adaptation
# ---------------------------------------------------------------------------

def make_flattener(template) -> Tuple[Callable, Callable, int]:
    """``(flatten, unflatten, dim)`` for a tree of tensors shaped like
    ``template`` (one env's leaves, no batch axis).

    ``flatten(tree) -> [..., dim]`` takes leaves with any leading batch axes
    (the same for all) and casts them to the first floating leaf's type
    (float32 for a tree without one); ``unflatten(vec [..., dim])`` restores
    the template's shapes, bool leaves as ``> 0.5``, integer leaves rounded,
    floating leaves in the vector's type."""
    leaves, rebuild = tree_flatten(template)
    shapes = [tuple(l.shape) for l in leaves]
    dtypes = [l.dtype for l in leaves]
    sizes = [int(torch.Size(s).numel()) for s in shapes]
    dim = sum(sizes)

    def flatten(tree):
        ls, _ = tree_flatten(tree)
        lead = ls[0].shape[:ls[0].dim() - len(shapes[0])]
        ft = next((l.dtype for l in ls if l.is_floating_point()), torch.float32)
        return torch.cat([l.reshape(*lead, -1).to(ft) for l in ls], -1)

    def unflatten(vec):
        lead = vec.shape[:-1]
        out = []
        for p, s, dt in zip(torch.split(vec, sizes, dim=-1), shapes, dtypes):
            a = p.reshape(*lead, *s)
            if dt == torch.bool:
                a = a > 0.5
            elif not dt.is_floating_point:
                a = torch.round(a).to(dt)
            out.append(a)
        return rebuild(out)

    return flatten, unflatten, dim


# ---------------------------------------------------------------------------
# core iLQR solve, batched over envs
# ---------------------------------------------------------------------------

class ILQRInfo(NamedTuple):
    J0: torch.Tensor          # [E] nominal total reward before refinement
    J: torch.Tensor           # [E] total reward after refinement
    improved: torch.Tensor    # [E] fraction of iterations that accepted a step


def _rows(ctx, idx):
    """The rows ``idx`` of every leaf of ``ctx`` (``None`` stays)."""
    return None if ctx is None else tree_map(lambda l: l[idx], ctx)


def _call(step_fn, x, u, ctx):
    return step_fn(x, u) if ctx is None else step_fn(x, u, ctx)


def _rollout(step_fn, x0, us, ctx=None):
    """Nominal rollout: xs ``[N, T+1, n]`` (x_0..x_T), rewards ``[N, T]``."""
    xs, rews, x = [x0], [], x0
    for t in range(us.shape[1]):
        x, r = _call(step_fn, x, us[:, t], ctx)
        xs.append(x)
        rews.append(r)
    return torch.stack(xs, 1), torch.stack(rews, 1)


def _tangent(y):
    t = fwAD.unpack_dual(y).tangent
    return torch.zeros_like(y) if t is None else t


def _linearize(step_fn, xs, us, hessian: str, prox_x: float, prox_u: float, ctx=None):
    """Per-step Jacobians of the dynamics and gradient (and curvature model)
    of the stage reward around the nominal trajectory ``xs`` ``[E, T+1, n]``,
    ``us`` ``[E, T, m]``: ``(fx [E,T,n,n], fu [E,T,n,m], rx [E,T,n],
    ru [E,T,m], rxx [E,T,n,n], rux [E,T,m,n], ruu [E,T,m,m])``.

    Dynamics second-order terms are dropped (standard iLQR).  ``"exact"``
    takes the reward's full Hessian (double backward; right for analytic
    dynamics); ``"proximal"`` a linear reward with the trust-region curvature
    ``rxx = -prox_x·I, ruu = -prox_u·I``, which makes the backward sweep the
    Riccati solve of the block-structured QP
    ``max Σ rxᵀδx + ruᵀδu - ½·prox_x‖δx‖² - ½·prox_u‖δu‖²  s.t.
    δx⁺ = fx·δx + fu·δu``."""
    E, T, m = us.shape
    n = xs.shape[-1]
    K = n + m
    x = xs[:, :-1].reshape(E * T, n)
    u = us.reshape(E * T, m)
    env = torch.arange(E, device=x.device).repeat_interleave(T)
    # copy k of each point carries the unit tangent e_k of (x, u)
    eye = torch.eye(K, dtype=x.dtype, device=x.device).repeat(E * T, 1)
    with fwAD.dual_level():
        xd = fwAD.make_dual(x.repeat_interleave(K, 0), eye[:, :n].contiguous())
        ud = fwAD.make_dual(u.repeat_interleave(K, 0), eye[:, n:].contiguous())
        xn, r = _call(step_fn, xd, ud, _rows(ctx, env.repeat_interleave(K)))
        jx = _tangent(xn).reshape(E, T, K, n).transpose(-1, -2)      # [E, T, n, K]
        jr = _tangent(r).reshape(E, T, K)
    fx, fu = jx[..., :n], jx[..., n:]
    rx, ru = jr[..., :n], jr[..., n:]
    if hessian == "exact":
        with torch.enable_grad():
            z = torch.cat([x, u], -1).detach().requires_grad_(True)
            rz = _call(step_fn, z[:, :n], z[:, n:], _rows(ctx, env))[1]
            g, = torch.autograd.grad(rz.sum(), z, create_graph=True)
            if g.requires_grad:
                H = torch.stack([torch.autograd.grad(g[:, k].sum(), z, retain_graph=True,
                                                     allow_unused=True)[0]
                                 if g[:, k].requires_grad else torch.zeros_like(z)
                                 for k in range(K)], 1)
            else:
                H = torch.zeros(E * T, K, K, dtype=z.dtype, device=z.device)
        H = H.detach().reshape(E, T, K, K)
        rxx, rux, ruu = H[..., :n, :n], H[..., n:, :n], H[..., n:, n:]
    else:
        rxx = (-prox_x * torch.eye(n, dtype=x.dtype, device=x.device)).expand(E, T, n, n)
        ruu = (-prox_u * torch.eye(m, dtype=x.dtype, device=x.device)).expand(E, T, m, m)
        rux = torch.zeros(E, T, m, n, dtype=x.dtype, device=x.device)
    return fx, fu, rx, ru, rxx, rux, ruu


def _backward(fx, fu, rx, ru, rxx, rux, ruu, reg):
    """Riccati recursion in *reward* (maximization) convention over the
    horizon, batched over envs: the value expansion
    ``V(x̂+δ) ≈ V + Vxᵀδ + ½δᵀVxxδ``, concave in u after the ``-reg·I``
    floor on ``Quu`` (``reg`` ``[E]``).  Returns ``ks [E,T,m], Ks [E,T,m,n]``."""
    E, T, n = fx.shape[0], fx.shape[1], fx.shape[2]
    m = fu.shape[3]
    I_m = torch.eye(m, dtype=fx.dtype, device=fx.device)
    tr = lambda a: a.transpose(-1, -2)
    mv = lambda M, v: (M @ v[..., None])[..., 0]
    Vx = torch.zeros(E, n, dtype=fx.dtype, device=fx.device)
    Vxx = torch.zeros(E, n, n, dtype=fx.dtype, device=fx.device)
    ks, Ks = [None] * T, [None] * T
    for t in range(T - 1, -1, -1):
        fx_t, fu_t = fx[:, t], fu[:, t]
        Qx = rx[:, t] + mv(tr(fx_t), Vx)
        Qu = ru[:, t] + mv(tr(fu_t), Vx)
        Qxx = rxx[:, t] + tr(fx_t) @ Vxx @ fx_t
        Qux = rux[:, t] + tr(fu_t) @ Vxx @ fx_t
        Quu = ruu[:, t] + tr(fu_t) @ Vxx @ fu_t
        Quu = 0.5 * (Quu + tr(Quu)) - reg[:, None, None] * I_m
        # maximize: k = -Quu⁻¹ Qu (Quu negative definite after the floor)
        k = -torch.linalg.solve(Quu, Qu)
        K = -torch.linalg.solve(Quu, Qux)
        Vx = Qx + mv(tr(K) @ Quu, k) + mv(tr(K), Qu) + mv(tr(Qux), k)
        Vxx = Qxx + tr(K) @ Quu @ K + tr(K) @ Qux + tr(Qux) @ K
        Vxx = 0.5 * (Vxx + tr(Vxx))
        ks[t], Ks[t] = k, K
    return torch.stack(ks, 1), torch.stack(Ks, 1)


def _forward(step_fn, x0, xs_nom, us_nom, ks, Ks, alpha, ctx=None):
    """Closed-loop forward pass at step sizes ``alpha`` ``[N]`` (one per
    batch row): ``(us [N, T, m], total reward [N], xs [N, T+1, n])``."""
    us, xs, total, x = [], [x0], 0.0, x0
    for t in range(us_nom.shape[1]):
        u = us_nom[:, t] + alpha[:, None] * ks[:, t] + (Ks[:, t] @ (x - xs_nom[:, t])[..., None])[..., 0]
        x, r = _call(step_fn, x, u, ctx)
        us.append(u)
        xs.append(x)
        total = total + r
    return torch.stack(us, 1), total, torch.stack(xs, 1)


def ilqr_solve_batched(step_fn: Callable, x0: torch.Tensor, us: torch.Tensor,
                       ctx: Any = None, n_iters: int = 1, reg_init: float = 1.0,
                       alphas: Tuple[float, ...] = (1.0, 0.5, 0.2, 0.05),
                       reg_min: float = 1e-4, reg_max: float = 1e4, u_clip: float = 0.0,
                       hessian: str = "proximal", prox_x: float = 0.1, prox_u: float = 1.0,
                       ) -> Tuple[torch.Tensor, ILQRInfo]:
    """Refine controls ``us`` ``[E, T, m]`` of E envs to maximize each env's
    total reward from ``x0`` ``[E, n]``.

    ``step_fn(x [N, n], u [N, m]) -> (x_next [N, n], reward [N])``, or
    ``step_fn(x, u, ctx_rows)`` when ``ctx`` (a tree of per-env tensors with
    a leading ``E`` axis, e.g. domain-randomized physics) is given: the
    solver passes the rows of the envs its batch rows belong to.  Each
    iteration line-searches ``alphas`` in one batch and keeps the nominal
    where nothing improves, raising that env's regularizer (the
    Levenberg-Marquardt dance); ``u_clip`` > 0 clamps the refined controls
    and scores the clamped ones."""
    E, T, m = us.shape
    A = len(alphas)
    xs, rews0 = _rollout(step_fn, x0, us, ctx)
    J0 = rews0.sum(1)
    J_c, us_c = J0, us
    reg = torch.full((E,), float(reg_init), dtype=us.dtype, device=us.device)
    alpha = torch.tensor(alphas, dtype=us.dtype, device=us.device).repeat_interleave(E)
    rows = torch.arange(E, device=us.device).repeat(A)          # alpha-major copies of the envs
    ctx_a = _rows(ctx, rows)
    accepted = []
    env = torch.arange(E, device=us.device)
    for _ in range(n_iters):
        lins = _linearize(step_fn, xs, us_c, hessian, prox_x, prox_u, ctx)
        ks, Ks = _backward(*lins, reg)
        us_all, J_all, xs_all = _forward(step_fn, x0[rows], xs[rows], us_c[rows], ks[rows],
                                         Ks[rows], alpha, ctx_a)
        if u_clip > 0.0:
            us_all = us_all.clamp(-u_clip, u_clip)
            xs_all, r = _rollout(step_fn, x0[rows], us_all, ctx_a)
            J_all = r.sum(1)
        J_all, us_all = J_all.reshape(A, E), us_all.reshape(A, E, T, m)
        best = torch.argmax(J_all, dim=0)
        J_best = J_all.gather(0, best[None])[0]
        improved = J_best > J_c
        us_c = torch.where(improved[:, None, None], us_all[best, env], us_c)
        xs = torch.where(improved[:, None, None], xs_all.reshape(A, E, T + 1, -1)[best, env], xs)
        J_c = torch.maximum(J_best, J_c)
        reg = torch.where(improved, (reg * 0.5).clamp(min=reg_min), (reg * 10.0).clamp(max=reg_max))
        accepted.append(improved)
    frac = (torch.stack(accepted).to(us.dtype).mean(0) if accepted
            else torch.full((E,), float("nan"), dtype=us.dtype, device=us.device))
    return us_c, ILQRInfo(J0=J0, J=J_c, improved=frac)


def ilqr_solve(step_fn: Callable, x0: torch.Tensor, us: torch.Tensor, **kw
               ) -> Tuple[torch.Tensor, ILQRInfo]:
    """:func:`ilqr_solve_batched` for one env: ``x0`` ``[n]``, ``us``
    ``[T, m]``; ``step_fn`` is still called on batches ``[N, ...]``."""
    us_opt, info = ilqr_solve_batched(step_fn, x0[None], us[None], **kw)
    return us_opt[0], ILQRInfo(*(v[0] for v in info))
