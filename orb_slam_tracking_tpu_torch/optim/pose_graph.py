"""Sim(3) pose-graph (essential-graph) optimization (counterpart of
``optim/pose_graph.py``, ORB-SLAM's ``OptimizeEssentialGraph``).

Vertices are a batched ``Sim3`` over the fixed keyframe slots with a
validity mask; edges are COO arrays ``(ei, ej, measurement, weight)``, a
zero weight marking padding. The per-edge residual is ``log(S_meas^-1 o
S_i o S_j^-1)`` under left increments ``S_k <- exp(x_k) o S_k``; each LM
step linearizes it at x = 0 with ``torch.func.jacfwd`` (the dense [7E, 7K]
Jacobian, as ``jax.jacfwd`` gives it: forward mode through the branch-free
``sim3_exp`` / ``sim3_log``, whose ``where``s carry the selected branch's
tangent only). Fixed and invalid vertices have their Jacobian columns
zeroed and their diagonal pinned, so their increment is exactly zero.

Every one of the ``iterations`` steps runs (Nielsen damping, a rejected
step keeps the estimate); the normal equations are solved by
``cholesky_ex`` + ``cholesky_solve``, which check nothing, so nothing here
reads on the host. A matrix that is not positive definite gives a
non-finite step, which the cost test rejects.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
from torch.func import jacfwd

from ..geometry.sim3 import Sim3, sim3_compose, sim3_exp, sim3_inverse, sim3_log
from .lm import nielsen_update

__all__ = ["PoseGraphResult", "optimize_pose_graph", "relative_sim3"]


class PoseGraphResult(NamedTuple):
    vertices: Sim3      # [K] optimized Siw
    cost0: torch.Tensor  # [] initial weighted chi2
    cost: torch.Tensor   # [] final weighted chi2


def relative_sim3(gi: Sim3, gj: Sim3) -> Sim3:
    """Edge measurement ``S_ij = S_i o S_j^-1`` from two vertex estimates."""
    return sim3_compose(gi, sim3_inverse(gj))


def _gather(g: Sim3, idx: torch.Tensor) -> Sim3:
    return Sim3(s=g.s[idx], R=g.R[idx], t=g.t[idx])


def _residuals(vertices: Sim3, meas_inv: Sim3, ei, ej) -> torch.Tensor:
    """[E, 7] per-edge log residuals."""
    gi, gj = _gather(vertices, ei), _gather(vertices, ej)
    return sim3_log(sim3_compose(meas_inv, sim3_compose(gi, sim3_inverse(gj))))


def _perturbed(base: Sim3, x: torch.Tensor) -> Sim3:
    """Left-multiplicative batched update ``exp(x_k) o base_k``."""
    return sim3_compose(sim3_exp(x), base)


def optimize_pose_graph(vertices: Sim3, v_valid: torch.Tensor, fixed: torch.Tensor,
                        ei: torch.Tensor, ej: torch.Tensor, meas: Sim3, e_w: torch.Tensor,
                        iterations: int = 20) -> PoseGraphResult:
    """LM over the Sim(3) pose graph. ``vertices`` [K] initial Siw,
    ``v_valid`` / ``fixed`` [K] bool (at least one fixed; invalid vertices
    are fixed too), edges ``ei, ej`` [E] int, measurements ``meas`` [E],
    weights ``e_w`` [E] scaling the whole 7-vector residual (0 = padding).
    """
    K = vertices.s.shape[0]
    E = ei.shape[0]
    dev = vertices.s.device
    ei, ej = ei.long(), ej.long()
    meas_inv = sim3_inverse(meas)
    frozen = fixed | ~v_valid
    col_free = (~frozen).repeat_interleave(7).to(torch.float32)        # [7K]
    sqrt_w = torch.sqrt(torch.clamp_min(e_w, 0.0))

    def weighted_resid_flat(x_flat, base):
        r = _residuals(_perturbed(base, x_flat.reshape(K, 7)), meas_inv, ei, ej)
        return (sqrt_w[:, None] * r).reshape(E * 7)

    def cost_of(base):
        r = _residuals(base, meas_inv, ei, ej)
        return (e_w[:, None] * r * r).sum()

    zero_x = torch.zeros(K * 7, dtype=torch.float32, device=dev)
    diag_pin = torch.where(col_free > 0, 0.0, 1.0)
    base = vertices
    lam = torch.tensor(1e-6, dtype=torch.float32, device=dev)
    nu = torch.tensor(2.0, dtype=torch.float32, device=dev)
    cost0 = cost = cost_of(vertices)
    for _ in range(iterations):
        r = weighted_resid_flat(zero_x, base)                                 # [7E]
        J = jacfwd(weighted_resid_flat)(zero_x, base) * col_free[None, :]     # [7E, 7K]
        H = J.T @ J
        b = J.T @ r
        dH = torch.diagonal(H)
        Hd = H + torch.diag(lam * dH + diag_pin + 1e-9)
        L = torch.linalg.cholesky_ex(Hd)[0]
        dx = -torch.cholesky_solve(b[:, None], L)[:, 0]
        cand = _perturbed(base, dx.reshape(K, 7))
        new_cost = cost_of(cand)
        pred = -torch.dot(dx, 0.5 * (b - lam * dH * dx))
        rho = (cost - new_cost) / torch.clamp_min(pred, 1e-12)
        good = (new_cost < cost) & torch.isfinite(new_cost)
        lam, nu = nielsen_update(lam, nu, torch.where(good, rho, -1.0))
        base = Sim3(*(torch.where(good, c, a) for a, c in zip(base, cand)))
        cost = torch.where(good, new_cost, cost)
    return PoseGraphResult(vertices=base, cost0=cost0, cost=cost)
