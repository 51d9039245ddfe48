"""The pose LM kernel (``csrc/pose_lm.cu``) against the plain
``optimize_pose_reference``.

On the CPU: the kernel's schedule, written out in PyTorch (``_schedule``:
the rows compacted, one pass a candidate that also gives the sums the next
iteration needs if it is accepted, the reclassification folded into the
next round's first pass), reaches the plain version's answers, so the
restructured loop is the same algorithm. The ``card`` tests (skipped
without CUDA) hold the kernel to the plain version on the card at the
localization cells' shapes (B = 384 x P = 8,192 and B = 256 x P = 16,384,
about 5-6 % of the slots matched), unbatched, and in the tracker's 4 x 10
LU form, each on a scene whose rows stay far from the 5.991 gate and on
one with many rows near it; check that two runs give the same bits and
that a stream's answer is the same bits in a batch and alone; and count
one launch a call. The scenes, the tolerances and the reasons for them are
``orb_slam_tracking_tpu_torch.utils.pose_lm_check``'s, which
``chip_smoke.py`` holds the kernel to as well. This file imports nothing
of JAX, so the card tests run on the card with
``python -m pytest --noconftest tests/test_torch_pose_lm_kernel.py``.
"""

from __future__ import annotations

import pytest
import torch

from orb_slam_tracking_tpu_torch.geometry import se3
from orb_slam_tracking_tpu_torch.optim import pose_opt
from orb_slam_tracking_tpu_torch.optim.lm import huber_weight, nielsen_update, solve_damped
from orb_slam_tracking_tpu_torch.utils.pose_lm_check import (
    GATE, NEAR_GATE_NOISE, STEP_KW, TRACKER_KW, check_close, rot_gap_deg, scene, to_device,
    tracker_scene)

NOISES = (0.25, NEAR_GATE_NOISE)  # inliers far from the gate, and many near it


def _schedule(R0, t0, pts, uv, inv_sigma2, valid, K, rounds, iters_per_round,
              coarse_delta_scale, batched_solve):
    """The kernel's loop for each stream, in PyTorch: the plain helpers on
    the compacted rows, one pass a candidate."""
    fx, fy, cx, cy = K[0, 0], K[1, 1], K[0, 2], K[1, 2]
    dev = R0.device
    out = []
    for b in range(R0.shape[0]):
        rows = valid[b].nonzero()[:, 0]
        X = (pts[b] if pts.dim() == 3 else pts)[rows]
        obs, w_obs = uv[b][rows], inv_sigma2[b][rows]

        def project(R, t):
            r, J, z = pose_opt._residuals_jac(R, t, X, obs, fx, fy, cx, cy)
            return r, J, z, (r * r).sum(-1) * w_obs

        def sums(R, t, active, huber, delta2):
            r, J, z, chi2 = project(R, t)
            rho = torch.where(chi2 <= delta2, chi2, 2.0 * torch.sqrt(delta2 * chi2) - delta2) \
                if huber else chi2
            w = huber_weight(chi2, delta2) if huber else torch.ones_like(chi2)
            w = torch.where(active, w * w_obs, 0.0)
            Jw = J * w[:, None, None]
            return (torch.einsum("nri,nrj->ij", Jw, J), torch.einsum("nri,nr->i", Jw, r),
                    torch.where(active, rho, 0.0).sum())

        R, t = R0[b], t0[b]
        active = torch.ones(len(rows), dtype=torch.bool, device=dev)
        for rnd in range(rounds):
            huber = rnd < 2
            delta2 = pose_opt._CHI2_TH * (coarse_delta_scale if rnd == 0 else 1.0)
            if rnd:
                _, _, z, chi2 = project(R, t)
                active = (chi2 <= GATE) & (z > 0)
            H, g, cost = sums(R, t, active, huber, delta2)
            lam, nu = torch.tensor(1e-4, device=dev), torch.tensor(2.0, device=dev)
            for _ in range(iters_per_round):
                dx = solve_damped(H, -g, lam, batched=batched_solve)
                dR, dt = se3.se3_exp(dx)
                Rn, tn = dR @ R, dR @ t + dt
                Hn, gn, cn = sums(Rn, tn, active, huber, delta2)
                pred = 0.5 * torch.dot(dx, lam * torch.diagonal(H) * dx - g)
                lam, nu = nielsen_update(lam, nu, (cost - cn) / pred.abs().clamp_min(1e-9))
                if cn < cost:
                    R, t, H, g, cost = Rn, tn, Hn, gn, cn
        _, _, z, chi2 = project(R, t)
        inl = (chi2 <= GATE) & (z > 0) if rounds else \
            torch.ones(len(rows), dtype=torch.bool, device=dev)
        mask = torch.zeros(valid.shape[-1], dtype=torch.bool, device=dev)
        mask[rows] = inl
        out.append((R, t, mask, inl.sum(dtype=torch.int32), torch.where(inl, chi2, 0.0).sum()))
    return pose_opt.PoseOptResult(*(torch.stack(x) for x in zip(*out)))


@pytest.mark.parametrize("batched_solve,rounds,iters,shared,noise", [
    (True, 2, 6, False, 0.25), (False, 4, 10, True, 0.25), (False, 2, 6, False, 0.25),
    (True, 2, 6, False, NEAR_GATE_NOISE)])
def test_kernel_schedule_is_the_plain_algorithm(batched_solve, rounds, iters, shared, noise):
    """The kernel's restructured loop, written out in PyTorch on the CPU,
    reaches the plain version's answers within the card tolerances."""
    args = tuple(torch.from_numpy(a) for a in scene(3, 16, 400, 0.4, shared_pts=shared,
                                                    noise=noise))
    kw = dict(rounds=rounds, iters_per_round=iters, coarse_delta_scale=25.0,
              batched_solve=batched_solve)
    ref = pose_opt.optimize_pose(*args, **kw)
    got = _schedule(*args, **kw)
    check_close(got, ref, args, near_gate=noise == NEAR_GATE_NOISE)
    assert int(ref.n_inliers.min()) > 50
    assert float(rot_gap_deg(ref.R, args[0]).min()) > 0.5  # the LM did move the poses


def test_wrapper_takes_the_plain_version_on_the_cpu():
    args = tuple(torch.from_numpy(a) for a in scene(5, 2, 200, 0.4))
    got = pose_opt.optimize_pose(*args, rounds=2, iters_per_round=6)
    ref = pose_opt.optimize_pose_reference(*args, rounds=2, iters_per_round=6)
    for a, b in zip(got, ref):
        assert torch.equal(a, b)
    assert pose_opt.optimize_pose.launches == 0


# ---------------------------------------------------------------------- card
def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.card
@pytest.mark.parametrize("noise", NOISES)
@pytest.mark.parametrize("B,P,share,seed", [(384, 8192, 0.05, 11), (256, 16384, 0.064, 12)])
def test_card_kernel_matches_plain_at_the_cells_shapes(B, P, share, seed, noise):
    dev = _card()
    args = to_device(scene(seed, B, P, share, noise=noise), dev)
    kw = dict(STEP_KW, batched_solve=True)
    ref = pose_opt.optimize_pose_reference(*args, **kw)
    before = pose_opt.optimize_pose.launches
    got = pose_opt.optimize_pose(*args, **kw)
    torch.cuda.synchronize()
    assert pose_opt.optimize_pose.launches == before + 1
    check_close(got, ref, args, f"B {B} P {P} noise {noise}",
                near_gate=noise == NEAR_GATE_NOISE)


@pytest.mark.card
@pytest.mark.parametrize("noise", NOISES)
@pytest.mark.parametrize("batched_solve", [False, True])
def test_card_kernel_matches_plain_unbatched(batched_solve, noise):
    """The single-stream step's calls (LU) and the DP step's (closed form)."""
    dev = _card()
    args = to_device(scene(21, 1, 8192, 0.06, noise=noise), dev, batch=False)
    assert args[0].shape == (3, 3) and args[3].shape == (8192, 2)
    kw = dict(STEP_KW, batched_solve=batched_solve)
    ref = pose_opt.optimize_pose_reference(*args, **kw)
    got = pose_opt.optimize_pose(*args, **kw)
    assert got.R.shape == (3, 3) and got.inlier.shape == (8192,) and got.n_inliers.shape == ()
    check_close(got, ref, args, near_gate=noise == NEAR_GATE_NOISE)


@pytest.mark.card
@pytest.mark.parametrize("noise", NOISES)
def test_card_kernel_matches_plain_in_the_trackers_form(noise):
    """The tracker's calls: 4 rounds x 10 iterations, LU, a shared point
    array (its point capacity) with the matches at the front."""
    dev = _card()
    args = to_device(tracker_scene(31, noise), dev, batch=False)
    ref = pose_opt.optimize_pose_reference(*args, **TRACKER_KW)
    got = pose_opt.optimize_pose(*args, **TRACKER_KW)
    check_close(got, ref, args, near_gate=noise == NEAR_GATE_NOISE)


@pytest.mark.card
def test_card_same_bits_run_to_run_and_alone_as_in_a_batch():
    dev = _card()
    args = to_device(scene(41, 64, 8192, 0.05, noise=NEAR_GATE_NOISE), dev)
    kw = dict(STEP_KW, batched_solve=True)
    a = pose_opt.optimize_pose(*args, **kw)
    b = pose_opt.optimize_pose(*args, **kw)
    for x, y in zip(a, b):
        assert torch.equal(x, y)
    for s in (0, 17, 63):
        one = pose_opt.optimize_pose(*(x[s: s + 1] if i != 6 else x for i, x in enumerate(args)),
                                     **kw)
        for x, y in zip(one, a):
            assert torch.equal(x[0], y[s])
