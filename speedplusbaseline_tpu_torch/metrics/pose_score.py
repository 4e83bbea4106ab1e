"""SPEED+ pose metrics, batched (counterpart of ``speedplusbaseline_tpu/
metrics/pose_score.py``; reference src/utils/metrics.py:30-67).

The reference's ``speed_score`` with ``applyThresh=False`` raises
UnboundLocalError (``speed_q`` is assigned only inside the threshold
branch, metrics.py:56-62). As the JAX package, this one implements the
intended semantics: ``speed = speed_t + speed_r`` with ``speed_r`` the
rotation error in radians, and with ``apply_thresh`` each term zeroed below
its threshold.
"""
from __future__ import annotations

import torch

# SPEED+ HIL thresholds (reference inference.py:91-92,195-196).
ROT_THRESH_DEG = 0.169  # [deg]
POS_THRESH = 0.002173  # [m/m]


def error_translation(t_pr, t_gt):
    """L2 translation error over the last axis (metrics.py:30-34)."""
    t_pr, t_gt = torch.as_tensor(t_pr), torch.as_tensor(t_gt)
    return torch.sqrt(torch.sum((t_gt - t_pr) ** 2, -1))


def error_orientation(q_pr, q_gt):
    """Angular error in degrees, 2*acos(|<q_pr, q_gt>|), the dot clamped at
    1 (metrics.py:36-43)."""
    q_pr, q_gt = torch.as_tensor(q_pr), torch.as_tensor(q_gt)
    qdot = torch.clamp(torch.abs(torch.sum(q_pr * q_gt, -1)), max=1.0)
    return torch.rad2deg(2.0 * torch.arccos(qdot))


def speed_score(t_pr, q_pr, t_gt, q_gt, apply_thresh: bool = True,
                rot_thresh: float = 0.5, pos_thresh: float = 0.005):
    """SPEED+ score = normalized translation error + rotation error [rad]
    (metrics.py:45-67, with the fixed ``applyThresh=False`` path).

    Returns:
        (speed, acc): the score(s) and the within-threshold indicator(s).
    """
    err_t = error_translation(t_pr, t_gt)
    err_q = error_orientation(q_pr, q_gt)  # [deg]
    t_gt = torch.as_tensor(t_gt)
    speed_t = err_t / torch.sqrt(torch.sum(t_gt ** 2, -1))
    speed_r = torch.deg2rad(err_q)
    if apply_thresh:
        speed_r = torch.where(err_q < rot_thresh, 0.0, speed_r)
        speed_t_scored = torch.where(speed_t < pos_thresh, 0.0, speed_t)
    else:
        speed_t_scored = speed_t
    acc = ((err_q < rot_thresh) & (speed_t < pos_thresh)).float()
    return speed_t_scored + speed_r, acc


def speed_score_batched(t_pr, q_pr, t_gt, q_gt):
    """Raw and HIL-thresholded scores in one call (the eval hot path): a dict
    of err_q [deg], err_t [m], speed_raw, speed_mod and acc, the per-image
    quantities of the reference's valid_krn (inference.py:88-92)."""
    speed_raw, _ = speed_score(t_pr, q_pr, t_gt, q_gt, apply_thresh=False)
    speed_mod, acc = speed_score(t_pr, q_pr, t_gt, q_gt, apply_thresh=True,
                                 rot_thresh=ROT_THRESH_DEG, pos_thresh=POS_THRESH)
    return {"err_q": error_orientation(q_pr, q_gt), "err_t": error_translation(t_pr, t_gt),
            "speed_raw": speed_raw, "speed_mod": speed_mod, "acc": acc}
