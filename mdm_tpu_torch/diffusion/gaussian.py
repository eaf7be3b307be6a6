"""Gaussian diffusion q/p algebra as plain functions on tensors.

Counterpart of mdm_tpu/diffusion/gaussian.py (:26-175, :209-214):
q_sample and q's moments, the posterior, the x0/eps/x_{t-1} conversions,
p_mean_variance with the inpainting hook for START_X / EPSILON prediction
under FIXED_SMALL / FIXED_LARGE variance, cond_fn guidance on the mean or
the score, and the per-sample reductions of the training losses. The
likelihood terms (:177-281) come with the training ``vb`` term.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from .schedule import MeanType, Schedule, VarType


def extract(table: torch.Tensor, t: torch.Tensor, ndim: int) -> torch.Tensor:
    """Gather per-sample coefficients and shape-broadcast: [T] x [B] -> [B,1,..]."""
    return table[t].reshape(t.shape + (1,) * (ndim - 1))


def mean_flat(x: torch.Tensor) -> torch.Tensor:
    """Mean over every axis but the first."""
    return x.mean(dim=tuple(range(1, x.dim())))


def sum_flat(x: torch.Tensor) -> torch.Tensor:
    """Sum over every axis but the first."""
    return x.sum(dim=tuple(range(1, x.dim())))


def q_mean_variance(sched: Schedule, x_start, t):
    """Mean, variance and log variance of q(x_t | x_0)."""
    nd = x_start.dim()
    mean = extract(sched.sqrt_alphas_cumprod, t, nd) * x_start
    variance = extract(1.0 - sched.alphas_cumprod, t, nd)
    log_variance = extract(sched.log_one_minus_alphas_cumprod, t, nd)
    return mean, variance, log_variance


def q_sample(sched: Schedule, x_start, t, noise):
    """Sample x_t ~ q(x_t | x_0)."""
    nd = x_start.dim()
    return (extract(sched.sqrt_alphas_cumprod, t, nd) * x_start
            + extract(sched.sqrt_one_minus_alphas_cumprod, t, nd) * noise)


def q_posterior_mean_variance(sched: Schedule, x_start, x_t, t):
    nd = x_t.dim()
    mean = (extract(sched.posterior_mean_coef1, t, nd) * x_start
            + extract(sched.posterior_mean_coef2, t, nd) * x_t)
    variance = extract(sched.posterior_variance, t, nd)
    log_variance = extract(sched.posterior_log_variance_clipped, t, nd)
    return mean, variance, log_variance


def predict_xstart_from_eps(sched: Schedule, x_t, t, eps):
    nd = x_t.dim()
    return (extract(sched.sqrt_recip_alphas_cumprod, t, nd) * x_t
            - extract(sched.sqrt_recipm1_alphas_cumprod, t, nd) * eps)


def predict_xstart_from_xprev(sched: Schedule, x_t, t, xprev):
    nd = x_t.dim()
    return (extract(1.0 / sched.posterior_mean_coef1, t, nd) * xprev
            - extract(sched.posterior_mean_coef2 / sched.posterior_mean_coef1, t, nd) * x_t)


def predict_eps_from_xstart(sched: Schedule, x_t, t, pred_xstart):
    nd = x_t.dim()
    return ((extract(sched.sqrt_recip_alphas_cumprod, t, nd) * x_t - pred_xstart)
            / extract(sched.sqrt_recipm1_alphas_cumprod, t, nd))


class PMeanVariance(NamedTuple):
    mean: torch.Tensor
    variance: torch.Tensor
    log_variance: torch.Tensor
    pred_xstart: torch.Tensor


def apply_inpainting(model_output, inpainting_mask, inpainted_motion):
    """Overwrite the x0 prediction inside the mask with ground truth
    (reference gaussian_diffusion.py:300-307; START_X prediction only)."""
    return torch.where(inpainting_mask, inpainted_motion, model_output)


def p_mean_variance(
    sched: Schedule,
    model_output: torch.Tensor,
    x: torch.Tensor,
    t: torch.Tensor,
    *,
    mean_type: MeanType = MeanType.START_X,
    var_type: VarType = VarType.FIXED_SMALL,
    clip_denoised: bool = False,
    inpainting_mask: Optional[torch.Tensor] = None,
    inpainted_motion: Optional[torch.Tensor] = None,
) -> PMeanVariance:
    """Turn a raw model output into (mean, var, pred_x0) of p(x_{t-1}|x_t)."""
    nd = x.dim()
    if inpainting_mask is not None and inpainted_motion is not None:
        if mean_type != MeanType.START_X:
            raise ValueError("inpainting requires START_X prediction")
        model_output = apply_inpainting(model_output, inpainting_mask, inpainted_motion)

    if var_type == VarType.FIXED_LARGE:
        model_variance = extract(sched.fixed_large_variance, t, nd)
        model_log_variance = extract(sched.log_fixed_large_variance, t, nd)
    else:  # FIXED_SMALL
        model_variance = extract(sched.posterior_variance, t, nd)
        model_log_variance = extract(sched.posterior_log_variance_clipped, t, nd)

    if mean_type == MeanType.START_X:
        pred_xstart = model_output
    else:  # EPSILON
        pred_xstart = predict_xstart_from_eps(sched, x, t, model_output)
    if clip_denoised:
        pred_xstart = pred_xstart.clamp(-1.0, 1.0)
    model_mean, _, _ = q_posterior_mean_variance(sched, pred_xstart, x, t)
    return PMeanVariance(model_mean, model_variance, model_log_variance, pred_xstart)


def condition_mean(cond_grad, out: PMeanVariance) -> torch.Tensor:
    """Sohl-Dickstein style mean shift: mean + var * grad(log p(y|x))."""
    return out.mean + out.variance * cond_grad


def condition_score(sched: Schedule, cond_grad, out: PMeanVariance, x, t) -> PMeanVariance:
    """Song et al. score conditioning: shift eps, re-derive x0 and the mean."""
    nd = x.dim()
    alpha_bar = extract(sched.alphas_cumprod, t, nd)
    eps = predict_eps_from_xstart(sched, x, t, out.pred_xstart)
    eps = eps - torch.sqrt(1.0 - alpha_bar) * cond_grad
    pred_xstart = predict_xstart_from_eps(sched, x, t, eps)
    mean, _, _ = q_posterior_mean_variance(sched, pred_xstart, x, t)
    return PMeanVariance(mean, out.variance, out.log_variance, pred_xstart)
