"""Gaussian diffusion q/p algebra as plain functions on tensors.

Counterpart of mdm_tpu/diffusion/gaussian.py (:26-175, :209-214):
q_sample and q's moments, the posterior, the x0/eps/x_{t-1} conversions,
p_mean_variance with the inpainting hook for START_X / EPSILON prediction
under fixed or learned variance, cond_fn guidance on the mean or the
score, the per-sample reductions of the training losses, and the
likelihood terms (:177-272): the KL and the discretised decoder NLL of the
training ``vb`` term, the prior's bits and ``calc_bpd_loop``.
"""
from __future__ import annotations

import math
from typing import Callable, NamedTuple, Optional

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
    model_var_values: Optional[torch.Tensor] = None,
    inpainting_mask: Optional[torch.Tensor] = None,
    inpainted_motion: Optional[torch.Tensor] = None,
) -> PMeanVariance:
    """Turn a raw model output into (mean, var, pred_x0) of p(x_{t-1}|x_t).
    ``model_var_values``: the model's variance channels, for LEARNED (the
    log variance) and LEARNED_RANGE (in [-1, 1] between the clipped
    posterior log variance and log beta)."""
    nd = x.dim()
    if inpainting_mask is not None and inpainted_motion is not None:
        if mean_type != MeanType.START_X:
            raise ValueError("inpainting requires START_X prediction")
        model_output = apply_inpainting(model_output, inpainting_mask, inpainted_motion)

    if var_type in (VarType.LEARNED, VarType.LEARNED_RANGE):
        if model_var_values is None:
            raise ValueError(f"{var_type} needs the model's variance channels")
        if var_type == VarType.LEARNED:
            model_log_variance = model_var_values
        else:
            min_log = extract(sched.posterior_log_variance_clipped, t, nd)
            max_log = extract(sched.log_betas, t, nd)
            frac = (model_var_values + 1) / 2
            model_log_variance = frac * max_log + (1 - frac) * min_log
        model_variance = torch.exp(model_log_variance)
    elif var_type == VarType.FIXED_LARGE:
        model_variance = extract(sched.fixed_large_variance, t, nd)
        model_log_variance = extract(sched.log_fixed_large_variance, t, nd)
    else:  # FIXED_SMALL
        model_variance = extract(sched.posterior_variance, t, nd)
        model_log_variance = extract(sched.posterior_log_variance_clipped, t, nd)

    clip = (lambda x0: x0.clamp(-1.0, 1.0)) if clip_denoised else (lambda x0: x0)
    if mean_type == MeanType.PREVIOUS_X:
        pred_xstart = clip(predict_xstart_from_xprev(sched, x, t, model_output))
        return PMeanVariance(model_output, model_variance, model_log_variance, pred_xstart)
    if mean_type == MeanType.START_X:
        pred_xstart = clip(model_output)
    else:  # EPSILON
        pred_xstart = clip(predict_xstart_from_eps(sched, x, t, model_output))
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


# ---------------------------------------------------------------------------
# Likelihood terms (mdm_tpu/diffusion/gaussian.py:177-272; MDM's default
# configuration trains without them).
# ---------------------------------------------------------------------------

def normal_kl(mean1, logvar1, mean2, logvar2):
    """KL(N(mean1, e^logvar1) || N(mean2, e^logvar2)), elementwise."""
    return 0.5 * (-1.0 + logvar2 - logvar1 + torch.exp(logvar1 - logvar2)
                  + ((mean1 - mean2) ** 2) * torch.exp(-logvar2))


def approx_standard_normal_cdf(x):
    return 0.5 * (1.0 + torch.tanh(math.sqrt(2.0 / math.pi) * (x + 0.044715 * x ** 3)))


def discretized_gaussian_log_likelihood(x, *, means, log_scales):
    """Log-likelihood of x under a Gaussian discretised to 255 bins of [-1, 1]."""
    centered_x = x - means
    inv_stdv = torch.exp(-log_scales)
    cdf_plus = approx_standard_normal_cdf(inv_stdv * (centered_x + 1.0 / 255.0))
    cdf_min = approx_standard_normal_cdf(inv_stdv * (centered_x - 1.0 / 255.0))
    log_cdf_plus = torch.log(cdf_plus.clamp(min=1e-12))
    log_one_minus_cdf_min = torch.log((1.0 - cdf_min).clamp(min=1e-12))
    log_cdf_delta = torch.log((cdf_plus - cdf_min).clamp(min=1e-12))
    return torch.where(x < -0.999, log_cdf_plus,
                       torch.where(x > 0.999, log_one_minus_cdf_min, log_cdf_delta))


def vb_terms_bpd(sched: Schedule, model_output, x_start, x_t, t, *, mean_type: MeanType,
                 var_type: VarType, model_var_values=None, clip_denoised: bool = False):
    """(per-sample bits, pred_xstart): KL(q(x_{t-1} | x_t, x_0) || p(x_{t-1} |
    x_t)) in bits, the decoder's NLL at t = 0."""
    true_mean, _, true_logvar = q_posterior_mean_variance(sched, x_start, x_t, t)
    out = p_mean_variance(sched, model_output, x_t, t, mean_type=mean_type, var_type=var_type,
                          model_var_values=model_var_values, clip_denoised=clip_denoised)
    kl = mean_flat(normal_kl(true_mean, true_logvar, out.mean, out.log_variance)) / math.log(2.0)
    decoder_nll = -discretized_gaussian_log_likelihood(
        x_start, means=out.mean, log_scales=0.5 * out.log_variance)
    decoder_nll = mean_flat(decoder_nll) / math.log(2.0)
    return torch.where(t == 0, decoder_nll, kl), out.pred_xstart


def prior_bpd(sched: Schedule, x_start):
    """KL(q(x_T | x_0) || N(0, 1)) in bits per sample."""
    t = torch.full((x_start.shape[0],), sched.num_timesteps - 1, dtype=torch.int64,
                   device=x_start.device)
    mean, _, log_variance = q_mean_variance(sched, x_start, t)
    zero = torch.zeros_like(mean)
    return mean_flat(normal_kl(mean, log_variance, zero, zero)) / math.log(2.0)


def calc_bpd_loop(model_fn: Callable, sched: Schedule, x_start, step_noise, *,
                  mean_type: MeanType, var_type: VarType, clip_denoised: bool = False):
    """Bits per dim over every timestep, t = T-1 down to 0 (reference
    calc_bpd_loop, gaussian_diffusion.py:1544-1600). ``step_noise(i)`` gives
    the q_sample noise of the i-th step (t = T-1-i), so a caller can inject
    the reference's draws, as ``p_sample_loop(step_noise=...)`` does.
    ``model_fn(x_t, model_timesteps)`` -> model output (with a learned
    variance, its second half of channels the variance values).

    Returns dict(total_bpd [B], prior_bpd [B], vb [B, T], xstart_mse [B, T],
    mse [B, T]), the [B, T] columns in that reversed-t order."""
    B = x_start.shape[0]
    vb, xstart_mse, mse = [], [], []
    for i, t_scalar in enumerate(range(sched.num_timesteps - 1, -1, -1)):
        t = torch.full((B,), t_scalar, dtype=torch.int64, device=x_start.device)
        noise = step_noise(i)
        x_t = q_sample(sched, x_start, t, noise)
        model_out, var_values = model_fn(x_t, sched.model_timesteps(t)), None
        if var_type in (VarType.LEARNED, VarType.LEARNED_RANGE):
            model_out, var_values = model_out.chunk(2, dim=-1)
        terms, pred_xstart = vb_terms_bpd(sched, model_out, x_start, x_t, t, mean_type=mean_type,
                                          var_type=var_type, model_var_values=var_values,
                                          clip_denoised=clip_denoised)
        vb.append(terms)
        xstart_mse.append(mean_flat((pred_xstart - x_start) ** 2))
        eps = predict_eps_from_xstart(sched, x_t, t, pred_xstart)
        mse.append(mean_flat((eps - noise) ** 2))
    vb = torch.stack(vb, dim=1)
    prior = prior_bpd(sched, x_start)
    return {"total_bpd": vb.sum(dim=1) + prior, "prior_bpd": prior, "vb": vb,
            "xstart_mse": torch.stack(xstart_mse, dim=1), "mse": torch.stack(mse, dim=1)}
