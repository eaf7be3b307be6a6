"""Diffusion samplers: ancestral (DDPM), DDIM and its reverse, PLMS,
DPM-Solver++(2M).

Counterpart of mdm_tpu/diffusion/samplers.py (:34-395): Python loops over
the respaced steps where the JAX package runs a lax.scan, in plain torch
(the JAX package computes them outside any Pallas kernel too). The
``model_fn`` closes over the model and conditioning (CFG double-batch
included) and receives ``(x, t_model)`` with ``t_model`` already mapped to
original-process timesteps; a stateful one (cached CFG) receives and
returns its ``model_state``: ``model_fn(x, t, state) -> (out, state)``.
Noise is drawn from an explicit ``torch.Generator``, or taken from
``step_noise`` so that tests can feed the ancestral loop and the JAX scan
identical noise. Each step of every loop runs inside a ``sample.step``
span (utils/tracing.py).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Optional, Sequence

import torch

from ..utils.tracing import span
from . import gaussian as G
from .schedule import MeanType, Schedule, VarType

ModelFn = Callable[[torch.Tensor, torch.Tensor], torch.Tensor]
CondFn = Callable[[torch.Tensor, torch.Tensor], torch.Tensor]

# Adams-Bashforth coefficients per order, oldest epsilon first.
_AB_COEFFS = {
    1: (1.0,),
    2: (-1.0 / 2.0, 3.0 / 2.0),
    3: (5.0 / 12.0, -16.0 / 12.0, 23.0 / 12.0),
    4: (-9.0 / 24.0, 37.0 / 24.0, -59.0 / 24.0, 55.0 / 24.0),
}


@dataclass(frozen=True)
class SamplerConfig:
    mean_type: MeanType = MeanType.START_X
    var_type: VarType = VarType.FIXED_SMALL
    clip_denoised: bool = False
    const_noise: bool = False  # one noise draw shared by every sample of the batch
    eta: float = 0.0  # DDIM stochasticity
    order: int = 2  # PLMS order
    skip_timesteps: int = 0
    guidance_mode: str = "mean"  # how cond_fn conditions the ancestral step: "mean" | "score"


def _init_state(sched: Schedule, noise: torch.Tensor, init_image: Optional[torch.Tensor],
                skip_timesteps: int):
    """The starting x and the step indices, most-noised first. A warm start
    (``init_image``, or zeros when only ``skip_timesteps`` is given) noises
    the image to the first retained step."""
    num_steps = sched.num_timesteps - skip_timesteps
    x = noise
    if skip_timesteps and init_image is None:
        init_image = torch.zeros_like(noise)
    if init_image is not None:
        t0 = torch.full((noise.shape[0],), num_steps - 1, dtype=torch.long, device=noise.device)
        x = G.q_sample(sched, init_image, t0, noise)
    return x, list(range(num_steps - 1, -1, -1))


def _step_noise(generator: Optional[torch.Generator], x: torch.Tensor, const_noise: bool):
    if const_noise:
        n = torch.randn((1,) + tuple(x.shape[1:]), generator=generator, device=x.device,
                        dtype=x.dtype)
        return n.expand(x.shape)
    return torch.randn(x.shape, generator=generator, device=x.device, dtype=x.dtype)


def _steps(i: int, x: torch.Tensor) -> torch.Tensor:
    return torch.full((x.shape[0],), i, dtype=torch.long, device=x.device)


def _p_mean_variance_step(sched, model_fn, cond_fn, cfg: SamplerConfig, x, t,
                          inpainting_mask, inpainted_motion, model_state=None,
                          force_score=False):
    """(PMeanVariance, model_state) of one step. ``force_score``: DDIM, PLMS
    and DPM-Solver++ always condition the score when a cond_fn is given (the
    reference's ddim_sample/plms_sample); ``guidance_mode`` chooses only for
    the ancestral sampler."""
    t_model = sched.model_timesteps(t)
    if model_state is not None:
        model_out, model_state = model_fn(x, t_model, model_state)
    else:
        model_out = model_fn(x, t_model)
    out = G.p_mean_variance(
        sched, model_out, x, t, mean_type=cfg.mean_type, var_type=cfg.var_type,
        clip_denoised=cfg.clip_denoised,
        inpainting_mask=inpainting_mask, inpainted_motion=inpainted_motion,
    )
    if cond_fn is not None and (force_score or cfg.guidance_mode == "score"):
        out = G.condition_score(sched, cond_fn(x, t_model), out, x, t)
    return out, model_state


def p_sample_loop(
    model_fn: ModelFn,
    sched: Schedule,
    noise: torch.Tensor,
    generator: Optional[torch.Generator] = None,
    config: SamplerConfig = SamplerConfig(),
    *,
    init_image: Optional[torch.Tensor] = None,
    cond_fn: Optional[CondFn] = None,
    inpainting_mask: Optional[torch.Tensor] = None,
    inpainted_motion: Optional[torch.Tensor] = None,
    dump_steps: Optional[Sequence[int]] = None,
    model_state=None,
    step_noise: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Ancestral sampling from ``noise`` (x_T); returns x_0, or the stacked
    x after each step in ``dump_steps`` (indices into the step sequence,
    0 = the first, most-noised step).

    ``step_noise``: optional [num_steps, *noise.shape] transition noise,
    indexed in step order, replacing the draws from ``generator``."""
    x, indices = _init_state(sched, noise, init_image, config.skip_timesteps)
    dumps = []
    for step, i in enumerate(indices):
        with span("sample.step"):
            t = _steps(i, x)
            out, model_state = _p_mean_variance_step(sched, model_fn, cond_fn, config, x, t,
                                                     inpainting_mask, inpainted_motion,
                                                     model_state)
            mean = out.mean
            if cond_fn is not None and config.guidance_mode == "mean":
                mean = G.condition_mean(cond_fn(x, sched.model_timesteps(t)), out)
            if step_noise is not None:
                ns = step_noise[step]
            else:
                ns = _step_noise(generator, x, config.const_noise)
            nonzero = float(i != 0)
            x = mean + nonzero * torch.exp(0.5 * out.log_variance) * ns
        if dump_steps is not None:
            dumps.append(x)
    if dump_steps is not None:
        return torch.stack([dumps[i] for i in dump_steps])
    return x


def ddim_sample_loop(
    model_fn: ModelFn,
    sched: Schedule,
    noise: torch.Tensor,
    generator: Optional[torch.Generator] = None,
    config: SamplerConfig = SamplerConfig(),
    *,
    init_image: Optional[torch.Tensor] = None,
    cond_fn: Optional[CondFn] = None,
    inpainting_mask: Optional[torch.Tensor] = None,
    inpainted_motion: Optional[torch.Tensor] = None,
    model_state=None,
) -> torch.Tensor:
    """DDIM sampling; deterministic at ``eta=0``, where nothing is drawn."""
    nd = noise.dim()
    x, indices = _init_state(sched, noise, init_image, config.skip_timesteps)
    for i in indices:
        with span("sample.step"):
            t = _steps(i, x)
            out, model_state = _p_mean_variance_step(sched, model_fn, cond_fn, config, x, t,
                                                     inpainting_mask, inpainted_motion,
                                                     model_state, force_score=True)
            eps = G.predict_eps_from_xstart(sched, x, t, out.pred_xstart)
            alpha_bar = G.extract(sched.alphas_cumprod, t, nd)
            alpha_bar_prev = G.extract(sched.alphas_cumprod_prev, t, nd)
            sigma = (config.eta * torch.sqrt((1 - alpha_bar_prev) / (1 - alpha_bar))
                     * torch.sqrt(1 - alpha_bar / alpha_bar_prev))
            x = out.pred_xstart * torch.sqrt(alpha_bar_prev) + torch.sqrt(
                1 - alpha_bar_prev - sigma ** 2) * eps
            if config.eta != 0.0 and i != 0:
                x = x + sigma * torch.randn(x.shape, generator=generator, device=x.device,
                                            dtype=x.dtype)
    return x


def ddim_reverse_sample_loop(
    model_fn: ModelFn,
    sched: Schedule,
    x0: torch.Tensor,
    config: SamplerConfig = SamplerConfig(),
) -> torch.Tensor:
    """Deterministic DDIM encoding x_0 -> x_T (the reverse ODE)."""
    nd = x0.dim()
    x = x0
    for i in range(sched.num_timesteps):
        with span("sample.step"):
            t = _steps(i, x)
            out, _ = _p_mean_variance_step(sched, model_fn, None, config, x, t, None, None)
            eps = ((G.extract(sched.sqrt_recip_alphas_cumprod, t, nd) * x - out.pred_xstart)
                   / G.extract(sched.sqrt_recipm1_alphas_cumprod, t, nd))
            alpha_bar_next = G.extract(sched.alphas_cumprod_next, t, nd)
            x = (out.pred_xstart * torch.sqrt(alpha_bar_next)
                 + torch.sqrt(1 - alpha_bar_next) * eps)
    return x


def plms_sample_loop(
    model_fn: ModelFn,
    sched: Schedule,
    noise: torch.Tensor,
    generator: Optional[torch.Generator] = None,
    config: SamplerConfig = SamplerConfig(),
    *,
    init_image: Optional[torch.Tensor] = None,
    cond_fn: Optional[CondFn] = None,
    inpainting_mask: Optional[torch.Tensor] = None,
    inpainted_motion: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Pseudo Linear Multistep (Adams-Bashforth) sampling, order 1-4. The
    first step is the Pseudo-Improved-Euler double evaluation when order > 1
    (reference gaussian_diffusion.py:1042-1049); later steps combine the
    last ``order`` epsilons. Deterministic: ``generator`` is not read."""
    order = config.order
    if not 1 <= order <= 4:
        raise ValueError("PLMS order must be in [1, 4]")
    nd = noise.dim()
    x, indices = _init_state(sched, noise, init_image, config.skip_timesteps)

    def model_eps(x, t):
        out, _ = _p_mean_variance_step(sched, model_fn, cond_fn, config, x, t, inpainting_mask,
                                       inpainted_motion, force_score=True)
        return G.predict_eps_from_xstart(sched, x, t, out.pred_xstart), out

    def mean_from_eps(eps_prime, x, t):
        pred_prime = G.predict_xstart_from_eps(sched, x, t, eps_prime)
        alpha_bar_prev = G.extract(sched.alphas_cumprod_prev, t, nd)
        return pred_prime * torch.sqrt(alpha_bar_prev) + torch.sqrt(1 - alpha_bar_prev) * eps_prime

    with span("sample.step"):
        t0 = _steps(indices[0], x)
        eps0, out0 = model_eps(x, t0)
        eps_prime = eps0
        if order > 1:
            alpha_bar_prev = G.extract(sched.alphas_cumprod_prev, t0, nd)
            euler = out0.pred_xstart * torch.sqrt(alpha_bar_prev) + torch.sqrt(
                1 - alpha_bar_prev) * eps0
            eps2, _ = model_eps(euler, t0 - 1)
            eps_prime = (eps0 + eps2) / 2
        x = mean_from_eps(eps_prime, x, t0) if indices[0] != 0 else out0.pred_xstart

    ring = [eps0] * order  # past epsilons, most recent last
    count = 1
    for i in indices[1:]:
        with span("sample.step"):
            t = _steps(i, x)
            eps, out = model_eps(x, t)
            ring = ring[1:] + [eps]
            count = min(count + 1, order)
            coeffs = _AB_COEFFS[count]
            eps_prime = torch.zeros_like(eps)
            for k, c in enumerate(coeffs):
                eps_prime = eps_prime + c * ring[order - len(coeffs) + k]
            x = mean_from_eps(eps_prime, x, t) if i != 0 else out.pred_xstart
    return x


def dpmpp_2m_sample_loop(
    model_fn: ModelFn,
    sched: Schedule,
    noise: torch.Tensor,
    generator: Optional[torch.Generator] = None,
    config: SamplerConfig = SamplerConfig(),
    *,
    init_image: Optional[torch.Tensor] = None,
    cond_fn: Optional[CondFn] = None,
    inpainting_mask: Optional[torch.Tensor] = None,
    inpainted_motion: Optional[torch.Tensor] = None,
    model_state=None,
) -> torch.Tensor:
    """DPM-Solver++(2M), data-prediction form (Lu et al. 2022): a
    second-order multistep ODE solver over log-SNR time, one model call per
    step and one more at the end for the clean x0. Deterministic:
    ``generator`` is not read."""
    x, indices = _init_state(sched, noise, init_image, config.skip_timesteps)
    alpha = torch.sqrt(sched.alphas_cumprod)
    sigma = torch.sqrt(1.0 - sched.alphas_cumprod)
    lam = torch.log(alpha) - torch.log(sigma)

    def pred_x0(x, i, mstate):
        out, mstate = _p_mean_variance_step(sched, model_fn, cond_fn, config, x, _steps(i, x),
                                            inpainting_mask, inpainted_motion, mstate,
                                            force_score=True)
        return out.pred_xstart, mstate

    def solver_update(x, d_tilde, i_from, i_to):
        h = lam[i_to] - lam[i_from]
        return (sigma[i_to] / sigma[i_from]) * x - alpha[i_to] * torch.expm1(-h) * d_tilde

    with span("sample.step"):
        d_prev, model_state = pred_x0(x, indices[0], model_state)
        if len(indices) == 1:
            return d_prev  # single step: the x0 prediction
        x = solver_update(x, d_prev, indices[0], indices[1])
    for i_prev2, i_prev, i_next in zip(indices, indices[1:], indices[2:]):
        with span("sample.step"):
            d_cur, model_state = pred_x0(x, i_prev, model_state)
            r = (lam[i_prev] - lam[i_prev2]) / (lam[i_next] - lam[i_prev])
            d_tilde = (1.0 + 1.0 / (2.0 * r)) * d_cur - (1.0 / (2.0 * r)) * d_prev
            x = solver_update(x, d_tilde, i_prev, i_next)
            d_prev = d_cur
    with span("sample.step"):
        return pred_x0(x, indices[-1], model_state)[0]


SAMPLERS = {
    "ddpm": p_sample_loop,
    "ddim": ddim_sample_loop,
    "plms": plms_sample_loop,
    "dpmpp_2m": dpmpp_2m_sample_loop,
}
