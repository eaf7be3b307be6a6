"""Ancestral (DDPM) sampling loop.

Counterpart of mdm_tpu/diffusion/samplers.py::p_sample_loop (:100-152): a
Python loop over the respaced steps where the JAX package runs a lax.scan.
The ``model_fn`` closes over the model and conditioning (CFG double-batch
included) and receives ``(x, t_model)`` with ``t_model`` already mapped to
original-process timesteps. Transition noise is drawn from an explicit
``torch.Generator``, or taken from ``step_noise`` so that tests can feed
this loop and the JAX scan identical noise.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Optional

import torch

from . import gaussian as G
from .schedule import MeanType, Schedule, VarType

ModelFn = Callable[[torch.Tensor, torch.Tensor], torch.Tensor]


@dataclass(frozen=True)
class SamplerConfig:
    mean_type: MeanType = MeanType.START_X
    var_type: VarType = VarType.FIXED_SMALL
    clip_denoised: bool = False


def p_sample_loop(
    model_fn: ModelFn,
    sched: Schedule,
    noise: torch.Tensor,
    generator: Optional[torch.Generator] = None,
    config: SamplerConfig = SamplerConfig(),
    *,
    inpainting_mask: Optional[torch.Tensor] = None,
    inpainted_motion: Optional[torch.Tensor] = None,
    step_noise: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Ancestral sampling from ``noise`` (x_T); returns x_0.

    ``step_noise``: optional [num_steps, *noise.shape] transition noise,
    indexed in step order (0 = the first, most-noised step), replacing the
    draws from ``generator``."""
    B = noise.shape[0]
    x = noise
    n = sched.num_timesteps
    for step, i in enumerate(range(n - 1, -1, -1)):
        t = torch.full((B,), i, dtype=torch.long, device=x.device)
        out = G.p_mean_variance(
            sched, model_fn(x, sched.model_timesteps(t)), x, t,
            mean_type=config.mean_type, var_type=config.var_type,
            clip_denoised=config.clip_denoised,
            inpainting_mask=inpainting_mask, inpainted_motion=inpainted_motion,
        )
        if step_noise is not None:
            ns = step_noise[step]
        else:
            ns = torch.randn(x.shape, generator=generator, device=x.device, dtype=x.dtype)
        nonzero = float(i != 0)
        x = out.mean + nonzero * torch.exp(0.5 * out.log_variance) * ns
    return x
