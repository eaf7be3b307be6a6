"""The plain diffusion process of MDM (improved-diffusion's
``GaussianDiffusion`` as MDM configures it): a cosine schedule computed in
float64 and kept in float32, x0 prediction, the posterior variance
("fixed small"), ancestral (DDPM) sampling with classifier-free guidance,
DiP's autoregressive chunk loop, and the masked L2 training loss.

The draws follow the order the program is given them in: a sample's
initial noise, then one transition draw a step (also at the last step,
where it is multiplied by 0), from the request's own generator; a chunk's
noise before its steps.
"""
from __future__ import annotations

import math
from typing import Callable, Optional

import numpy as np
import torch


def cosine_betas(T: int) -> np.ndarray:
    abar = lambda t: math.cos((t + 0.008) / 1.008 * math.pi / 2) ** 2
    return np.array([min(1.0 - abar((i + 1) / T) / abar(i / T), 0.999) for i in range(T)])


class Schedule:
    """The per-step tables of a T-step cosine process, float32 on ``device``."""

    def __init__(self, T: int, device):
        b = cosine_betas(T)
        acp = np.cumprod(1.0 - b)
        prev = np.append(1.0, acp[:-1])
        post_var = b * (1.0 - prev) / (1.0 - acp)
        f32 = lambda a: torch.tensor(np.asarray(a, np.float32), device=device)
        self.T = T
        self.sqrt_acp, self.sqrt_1m_acp = f32(np.sqrt(acp)), f32(np.sqrt(1.0 - acp))
        self.coef1 = f32(b * np.sqrt(prev) / (1.0 - acp))
        self.coef2 = f32((1.0 - prev) * np.sqrt(1.0 - b) / (1.0 - acp))
        self.log_var = f32(np.log(np.append(post_var[1], post_var[1:])))

    def q_sample(self, x0, t, noise):
        s = lambda table: table[t].reshape(-1, *([1] * (x0.dim() - 1)))
        return s(self.sqrt_acp) * x0 + s(self.sqrt_1m_acp) * noise


def ddpm_sample(model: Callable, sched: Schedule, noise: torch.Tensor,
                generator: torch.Generator, record: Optional[list] = None) -> torch.Tensor:
    """``model(x, t [B]) -> x0_hat``; from x_T = ``noise`` down to x_0, one
    transition draw a step from ``generator``; ``record`` gets each step's x."""
    x = noise
    for i in range(sched.T - 1, -1, -1):
        if record is not None:
            record.append(x)
        t = torch.full((x.shape[0],), i, dtype=torch.long, device=x.device)
        x0 = model(x, t)
        mean = sched.coef1[i] * x0 + sched.coef2[i] * x
        z = torch.randn(x.shape, generator=generator, device=x.device, dtype=x.dtype)
        x = mean + (float(i != 0) * torch.exp(0.5 * sched.log_var[i])) * z
    return x


def guided(model: Callable, scale: float) -> Callable:
    """Classifier-free guidance: ``model(x, t, drop)`` at drop False and True."""

    def fn(x, t):
        cond = model(x, t, False)
        uncond = model(x, t, True)
        return uncond + scale * (cond - uncond)

    return fn


def autoregressive(sample_chunk: Callable, prefix: torch.Tensor, chunks: int, pred_len: int,
                   frames: int, feats: int, generator: torch.Generator) -> torch.Tensor:
    """DiP: ``chunks`` chunks of ``pred_len`` frames, each denoised from its
    own noise under the last ``context`` frames so far as prefix
    (``sample_chunk(noise, prefix)``); the first ``frames`` frames."""
    context, out = prefix.shape[1], []
    for _ in range(chunks):
        noise = torch.randn((prefix.shape[0], pred_len, feats), generator=generator,
                            device=prefix.device)
        sample = sample_chunk(noise, prefix)
        out.append(sample)
        prefix = torch.cat([prefix, sample], dim=1)[:, -context:]
    return torch.cat(out, dim=1)[:, :frames]


def masked_l2(target, pred, mask):
    """Per example: the squared error summed over valid frames, over the
    valid frames times the features (``mask`` [B, T])."""
    m = mask.float()[..., None]
    num = ((target - pred) ** 2 * m).flatten(1).sum(1)
    return num / (m.flatten(1).sum(1) * target.shape[-1] + 1e-8)
