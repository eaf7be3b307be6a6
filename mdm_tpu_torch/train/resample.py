"""Train-time timestep samplers (reference diffusion/resample.py).

Counterpart of mdm_tpu/train/resample.py: the uniform sampler, and the
loss-second-moment importance sampler whose per-timestep loss history
lives in a small state object. Draws come from an explicit
``torch.Generator``.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

import torch


def uniform_sample_t(generator: torch.Generator, batch_size: int, num_timesteps: int,
                     device=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """t ~ U{0..T-1}, weights = 1 (reference UniformSampler)."""
    t = torch.randint(0, num_timesteps, (batch_size,), generator=generator, device=device)
    return t, torch.ones((batch_size,), dtype=torch.float32, device=device)


@dataclass
class LossAwareState:
    """Recent losses per timestep: history [T, H] f32, counts [T] int32."""

    history: torch.Tensor
    counts: torch.Tensor

    @classmethod
    def create(cls, num_timesteps: int, history_per_term: int = 10, device=None):
        return cls(torch.zeros((num_timesteps, history_per_term), device=device),
                   torch.zeros((num_timesteps,), dtype=torch.int32, device=device))

    @property
    def warmed_up(self) -> torch.Tensor:
        return (self.counts == self.history.shape[1]).all()


def loss_aware_weights(state: LossAwareState, uniform_prob: float = 0.001) -> torch.Tensor:
    """Sampling distribution over timesteps: sqrt(E[loss^2]) + a uniform mix."""
    w = torch.sqrt((state.history ** 2).mean(dim=-1))
    w = w / w.sum()
    return w * (1 - uniform_prob) + uniform_prob / w.shape[0]


def loss_aware_sample_t(generator: torch.Generator, state: LossAwareState, batch_size: int,
                        uniform_prob: float = 0.001) -> Tuple[torch.Tensor, torch.Tensor]:
    T = state.history.shape[0]
    p_uniform = torch.full((T,), 1.0 / T, device=state.history.device)
    p = torch.where(state.warmed_up, loss_aware_weights(state, uniform_prob), p_uniform)
    t = torch.multinomial(p, batch_size, replacement=True, generator=generator)
    return t, 1.0 / (T * p[t])


def loss_aware_update(state: LossAwareState, t: torch.Tensor, losses: torch.Tensor
                      ) -> LossAwareState:
    """Insert per-sample losses into the per-timestep ring buffers, one
    sample after another, so a timestep drawn twice in a batch takes both
    losses in batch order (LossSecondMomentResampler.update_with_all_losses,
    resample.py:119-138): a full row shifts left and appends, otherwise the
    next free slot fills."""
    history = state.history.detach().cpu().clone()
    counts = state.counts.detach().cpu().clone()
    H = history.shape[1]
    for ti, li in zip(t.tolist(), losses.detach().float().cpu().tolist()):
        n = int(counts[ti])
        if n == H:
            history[ti] = torch.cat([history[ti, 1:], torch.tensor([li])])
        else:
            history[ti, n] = li
            counts[ti] = n + 1
    dev = state.history.device
    return LossAwareState(history.to(dev), counts.to(dev))
