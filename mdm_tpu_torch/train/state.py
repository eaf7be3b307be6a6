"""Train state: the model's parameters, AdamW and the EMA.

Counterpart of mdm_tpu/train/state.py (:38-83), where optax runs
``adamw`` with a linear LR anneal and an optional global-norm clip, and
the EMA is ``optax.incremental_update``. Here:

- ``torch.optim.AdamW`` with betas (0.9, beta2), eps 1e-8 and decoupled
  weight decay on every parameter is optax.adamw up to f32 rounding;
- the LR is ``lr * max(0, 1 - count / anneal)`` at the update count before
  the step (optax's schedule count);
- the clip is optax's: ``g * max / |g|`` only where ``|g| >= max``, with no
  epsilon (``clip_grad_norm_`` adds 1e-6), and on the card, so it never
  waits for the host;
- EMA: ``ema + (1 - decay) * (p_new - ema)``.

The state updates the model in place: no copies of the parameters exist
beyond the EMA and AdamW's two moments.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Iterable, Optional

import torch
from torch import nn


@dataclass(frozen=True)
class OptimConfig:
    lr: float = 1e-4
    weight_decay: float = 0.0
    adam_beta2: float = 0.999
    lr_anneal_steps: int = 0
    grad_clip: float = 0.0  # 0 = off
    ema_decay: float = 0.9999
    use_ema: bool = True


@dataclass
class TrainState:
    step: int
    model: nn.Module
    optimizer: torch.optim.AdamW
    ema_params: Optional[Dict[str, torch.Tensor]]  # parameter name -> EMA tensor

    def params(self) -> Dict[str, torch.Tensor]:
        return dict(self.model.named_parameters())

    def state_dict(self) -> dict:
        return {"step": self.step, "model": self.model.state_dict(),
                "optimizer": self.optimizer.state_dict(), "ema_params": self.ema_params}

    def load_state_dict(self, sd: dict) -> None:
        self.step = int(sd["step"])
        self.model.load_state_dict(sd["model"])
        self.optimizer.load_state_dict(sd["optimizer"])
        if self.ema_params is not None:
            for name, t in self.ema_params.items():
                t.copy_(sd["ema_params"][name])


def make_optimizer(params: Iterable[torch.Tensor], config: OptimConfig) -> torch.optim.AdamW:
    return torch.optim.AdamW(params, lr=config.lr, betas=(0.9, config.adam_beta2), eps=1e-8,
                             weight_decay=config.weight_decay)


def learning_rate(config: OptimConfig, count: int) -> float:
    """The LR of the update after ``count`` earlier updates."""
    if config.lr_anneal_steps > 0:
        return config.lr * max(0.0, 1.0 - count / config.lr_anneal_steps)
    return config.lr


def create_train_state(model: nn.Module, config: OptimConfig) -> TrainState:
    """State at step 0 around ``model``, whose parameters it trains in place."""
    ema = None
    if config.use_ema:
        ema = {n: p.detach().clone() for n, p in model.named_parameters()}
    return TrainState(0, model, make_optimizer(model.parameters(), config), ema)


def global_norm(tensors: Iterable[torch.Tensor]) -> torch.Tensor:
    """sqrt of the sum of squares of every element (optax.global_norm)."""
    return torch.sqrt(sum(t.float().pow(2).sum() for t in tensors))


@torch.no_grad()
def apply_gradients(state: TrainState, config: OptimConfig) -> TrainState:
    """One AdamW update from the parameters' ``.grad`` (clipped in place
    first when ``grad_clip`` > 0), then the EMA; advances ``state.step``."""
    params = [p for p in state.model.parameters() if p.grad is not None]
    if config.grad_clip > 0:
        norm = global_norm(p.grad for p in params)
        for p in params:  # optax.clip_by_global_norm: (g / norm) * max unless norm < max
            p.grad.copy_(torch.where(norm < config.grad_clip, p.grad,
                                     p.grad / norm * config.grad_clip))
    for group in state.optimizer.param_groups:
        group["lr"] = learning_rate(config, state.step)
    state.optimizer.step()
    if state.ema_params is not None:
        for name, p in state.model.named_parameters():
            state.ema_params[name].lerp_(p, 1.0 - config.ema_decay)
    state.step += 1
    return state
