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

Under tensor parallelism (``parallel.tp_rules.shard_state_``) each rank
holds its part of every split parameter, and of its moments and EMA, and
``state.tp`` records the layout. AdamW and the EMA are elementwise and run
on the parts unchanged; the norms (``tree_norm``: the clip's, and the
step's ``grad_norm`` / ``param_norm``) are the global tree's, as GSPMD
computes optax's ``global_norm`` over it.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Iterable, Optional, Sequence

import torch
from torch import nn

from ..utils.tracing import traced


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
    tp: Any = None  # parallel.tp_rules.TPLayout of a tensor-parallel state, else None

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


def global_norm(tensors: Iterable[torch.Tensor], split: Optional[Sequence[bool]] = None,
                group=None) -> torch.Tensor:
    """sqrt of the sum of squares of every element (optax.global_norm).
    With a tensor-parallel model ``group``, ``split[i]`` marks tensors[i]
    as this rank's part of a leaf split over the group: those squares are
    summed over the group (one all-reduce), the replicated leaves', which
    every rank holds whole, counted once."""
    if group is None:
        return torch.sqrt(sum(t.float().pow(2).sum() for t in tensors))
    import torch.distributed as dist

    squares = [t.float().pow(2).sum() for t in tensors]
    zero = squares[0].new_zeros(())
    parted = sum((q for q, s in zip(squares, split) if s), zero).reshape(1)
    dist.all_reduce(parted, group=group)
    return torch.sqrt(parted[0] + sum((q for q, s in zip(squares, split) if not s), zero))


def tree_norm(state: TrainState, tensors: Dict[str, torch.Tensor]) -> torch.Tensor:
    """``global_norm`` of tensors named like ``state``'s parameters (the
    parameters or their gradients): under tensor parallelism the norm of
    the whole tree, on every rank."""
    if state.tp is None:
        return global_norm(tensors.values())
    return global_norm(tensors.values(), state.tp.is_split(tensors), state.tp.mesh.model_group)


@traced("train.update")
@torch.no_grad()
def apply_gradients(state: TrainState, config: OptimConfig) -> TrainState:
    """One AdamW update from the parameters' ``.grad`` (clipped in place
    first when ``grad_clip`` > 0), then the EMA; advances ``state.step``.
    Each call is one ``train.update`` span."""
    params = [p for p in state.model.parameters() if p.grad is not None]
    if config.grad_clip > 0:
        norm = tree_norm(state, {n: p.grad for n, p in state.model.named_parameters()
                                 if p.grad is not None})
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
