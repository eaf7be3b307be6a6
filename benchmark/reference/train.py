"""MDM's training step in plain float32 PyTorch: the step's draws, the
noised input, the masked L2 loss of the x0 prediction, the backward, AdamW
(decoupled weight decay, bias-corrected moments, eps outside the square
root, as ``torch.optim.AdamW``) and the EMA of the parameters.

The step's randomness comes from its integer key, as the training loop
of MDM's port derives it: a CPU generator seeded with the key gives one
draw that seeds a device generator, then the forward's dropout seeds; the
device generator gives t, the noise and the condition dropout, in that
order.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from . import diffusion, models
from .precision import Precision


def step_key(seed: int, step: int) -> int:
    """The step's 63-bit key, a pure function of (seed, step)."""
    return int(np.random.SeedSequence([seed, step]).generate_state(1, np.uint64)[0] >> 1)


def draws(key: int, B: int, frames: int, feats: int, T: int, cond_mask_prob: float, device):
    """(cpu generator for the dropout seeds, t [B], noise [B, frames, feats], cond_drop [B])."""
    cpu = torch.Generator().manual_seed(key)
    dev = torch.Generator(device).manual_seed(int(torch.randint(0, 2 ** 62, (), generator=cpu)))
    t = torch.randint(0, T, (B,), generator=dev, device=device)
    noise = torch.randn((B, frames, feats), generator=dev, device=device)
    drop = torch.rand((B,), generator=dev, device=device) < cond_mask_prob
    return cpu, t, noise, drop


def loss_and_grads(P: Dict[str, torch.Tensor], cfg: dict, sched: diffusion.Schedule, batch: dict,
                   key: int, cond_mask_prob: float, prec: Precision, loss_rows=None):
    """(loss, {name: gradient}) of one step on ``batch`` (x [B, T, F], mask
    [B, T], text [B, Dt]) at the parameters P; the loss is the mean over
    the examples of ``loss_rows`` (all of them by default)."""
    x0, mask = batch["x"].float(), batch["mask"]
    B, frames, feats = x0.shape
    rng, t, noise, drop = draws(key, B, frames, feats, sched.T, cond_mask_prob, x0.device)
    leaves = {n: p.detach().clone().requires_grad_(True) for n, p in P.items()}
    x_t = sched.q_sample(x0, t, noise)
    with prec.scope():
        out = models.mdm_forward(leaves, cfg, x_t, t, batch["text"], prec=prec,
                                 frames_mask=mask, cond_drop=drop, rng=rng)
        loss = diffusion.masked_l2(x0, out, mask)[loss_rows or slice(None)].mean()
        loss.backward()
    return loss.detach(), {n: p.grad for n, p in leaves.items()}


class AdamW:
    """AdamW with an EMA of the parameters, on a dict of float32 tensors."""

    def __init__(self, P: Dict[str, torch.Tensor], lr: float, weight_decay: float,
                 betas=(0.9, 0.999), eps: float = 1e-8, ema_decay: float = 0.9999):
        self.P = {n: p.detach().clone() for n, p in P.items()}
        self.m = {n: torch.zeros_like(p) for n, p in self.P.items()}
        self.v = {n: torch.zeros_like(p) for n, p in self.P.items()}
        self.ema = {n: p.clone() for n, p in self.P.items()}
        self.lr, self.wd, self.betas, self.eps, self.ema_decay = lr, weight_decay, betas, eps, ema_decay
        self.count = 0

    @torch.no_grad()
    def update(self, grads: Dict[str, torch.Tensor]) -> None:
        b1, b2 = self.betas
        self.count += 1
        bc1, bc2 = 1 - b1 ** self.count, 1 - b2 ** self.count
        for n, p in self.P.items():
            g = grads[n]
            p.mul_(1 - self.lr * self.wd)
            self.m[n].mul_(b1).add_(g, alpha=1 - b1)
            self.v[n].mul_(b2).addcmul_(g, g, value=1 - b2)
            denom = self.v[n].sqrt() / bc2 ** 0.5 + self.eps
            p.addcdiv_(self.m[n], denom, value=-self.lr / bc1)
            self.ema[n].lerp_(p, 1.0 - self.ema_decay)
