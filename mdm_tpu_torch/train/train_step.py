"""One training step: loss, gradients, AdamW and EMA, on one device, or
data- and tensor-parallel over a torch.distributed world.

Counterpart of mdm_tpu/train/train_step.py::make_train_step (:69-288).
Per step, in this order: draw t, the noise and the CFG condition dropout
(and the goal target's), q_sample, the model's training forward (dropout
from the step's generator), the losses (the goal target loss when asked),
the backward through the hand-written kernels, the metrics, AdamW and the
EMA.

Under a data-parallel mesh (the counterpart of ``_sm_grads``, :128-178)
each rank holds its rows of the global batch. It draws the global t,
noise and condition dropouts from the step's generators and keeps its
rows, runs the model on its rows inside ``ops.sharded_rows`` (every
dropout mask is then exactly its rows of the one-process masks: the seeds
come from the same CPU generator on every rank, and the first global row
moves the Philox counter's batch word), and takes the local partial
``sum(weights * terms) / B_global`` of the global mean. One all-reduce
over the batch group then sums, in a fixed parameter order, every
gradient, the loss, and the per-example terms and t written into zeroed
global rows (an exact gather, which gloo's CUDA tensors also take). The
reduction order is a function of the world alone, so resume stays bitwise
within a topology; the norms, AdamW and the EMA then run identically on
every rank. One body serves every case: without a mesh the rows are the
whole batch and nothing is summed, and a mesh of one rank runs the same
all-reduce (the identity), so its step is the mesh-less step, bitwise.

Under tensor parallelism (a model axis above 1, mdm_tpu's
``state_shardings``, :255-288) the state is split by
``parallel.tp_rules.shard_state_``: each rank holds its heads and FFN
columns of every layer, and their AdamW moments and EMA. The same body
runs: the model's forward and backward run Megatron's collectives over
the model group (models/layers.py) and draw each dropout mask at the
rank's batch, head and FFN-column offsets, so the global step is the
one-process step, mask for mask; the batch group's flat all-reduce sums
the rank's parts, whose shapes its batch group shares (its members share
its model index); the norms are the global tree's (``state.tree_norm``).
AUTO resolves to off (``ops.mesh_kernels``): the layers take the einsum
attention and the plain tail, whose dumps (#6, #9) are the only hand
kernels that run, and a fused kernel pinned on raises.

Randomness is a pure function of the step's integer ``key`` (the
counterpart of ``jax.random.fold_in(base, step)``, see ``step_key``): a
CPU generator seeded with it gives the model's dropout seeds, and a device
generator seeded from that gives t, the noise and the condition
dropouts. ``draws`` replaces those draws, so tests can feed the step the
draws that the JAX step made.

Spans (utils/tracing.py): the step is one ``train.step`` holding, in
order, ``train.draws`` (with q_sample), ``train.forward`` (the model and the losses),
``train.backward``, ``train.reduce`` (the sum over ranks and the norms) and
``train.update`` (``apply_gradients``).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch

from .. import ops
from ..diffusion import gaussian as G
from ..diffusion.losses import LossConfig, training_losses
from ..diffusion.schedule import Schedule
from ..utils.tracing import span
from .resample import LossAwareState, loss_aware_sample_t, loss_aware_update, uniform_sample_t
from .state import OptimConfig, TrainState, apply_gradients, tree_norm


@dataclass(frozen=True)
class TrainStepConfig:
    loss: LossConfig = LossConfig()
    optim: OptimConfig = OptimConfig()
    cond_mask_prob: float = 0.1  # CFG condition dropout
    # 'uniform' (reference default) or 'loss-second-moment'
    schedule_sampler: str = "uniform"


def step_key(rng_seed: int, step: int) -> int:
    """The step's 63-bit key, a pure function of (rng_seed, step)."""
    return int(np.random.SeedSequence([rng_seed, step]).generate_state(1, np.uint64)[0] >> 1)


def step_generators(key: int, device) -> Tuple[torch.Generator, torch.Generator]:
    """(CPU generator for the dropout seeds, device generator for the draws)."""
    cpu = torch.Generator().manual_seed(key)
    dev = torch.Generator(device).manual_seed(int(torch.randint(0, 2 ** 62, (), generator=cpu)))
    return cpu, dev


def quartile_metrics(losses: torch.Tensor, t: torch.Tensor, num_timesteps: int
                     ) -> Dict[str, torch.Tensor]:
    """Mean loss per timestep quartile (reference training_loop.py:469-475)."""
    quartile = (4 * t) // num_timesteps
    out = {}
    for q in range(4):
        sel = (quartile == q).to(losses.dtype)
        out[f"loss_q{q}"] = (losses * sel).sum() / sel.sum().clamp_min(1.0)
    return out


def _sum_over_ranks(mesh, grads, loss: torch.Tensor, table: torch.Tensor, rows: slice,
                    B: int):
    """One all-reduce over the mesh's batch group of every gradient (in
    place, in parameter order), the loss, and ``table``'s per-example
    columns [K, b] written into zeroed global columns [K, B] (an exact
    gather, which gloo's CUDA tensors also take). Returns the global
    (loss, table); without a mesh, the step's own."""
    if mesh is None:
        return loss, table
    cols = torch.zeros(table.shape[:1] + (B,), dtype=table.dtype, device=table.device)
    cols[:, rows] = table
    flat = mesh.sum_over_batch(torch.cat([g.reshape(-1).float() for g in grads]
                                         + [loss.float().reshape(1), cols.reshape(-1)]))
    offset = 0
    for g in grads:
        g.copy_(flat[offset:offset + g.numel()].view_as(g))
        offset += g.numel()
    return flat[offset], flat[offset + 1:].view(-1, B)


def make_train_step(sched: Schedule, config: TrainStepConfig, *,
                    get_xyz: Optional[Callable] = None,
                    target_loss_builder: Optional[Callable] = None,
                    target_cond_fn: Optional[Callable] = None,
                    mesh=None):
    """Returns ``step(state, batch, key, sampler_state=None, *, draws=None)``.

    ``batch``: a dict with ``x`` [B, T, D], ``mask`` [B, T] bool and a
    ``cond`` Conditioning, on the model's device (``sched`` too); DiP's
    prefix travels in ``cond.prefix``. ``key``: the step's integer key.
    ``draws``: optional dict of ``t`` [B] int, ``noise`` like x,
    ``cond_drop`` [B] bool and, for goal conditioning, ``target_uncond``
    [B] bool. Goal conditioning (train/goal_cond.py): ``target_cond_fn``
    (x_start, validity) -> targets extracts ``cond.target_cond`` in the
    step when the batch brings only ``cond.target_validity``;
    ``target_loss_builder(batch)`` gives the target loss of
    ``lambda_target_loc``. Returns ``(state, metrics)``, plus the new
    sampler state under 'loss-second-moment'. The state is updated in
    place; after the step each parameter's ``.grad`` holds the gradient
    the update used. Metrics stay on the device.

    ``mesh`` (parallel.mesh.Mesh): with more than one rank, ``batch`` holds
    this rank's rows (the rows of its batch index) and ``draws`` the global
    draws; the metrics, the sampler state and the update are the global
    step's on every rank; a mesh of one rank runs the same body, its
    all-reduce the identity. With a model axis above 1 the state must be
    split over it (``tp_rules.shard_state_``)."""
    loss_aware = config.schedule_sampler == "loss-second-moment"
    if not loss_aware and config.schedule_sampler != "uniform":
        raise ValueError(f"unknown schedule_sampler {config.schedule_sampler!r}")
    tensor_parallel = mesh is not None and mesh.model_parallel > 1

    def step(state: TrainState, batch: Dict, key: int,
             sampler_state: Optional[LossAwareState] = None, *, draws: Optional[Dict] = None):
        split_over = None if state.tp is None else state.tp.mesh.model_parallel
        if split_over != (mesh.model_parallel if tensor_parallel else None):
            raise ValueError(f"a state split over {split_over or 1} model-parallel rank(s) on a "
                             f"step over {mesh.model_parallel if mesh else 1}: split a state for "
                             "a tensor-parallel mesh with tp_rules.shard_state_")
        with span("train.step"), ops.mesh_kernels(tensor_parallel):
            return _step(state, batch, key, sampler_state, draws)

    def _step(state, batch, key, sampler_state, draws):
        x_start, mask, cond = batch["x"], batch["mask"], batch["cond"]
        if (target_cond_fn is not None and cond.target_validity is not None
                and cond.target_cond is None):
            cond = cond.replace(target_cond=target_cond_fn(x_start, cond.target_validity))
            batch = dict(batch, cond=cond)
        device, b = x_start.device, x_start.shape[0]
        B = b if mesh is None else b * mesh.data_parallel
        rows = slice(0, B) if mesh is None else mesh.rows(B)
        draw_target = config.cond_mask_prob > 0 and cond.target_cond is not None
        with span("train.draws"):
            rng, gen = step_generators(key, device)
            weights = torch.ones((B,), dtype=torch.float32, device=device)
            if draws is not None:
                t, noise, drop = draws["t"], draws["noise"], draws["cond_drop"]
                target_uncond = draws["target_uncond"] if draw_target else None
            else:
                if loss_aware:
                    t, weights = loss_aware_sample_t(gen, sampler_state, B)
                else:
                    t, weights = uniform_sample_t(gen, B, sched.num_timesteps, device)
                noise = torch.randn((B,) + tuple(x_start.shape[1:]), generator=gen,
                                    device=device, dtype=x_start.dtype)
                drop = torch.rand((B,), generator=gen, device=device) < config.cond_mask_prob
                # The target's condition dropout is its own Bernoulli draw, as
                # the reference's mask_cond of the target embedding.
                target_uncond = (torch.rand((B,), generator=gen, device=device)
                                 < config.cond_mask_prob) if draw_target else None
            t, weights, noise, drop = (v.to(device)[rows] for v in (t, weights, noise, drop))
            x_t = G.q_sample(sched, x_start, t, noise)
        if config.cond_mask_prob > 0:
            cond = cond.replace(cond_drop=drop, frames_mask=mask)
            if draw_target:
                cond = cond.replace(target_uncond=target_uncond.to(device)[rows])
        else:
            cond = cond.replace(frames_mask=mask)
        # The goal loss closes over this rank's cond, as JAX's local_fn's.
        target_loss_fn = target_loss_builder(batch) if target_loss_builder is not None else None

        model = state.model
        named = dict(model.named_parameters())
        for p in named.values():
            p.grad = None
        with ops.sharded_rows(rows.start):
            with span("train.forward"):
                model_out = model(x_t, sched.model_timesteps(t), cond, deterministic=False,
                                  rng=rng)
                terms = training_losses(sched, model_out, x_start, x_t, t, noise,
                                        mask[..., None], config.loss, get_xyz=get_xyz,
                                        target_loss_fn=target_loss_fn)
                partial = weights * terms["loss"]
                # the local partial of the global mean
                loss = partial.mean() if B == b else partial.sum() / B
            with span("train.backward"):
                loss.backward()

        names = sorted(terms)
        with torch.no_grad(), span("train.reduce"):
            grads = {n: p.grad for n, p in named.items() if p.grad is not None}
            loss, table = _sum_over_ranks(
                mesh, list(grads.values()), loss.detach(),
                torch.stack([terms[k].detach().float() for k in names] + [t.float()]), rows, B)
            grad_norm = tree_norm(state, grads)
            param_norm = tree_norm(state, named)
        apply_gradients(state, config.optim)

        losses, t = table[names.index("loss")], table[-1].round().long()
        metrics = {"loss": loss, "grad_norm": grad_norm, "param_norm": param_norm,
                   **{k: v.mean() for k, v in zip(names, table) if k != "loss"},
                   **quartile_metrics(losses, t, sched.num_timesteps)}
        if loss_aware:
            return state, metrics, loss_aware_update(sampler_state, t, losses)
        return state, metrics

    return step
