"""Training for the T2M evaluator networks (reference trainers.py scope).

Counterpart of mdm_tpu/eval/train_evaluators.py (:43-330), the trainers
that produce the frozen metric encoders every t2m eval path depends on
(reference data_loaders/humanml/networks/trainers.py):

- DecompTrainerV3 (:25-208): movement conv autoencoder — L1 reconstruction
  + latent sparsity + latent smoothness.
- TextMotionMatchTrainer (:879-1089): contrastive text/motion embedding
  training (Hadsell-Chopra-LeCun margin loss, modules.py:11-24) on top of
  the frozen movement encoder.
- LengthEstTrainer (:748-876): cross-entropy motion-length classifier.
- The a2m protocol's action classifiers (``make_a2m_classifier_step``: the
  GRU MotionDiscriminator, or the STGCN through ``a2m_setup.StgcnAdapter``),
  which the reference ships only frozen (assets/actionrecognition/*.tar).

Each ``make_*_step`` returns ``(init, step)``: ``init(seed)`` draws the
networks' weights from mdm_tpu's initialisers (``networks.reset_seeded``:
flax's lecun-normal kernels and zero biases) and returns
``(params, optimizer)`` (an ``nn.ModuleDict`` or the module, and
``torch.optim.Adam`` with optax.adam's defaults); ``step(params, opt,
batch)`` runs loss, gradients, mdm_tpu's per-network clip and Adam on the
networks' device in float32 (TF32 off: ``networks.f32_math``) and returns
``(params, opt, logs)`` with the logs left on the device. After a step
each parameter's ``.grad`` holds the clipped gradient that Adam took.

Parameters persist in mdm_tpu's npy layout (a pickled dict of flax-layout
numpy arrays), so a ``finest.npy`` written by either package loads in both.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, Iterable, Mapping

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from .networks import (
    MotionEncoderBiGRUCo,
    MotionLenEstimatorBiGRU,
    MovementConvDecoder,
    MovementConvEncoder,
    TextEncoderBiGRUCo,
    f32_math,
    flax_params,
    reset_seeded,
)


@dataclass(frozen=True)
class EvalTrainConfig:
    lr: float = 1e-4
    # reference clip_grad_norm_(net.parameters(), 0.5) — applied PER
    # network, not over the joint tree (trainers.py:46-47,784-785)
    grad_clip: float = 0.5
    unit_length: int = 4
    lambda_sparsity: float = 0.001  # reference train options defaults
    lambda_smooth: float = 0.001
    negative_margin: float = 10.0


def _clip_per_network(networks: Mapping[str, nn.Module], max_norm: float):
    """clip_grad_norm_ per network (the reference clips each separately),
    in place, with mdm_tpu's scale min(1, max_norm / max(norm, 1e-6)); no
    host sync."""
    if max_norm <= 0:
        return
    for net in networks.values():
        grads = [p.grad for p in net.parameters() if p.grad is not None]
        norm = torch.linalg.vector_norm(torch.stack([torch.linalg.vector_norm(g) for g in grads]))
        scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-6), max=1.0)
        for g in grads:
            g.mul_(scale)


def contrastive_loss(emb_a, emb_b, label, margin: float):
    """Hadsell-Chopra-LeCun (reference modules.py:11-24): label 0 pulls the
    pair together, label 1 pushes beyond `margin`. Torch pairwise_distance
    adds eps=1e-6 to the difference before the norm — kept for parity."""
    dist = torch.linalg.vector_norm(emb_a - emb_b + 1e-6, dim=-1)
    pos = (1.0 - label) * dist ** 2
    neg = label * torch.clamp(margin - dist, min=0.0) ** 2
    return torch.mean(pos + neg)


def _adam(params: nn.Module, config: EvalTrainConfig) -> torch.optim.Adam:
    return torch.optim.Adam(params.parameters(), lr=config.lr, betas=(0.9, 0.999), eps=1e-8)


def _update(opt, loss, clip: Mapping[str, nn.Module], max_norm: float):
    opt.zero_grad(set_to_none=True)
    loss.backward()
    _clip_per_network(clip, max_norm)
    opt.step()


# ---------------------------------------------------------------------------
# Decomposition (movement autoencoder)
# ---------------------------------------------------------------------------

def make_decomp_step(enc: MovementConvEncoder, dec: MovementConvDecoder,
                     config: EvalTrainConfig = EvalTrainConfig()):
    """Decomposition train step.

    batch: motions [B, T, D] (already normalized). Losses per reference
    DecompTrainerV3.backward (trainers.py:60-68): L1 recon on the FULL
    feature vector, latents from features[..., :-4] (foot contacts held
    out), mean|latent| sparsity, L1 latent smoothness. No clip (the
    reference's call is commented out, trainers.py:81).
    """

    def init(seed: int):
        params = reset_seeded(nn.ModuleDict({"enc": enc, "dec": dec}), seed)
        return params, _adam(params, config)

    @f32_math()
    def step(params, opt, motions):
        latents = params["enc"](motions[..., :-4])
        recon = params["dec"](latents)
        loss_rec = torch.mean(torch.abs(recon - motions))
        loss_sparsity = torch.mean(torch.abs(latents))
        loss_smooth = torch.mean(torch.abs(latents[:, 1:] - latents[:, :-1]))
        loss = (loss_rec + config.lambda_sparsity * loss_sparsity
                + config.lambda_smooth * loss_smooth)
        _update(opt, loss, {}, 0.0)
        logs = {"loss": loss, "loss_rec": loss_rec, "loss_sparsity": loss_sparsity,
                "loss_smooth": loss_smooth}
        return params, opt, {k: v.detach() for k, v in logs.items()}

    return init, step


# ---------------------------------------------------------------------------
# Text-motion matching (contrastive)
# ---------------------------------------------------------------------------

def make_match_step(text_enc: TextEncoderBiGRUCo,
                    motion_enc: MotionEncoderBiGRUCo,
                    movement_enc: MovementConvEncoder,
                    config: EvalTrainConfig = EvalTrainConfig()):
    """Contrastive step (reference TextMotionMatchTrainer.forward/
    backward/update, trainers.py:941-998) on top of ``movement_enc``, which
    holds the decomposition stage's frozen weights.

    batch: word_embs [B,L,300], pos_onehot [B,L,15], cap_lens [B],
    motions [B,T,D], m_lens [B], shift (int in [0, B-2] — the reference
    draws np.random.randint(0, B-1) on host per step; shift 0 degenerates
    the negative pairs into the positives, kept as-is). The reference sorts
    by m_lens desc (pack_padded requirement) and aligns text; the shifted
    negative pairing depends on that order, so the same stable sort is
    applied here.
    """
    movement_enc.requires_grad_(False)

    def init(seed: int):
        params = reset_seeded(nn.ModuleDict({"text": text_enc, "motion": motion_enc}), seed)
        return params, _adam(params, config)

    @f32_math()
    def step(params, opt, batch):
        m_lens = batch["m_lens"]
        # np.argsort(...)[::-1] on the host = reversed stable ascending sort
        align = torch.argsort(m_lens, stable=True).flip(0)
        motions = batch["motions"][align]
        with torch.no_grad():
            movements = movement_enc(motions[..., :-4])
        motion_emb = params["motion"](movements, m_lens[align] // config.unit_length)
        text_emb = params["text"](batch["word_embs"], batch["pos_onehot"],
                                  batch["cap_lens"])[align]
        B = text_emb.shape[0]
        zeros = torch.zeros(B, device=text_emb.device)
        loss_pos = contrastive_loss(text_emb, motion_emb, zeros, config.negative_margin)
        new_idx = (torch.arange(B, device=text_emb.device) + batch["shift"]) % B
        loss_neg = contrastive_loss(text_emb, motion_emb[new_idx], zeros + 1.0,
                                    config.negative_margin)
        loss = loss_pos + loss_neg
        _update(opt, loss, params, config.grad_clip)
        logs = {"loss": loss, "loss_pos": loss_pos, "loss_neg": loss_neg}
        return params, opt, {k: v.detach() for k, v in logs.items()}

    return init, step


# ---------------------------------------------------------------------------
# Length estimator
# ---------------------------------------------------------------------------

def make_length_est_step(estimator: MotionLenEstimatorBiGRU,
                         config: EvalTrainConfig = EvalTrainConfig()):
    """Cross-entropy over length buckets m_len // unit_length (reference
    LengthEstTrainer.train inner loop, trainers.py:810-832)."""

    def init(seed: int):
        params = reset_seeded(estimator, seed)
        return params, _adam(params, config)

    @f32_math()
    def step(params, opt, batch):
        logits = params(batch["word_embs"], batch["pos_onehot"], batch["cap_lens"])
        labels = (batch["m_lens"] // config.unit_length).long()
        loss = F.cross_entropy(logits, labels)
        _update(opt, loss, {"est": params}, config.grad_clip)
        return params, opt, {"loss": loss.detach()}

    return init, step


# ---------------------------------------------------------------------------
# a2m action classifier
# ---------------------------------------------------------------------------

def make_a2m_classifier_step(classifier: nn.Module, input_size: int, num_frames: int,
                             config: EvalTrainConfig = EvalTrainConfig(), example_x=None):
    """Cross-entropy trainer of an a2m protocol classifier (anything called
    ``classifier(x, lengths) -> {"yhat": ...}``): Adam, the clip over the
    whole classifier, the loss and the batch accuracy in the logs.
    ``init(seed)`` draws mdm_tpu's initialisers and runs the classifier once
    on ``example_x`` (default [1, num_frames, input_size]; the STGCN takes
    [1, T, V, C]), so a wrong input shape fails before training.

    batch: ``x`` (the classifier's input), ``lengths`` [B], ``y`` [B]."""

    def init(seed: int):
        params = reset_seeded(classifier, seed)
        device = next(params.parameters()).device
        x0 = example_x if example_x is not None else torch.zeros((1, num_frames, input_size))
        with torch.no_grad(), f32_math():
            params(torch.as_tensor(x0).to(device), torch.tensor([num_frames]))
        return params, _adam(params, config)

    @f32_math()
    def step(params, opt, batch):
        yhat = params(batch["x"], batch["lengths"])["yhat"]
        labels = batch["y"].long()
        loss = F.cross_entropy(yhat, labels)
        acc = (yhat.argmax(dim=-1) == labels).float().mean()
        _update(opt, loss, {"clf": params}, config.grad_clip)
        return params, opt, {"loss": loss.detach(), "acc": acc.detach()}

    return init, step


# ---------------------------------------------------------------------------
# Host loops + persistence
# ---------------------------------------------------------------------------

def _numpy_tree(v):
    if isinstance(v, nn.Module):
        return flax_params(v)
    if isinstance(v, Mapping):
        return {k: _numpy_tree(x) for k, x in v.items()}
    if isinstance(v, torch.Tensor):
        return v.detach().cpu().numpy()
    return v


def save_evaluator_params(path: str, params: Dict):
    """Persist evaluator params in mdm_tpu's layout, a pickled dict
    readable by EvaluatorWrapper(params=load_evaluator_params(path)) of
    either package; modules in ``params`` are written as their flax-layout
    parameters."""
    np.save(path, _numpy_tree(params))
    return path


def load_evaluator_params(path: str) -> Dict:
    return np.load(path, allow_pickle=True).item()


def run_training(init, step, batches: Iterable, num_steps: int, seed: int,
                 log_every: int = 100,
                 step_args: Callable[[Dict], tuple] = lambda b: (b,),
                 log: Callable = print):
    """Generic host loop: feed `batches` through the step; the logs are
    read back every ``log_every`` steps only."""
    params, opt = init(seed)
    it = iter(batches)
    logs = None
    for i in range(num_steps):
        params, opt, logs = step(params, opt, *step_args(next(it)))
        if (i + 1) % log_every == 0:
            host = {k: float(v) for k, v in logs.items()}
            log(f"step {i + 1}: " + "  ".join(f"{k}={v:.5f}" for k, v in host.items()))
    return params, logs
