"""End-to-end generation: conditioning -> features -> joints, on one device.

Counterpart of mdm_tpu/sampling/pipeline.py (GenerationConfig,
load_norm_stats, MotionGenerator :81-515) for single-device DDPM sampling
with exact classifier-free guidance. The denoise loop runs eagerly; on a
CUDA device every encoder layer of every step goes through the hand-written
layer kernel chain.
"""
from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from ..core import hml_codec
from ..diffusion.samplers import SamplerConfig, p_sample_loop
from ..diffusion.schedule import Schedule
from ..models.mdm import MDM, Conditioning, cfg_denoiser

STATS_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "assets", "stats")


def load_norm_stats(dataset: str = "humanml"):
    """Bundled evaluator-family feature stats (assets/stats/{t2m,kit}_*.npy)."""
    prefix = "t2m" if dataset == "humanml" else "kit"
    mean = np.load(os.path.join(STATS_DIR, f"{prefix}_mean.npy"))
    std = np.load(os.path.join(STATS_DIR, f"{prefix}_std.npy"))
    return mean.astype(np.float32), std.astype(np.float32)


@dataclass(frozen=True)
class GenerationConfig:
    guidance_scale: float = 2.5
    sampler: str = "ddpm"  # only ddpm is ported (ROADMAP Queue 1 item 6 has the rest)
    clip_denoised: bool = False


class MotionGenerator:
    """Holds a model and its schedule; samples on the model's device."""

    def __init__(self, model: MDM, sched: Schedule,
                 config: GenerationConfig = GenerationConfig(), dataset: str = "humanml"):
        """Decodes hml_vec features with the bundled t2m/kit stats (the
        training set's own stats come with checkpoint loading, later)."""
        if config.sampler != "ddpm":
            raise NotImplementedError(
                f"sampler {config.sampler!r} is not ported yet: ROADMAP Queue 1 item 6")
        self.model = model.eval()
        self.device = next(model.parameters()).device
        self.sched = sched.to(self.device)
        self.config = config
        self.joints_num = 22 if dataset == "humanml" else 21
        self.mean = self.std = None
        if model.config.data_rep == "hml_vec":
            self.mean, self.std = (torch.from_numpy(s).to(self.device)
                                   for s in load_norm_stats(dataset))

    def _model_fn(self, cond: Conditioning):
        if self.config.guidance_scale != 1.0:
            guided = cfg_denoiser(self.model, self.config.guidance_scale)
            return lambda x, t: guided(x, t, cond)
        return lambda x, t: self.model(x, t, cond)

    @torch.inference_mode()
    def sample_features(
        self,
        cond: Conditioning,
        batch_size: int,
        num_frames: int,
        generator: Optional[torch.Generator] = None,
        inpainting_mask: Optional[torch.Tensor] = None,
        inpainted_motion: Optional[torch.Tensor] = None,
        noise: Optional[torch.Tensor] = None,
        step_noise: Optional[torch.Tensor] = None,
    ) -> torch.Tensor:
        """One diffusion sample: normalized features [B, T, D].

        ``generator`` (on the model's device) draws the initial and per-step
        noise; ``noise`` [B, T, D] and ``step_noise`` [steps, B, T, D]
        replace those draws (parity tests feed both packages the same)."""
        D = self.model.config.input_feats
        if noise is None:
            noise = torch.randn((batch_size, num_frames, D), generator=generator,
                                device=self.device)
        return p_sample_loop(
            self._model_fn(cond.to(self.device)), self.sched, noise.to(self.device),
            generator, SamplerConfig(clip_denoised=self.config.clip_denoised),
            inpainting_mask=inpainting_mask, inpainted_motion=inpainted_motion,
            step_noise=None if step_noise is None else step_noise.to(self.device),
        )

    @torch.inference_mode()
    def features_to_joints(self, feats: torch.Tensor) -> torch.Tensor:
        """Denormalize + decode hml_vec features to joints [B, T, J, 3]."""
        if self.mean is None:
            raise ValueError("features_to_joints needs hml_vec norm stats")
        return hml_codec.recover_from_ric(feats * self.std + self.mean, self.joints_num)

    def generate(self, cond: Conditioning, batch_size: int, num_frames: int,
                 generator: Optional[torch.Generator] = None, **kwargs):
        """Full pipeline -> dict(features, joints)."""
        feats = self.sample_features(cond, batch_size, num_frames, generator, **kwargs)
        out = {"features": feats}
        if self.mean is not None:
            out["joints"] = self.features_to_joints(feats)
        return out
