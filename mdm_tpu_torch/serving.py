"""Serving wrapper: build once, generate per request.

Counterpart of mdm_tpu/serving.py (PredictorConfig, Predictor.setup /
predict :18-164) for the ``json`` output. Checkpoint loading is not ported
yet, so the model carries seeded random weights.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch


@dataclass
class PredictorConfig:
    model_path: str = ""  # checkpoint loading is not ported yet: must stay empty
    dataset: str = "humanml"
    guidance_scale: float = 2.5
    num_diffusion_steps: int = 1000
    respacing: str = "50"  # serve the fast 50-step model by default
    max_frames: int = 196
    fps: float = 20.0
    batch_size: int = 1
    text_encoder_type: str = "hash"  # clip / bert: ROADMAP Queue 1 item 7
    latent_dim: int = 512
    layers: int = 8
    compute_dtype: str = "bfloat16"
    device: str = "cuda"


class Predictor:
    """setup() builds the model and warms the pipeline; predict() answers."""

    def __init__(self, config: PredictorConfig = PredictorConfig()):
        self.config = config
        self._ready = False

    def setup(self):
        from .diffusion import Schedule
        from .models import MDM, Conditioning, MDMConfig
        from .sampling import GenerationConfig, MotionGenerator
        from .sampling.text import make_text_embedder

        cfg = self.config
        if cfg.model_path:
            raise NotImplementedError(
                "checkpoint loading is not ported yet (ROADMAP Queue 1 item 5); "
                "leave model_path empty for seeded random weights")
        device = torch.device(cfg.device)
        if device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("PredictorConfig.device is cuda but no CUDA device is visible")
        mcfg = MDMConfig(
            njoints=263 if cfg.dataset == "humanml" else 251, nfeats=1,
            latent_dim=cfg.latent_dim, num_layers=cfg.layers,
            compute_dtype=cfg.compute_dtype,
        )
        self.model = MDM(mcfg).init_weights(torch.Generator().manual_seed(0)).to(device)
        sched = Schedule.create("cosine", cfg.num_diffusion_steps, cfg.respacing)
        self.generator = MotionGenerator(
            self.model, sched, GenerationConfig(guidance_scale=cfg.guidance_scale), cfg.dataset)
        self.embedder = make_text_embedder(cfg.text_encoder_type)
        B, T = cfg.batch_size, cfg.max_frames
        self._cond0 = Conditioning(
            frames_mask=torch.ones((B, T), dtype=torch.bool, device=device),
            text_embed=torch.zeros((B, mcfg.text_dim), device=device),
        )
        self._rng = torch.Generator(device).manual_seed(0)
        # Warm: build the kernels and run the full pipeline once.
        self.generator.generate(self._cond0, B, T, self._rng)
        self._ready = True

    def predict(self, prompt: str, num_repetitions: int = 1, motion_length_sec: float = 6.0,
                seed: Optional[int] = None, output_format: str = "json"):
        if not self._ready:
            raise RuntimeError("call setup() first")
        if output_format != "json":
            raise NotImplementedError(
                f"output_format {output_format!r} is not ported yet: ROADMAP Queue 1 item 12")
        cfg = self.config
        B, T = cfg.batch_size, cfg.max_frames
        n_frames = min(T, int(motion_length_sec * cfg.fps))
        embeds = self.embedder([prompt] * B)
        cond = self._cond0.replace(
            text_embed=torch.from_numpy(embeds["text_embed"]).to(self._cond0.text_embed.device))
        if seed is not None:
            self._rng.manual_seed(seed)
        results = []
        for _ in range(num_repetitions):
            out = self.generator.generate(cond, B, T, self._rng)
            results.append(out["joints"][:, :n_frames].float().cpu().numpy())
        return {
            "prompt": prompt,
            "fps": cfg.fps,
            "joints": [r.tolist() for r in results],
        }
