"""Serving wrapper: build once, generate per request.

Counterpart of mdm_tpu/serving.py (PredictorConfig, Predictor.setup /
predict :18-164). ``model_path`` names a checkpoint of the port (a file, or
the run directory that holds them: the highest step is taken), whose EMA
parameters are served when it has them and ``use_ema``; without one the
model carries seeded random weights. The text embedder is
``make_text_embedder(text_encoder_type)`` on the serving device; without
its assets the prompts condition on zeros, as in mdm_tpu. Output formats:
``json`` (joints), ``hik`` (the HumanIK-style dict of
``visualize.joints2smpl.motions2hik``, an SMPL fit per repetition) and
``animation`` (stick-figure videos from ``visualize.plot_script``; a GIF
where ffmpeg is absent).
"""
from __future__ import annotations

import os
import tempfile
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch


@dataclass
class PredictorConfig:
    model_path: str = ""
    dataset: str = "humanml"
    guidance_scale: float = 2.5
    num_diffusion_steps: int = 1000
    respacing: str = "50"  # serve the fast 50-step model by default
    max_frames: int = 196
    fps: float = 20.0
    batch_size: int = 1
    text_encoder_type: str = "clip"
    latent_dim: int = 512
    layers: int = 8
    compute_dtype: str = "bfloat16"
    device: str = "cuda"
    # Prefer the EMA weights when the checkpoint carries them.
    use_ema: bool = True


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
        from .train.checkpoints import find_resume_checkpoint, restore_params_only

        cfg = self.config
        device = torch.device(cfg.device)
        if device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("PredictorConfig.device is cuda but no CUDA device is visible")
        tokens = cfg.text_encoder_type == "bert"  # DistilBERT token memory (utils/factory.py)
        mcfg = MDMConfig(
            njoints=263 if cfg.dataset == "humanml" else 251, nfeats=1,
            latent_dim=cfg.latent_dim, num_layers=cfg.layers,
            compute_dtype=cfg.compute_dtype, text_dim=768 if tokens else 512, text_tokens=tokens,
        )
        self.model = MDM(mcfg).init_weights(torch.Generator().manual_seed(0)).to(device)
        ckpt = cfg.model_path
        if ckpt and os.path.isdir(ckpt) and not os.path.basename(ckpt).startswith("ckpt_"):
            found = find_resume_checkpoint(ckpt)
            ckpt = found[0] if found else ""
        if ckpt and os.path.exists(ckpt):
            restore_params_only(ckpt, self.model, use_ema=cfg.use_ema)
        sched = Schedule.create("cosine", cfg.num_diffusion_steps, cfg.respacing)
        self.generator = MotionGenerator(
            self.model, sched, GenerationConfig(guidance_scale=cfg.guidance_scale), cfg.dataset)
        self.embedder = make_text_embedder(cfg.text_encoder_type, device=device)
        B, T = cfg.batch_size, cfg.max_frames
        self._cond0 = Conditioning(
            frames_mask=torch.ones((B, T), dtype=torch.bool, device=device),
            text_embed=torch.zeros((B, 1, mcfg.text_dim) if tokens else (B, mcfg.text_dim),
                                   device=device),
        )
        self.model_device = device
        self._rng = torch.Generator(device).manual_seed(0)
        # Warm: build the kernels and run the full pipeline once.
        self.generator.generate(self._cond0, B, T, self._rng)
        self._ready = True

    def predict(self, prompt: str, num_repetitions: int = 1, motion_length_sec: float = 6.0,
                seed: Optional[int] = None, output_format: str = "json", output_dir: str = ""):
        """``output_format``: json | hik | animation; ``output_dir`` (default
        a directory under the system's temporary one) holds the animations."""
        if not self._ready:
            raise RuntimeError("call setup() first")
        if output_format not in ("json", "hik", "animation"):
            raise ValueError(f"output_format {output_format!r}: json, hik or animation")
        cfg = self.config
        B, T = cfg.batch_size, cfg.max_frames
        n_frames = min(T, int(motion_length_sec * cfg.fps))
        cond = self._cond0
        if self.embedder is not None:
            device = cond.text_embed.device
            cond = cond.replace(**{k: torch.as_tensor(v).to(device)
                                   for k, v in self.embedder([prompt] * B).items()})
        if seed is not None:
            self._rng.manual_seed(seed)
        results = []
        for _ in range(num_repetitions):
            out = self.generator.generate(cond, B, T, self._rng)
            results.append(out["joints"][:, :n_frames].float().cpu().numpy())
        if output_format == "hik":
            # the reference predictor's json_file output (sample/predict.py:143-145)
            from .visualize.joints2smpl import motions2hik

            return motions2hik(np.concatenate(results, axis=0), device=self.model_device)
        if output_format == "animation":
            from .visualize.plot_script import plot_3d_motion

            output_dir = output_dir or os.path.join(tempfile.gettempdir(), "mdm_tpu_torch_serve")
            os.makedirs(output_dir, exist_ok=True)
            return {"animations": [
                plot_3d_motion(os.path.join(output_dir, f"pred_{r}.mp4"), joints[0],
                               title=prompt, dataset=cfg.dataset, fps=cfg.fps)
                for r, joints in enumerate(results)]}
        return {
            "prompt": prompt,
            "fps": cfg.fps,
            "joints": [r.tolist() for r in results],
        }
