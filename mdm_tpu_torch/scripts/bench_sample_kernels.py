"""Sampling attention-kernel shootout on one GPU.

Counterpart of scripts/bench_sample_kernels.py: ``MotionGenerator.generate``
at the flagship denoiser (latent 512, 8 layers, 4 heads, ff 1024, bf16,
random weights from seed 0), T=196, CFG 2.5, with the kernel flags of
``mdm_tpu_torch.ops`` pinned as each variant of the JAX script pins them:

  xla     einsum attention and the plain LN/FFN tail
  pallas  fused_attention_v2 (#11) and fused_encoder_tail_inference (#4, rate 0)
  block   the rate-0 attention block (#2) and the plain tail
  tail    the rate-0 attention block and fused_encoder_tail_inference
  layer   the whole-layer kernel (#1), the AUTO route

Seconds per sample are the slope between two timed runs of n1 and n2
generations (host clock, each run ending in a synchronise), after two warm
ones. ``--sampler`` picks ddpm, ddim, plms or dpmpp_2m. One variant per
process:

    python -m mdm_tpu_torch.scripts.bench_sample_kernels --variant pallas --batch 32
"""
from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import torch

from .. import ops
from ..diffusion import SAMPLERS, Schedule
from ..models import MDM, Conditioning, MDMConfig
from ..sampling import GenerationConfig, MotionGenerator
from ._card import card_line

VARIANTS = {
    "xla": dict(sample_block=False, encoder_tail=False),
    "pallas": dict(sample_block=False, attention=True),
    "block": dict(sample_block=True, encoder_tail=False),
    "tail": dict(sample_block=True, encoder_tail=True, layer_inference=False),
    "layer": dict(sample_block=True, encoder_tail=True, layer_inference=True),
}
FLAGSHIP = MDMConfig(njoints=263, nfeats=1, latent_dim=512, ff_size=1024, num_layers=8,
                     num_heads=4, compute_dtype="bfloat16")
FRAMES = 196


def make_generator(batch: int, steps: int = 50, sampler: str = "ddpm", device="cuda"):
    """(MotionGenerator, Conditioning) of the shootout: seeded weights and
    text embeddings, all frames valid."""
    model = MDM(FLAGSHIP).init_weights(torch.Generator().manual_seed(0)).to(device)
    gen = MotionGenerator(model, Schedule.create("cosine", 1000, str(steps)),
                          GenerationConfig(guidance_scale=2.5, sampler=sampler))
    text = np.random.default_rng(0).normal(size=(batch, 512)).astype(np.float32)
    cond = Conditioning(frames_mask=torch.ones(batch, FRAMES, dtype=torch.bool, device=device),
                        text_embed=torch.from_numpy(text).to(device))
    return gen, cond


def measure(variant: str, batch: int = 128, steps: int = 50, sampler: str = "ddpm",
            n1: int = 3, n2: int = 13, device="cuda") -> dict:
    """The shootout's JSON record of one variant."""
    device = torch.device(device)
    with ops.pinned(**VARIANTS[variant]):
        gen, cond = make_generator(batch, steps, sampler, device)
        seed = iter(range(2 + n1 + n2))

        def run(k):
            t0 = time.perf_counter()
            for _ in range(k):
                g = torch.Generator(device).manual_seed(next(seed))
                gen.generate(cond, batch, FRAMES, g)
            if device.type == "cuda":
                torch.cuda.synchronize(device)
            return time.perf_counter() - t0

        run(2)
        t1, t2 = run(n1), run(n2)
    sec = (t2 - t1) / ((n2 - n1) * batch)
    return {"variant": variant, "B": batch, "sampler": sampler, "steps": steps,
            "ms_per_sample": sec * 1e3, "s_per_batch": sec * batch,
            "device": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"}


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--variant", choices=sorted(VARIANTS), required=True)
    ap.add_argument("--batch", type=int, default=128)
    ap.add_argument("--sampler", default="ddpm", choices=sorted(SAMPLERS))
    ap.add_argument("--steps", type=int, default=50, help="respaced step count")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("bench_sample_kernels: no CUDA device is visible")
    torch.backends.cuda.matmul.allow_tf32 = False
    print(card_line())
    print(json.dumps(measure(args.variant, args.batch, args.steps, args.sampler)))


if __name__ == "__main__":
    main()
