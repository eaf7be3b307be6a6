"""Train-step attention-kernel shootout on one GPU.

Counterpart of scripts/bench_train_kernels.py: ``make_train_step`` at the
flagship denoiser (latent 512, 8 layers, 4 heads, ff 1024, bf16, dropout
0.1, random weights from seed 0), B clips of T=196 frames, AdamW lr 1e-4
and EMA, with the kernel flags of ``mdm_tpu_torch.ops`` pinned as each
variant of the JAX script pins them:

  xla    einsum attention with probability dropout, the plain LN/FFN tail
  drop   fused_dropout_attention (#7/#8) between the projections, the plain tail
  block  the train attention block (#2/#3), the plain tail
  tail   the train attention block and fused_encoder_tail (#4/#5), the AUTO route

Milliseconds per step are the slope between two timed runs of n1 and n2
steps (host clock, each run ending in a synchronise), after three warm
ones. One variant per process:

    python -m mdm_tpu_torch.scripts.bench_train_kernels --variant drop
"""
from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import torch

from .. import ops
from ..diffusion import Schedule
from ..models import MDM, Conditioning, MDMConfig
from ..train import OptimConfig, TrainStepConfig, create_train_state, make_train_step, step_key
from ._card import card_line

VARIANTS = {
    "xla": dict(train_block=False, encoder_tail=False),
    "drop": dict(train_block=False, train_attention=True, encoder_tail=False),
    "block": dict(train_block=True, encoder_tail=False),
    "tail": dict(train_block=True, encoder_tail=True),
}
FLAGSHIP = MDMConfig(njoints=263, nfeats=1, latent_dim=512, ff_size=1024, num_layers=8,
                     num_heads=4, compute_dtype="bfloat16", dropout=0.1)
FRAMES = 196


def make_trainer(batch: int, device="cuda", lr: float = 1e-4):
    """(train state, step function, batch) of the shootout: seeded weights
    and a fixed batch of normal features with a zero text embedding."""
    model = MDM(FLAGSHIP).init_weights(torch.Generator().manual_seed(0)).to(device)
    optim = OptimConfig(lr=lr)
    step = make_train_step(Schedule.create("cosine", 1000).to(device), TrainStepConfig(optim=optim))
    x = np.random.default_rng(0).normal(size=(batch, FRAMES, FLAGSHIP.njoints))
    data = {"x": torch.from_numpy(x.astype(np.float32)).to(device),
            "mask": torch.ones(batch, FRAMES, dtype=torch.bool, device=device),
            "cond": Conditioning(frames_mask=torch.ones(batch, FRAMES, dtype=torch.bool,
                                                        device=device),
                                 text_embed=torch.zeros(batch, 512, device=device))}
    return create_train_state(model, optim), step, data


def measure(variant: str, batch: int = 128, n1: int = 10, n2: int = 40, device="cuda") -> dict:
    """The shootout's JSON record of one variant."""
    device = torch.device(device)
    with ops.pinned(**VARIANTS[variant]):
        state, step, data = make_trainer(batch, device)
        box = {"i": 0}

        def run(k):
            t0 = time.perf_counter()
            for _ in range(k):
                step(state, data, step_key(1, box["i"]))
                box["i"] += 1
            if device.type == "cuda":
                torch.cuda.synchronize(device)
            return time.perf_counter() - t0

        run(3)
        t1, t2 = run(n1), run(n2)
    dt = (t2 - t1) / (n2 - n1)
    return {"variant": variant, "B": batch, "ms_per_step": dt * 1e3, "samples_per_s": batch / dt,
            "device": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"}


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--variant", choices=sorted(VARIANTS), required=True)
    ap.add_argument("--batch", type=int, default=128)
    ap.add_argument("--n1", type=int, default=10)
    ap.add_argument("--n2", type=int, default=40)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("bench_train_kernels: no CUDA device is visible")
    torch.backends.cuda.matmul.allow_tf32 = False
    print(card_line())
    print(json.dumps(measure(args.variant, args.batch, args.n1, args.n2)))


if __name__ == "__main__":
    main()
