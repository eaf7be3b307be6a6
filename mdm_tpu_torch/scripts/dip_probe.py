"""DiP autoregressive generation on one GPU: time per batch and where it goes.

``MotionGenerator.generate`` on the DiP configuration: the trans_dec
denoiser at the flagship width (latent 512, 8 layers, 4 heads, ff 1024,
bf16, random weights from seed 0) on DistilBERT-shaped token memory (64
tokens, BertTextEmbedder's max_len, with a ragged token mask), a 20-frame
prefix, 40-frame chunks, 10 respaced cosine steps at CFG 7.5, 196 frames
(5 chunks). For each batch size: one warm call, then ``--runs`` calls
timed with CUDA events; with ``--profile``, one more under
torch.profiler: the card's busy share (its kernels' device time over the
unprofiled wall time) and the host operations that take the most CPU
time. Prints the card, then one JSON line.

    python -m mdm_tpu_torch.scripts.dip_probe [--batch 1 32] [--profile]
"""
from __future__ import annotations

import argparse
import json
import sys

import torch

from ..diffusion import Schedule
from ..models import MDM, Conditioning, MDMConfig
from ..sampling import GenerationConfig, MotionGenerator
from ._card import card_line

DIP = MDMConfig(njoints=263, nfeats=1, latent_dim=512, ff_size=1024, num_layers=8, num_heads=4,
                compute_dtype="bfloat16", arch="trans_dec", text_dim=768, text_tokens=True,
                mask_frames=True, context_len=20, pred_len=40)
TOKENS, STEPS, GUIDANCE, FRAMES = 64, 10, 7.5, 196


def make_generator(device="cuda", sampler: str = "ddpm") -> MotionGenerator:
    model = MDM(DIP).init_weights(torch.Generator().manual_seed(0)).to(device)
    return MotionGenerator(model, Schedule.create("cosine", 1000, str(STEPS)), GenerationConfig(
        guidance_scale=GUIDANCE, sampler=sampler, autoregressive=True))


def make_cond(batch: int, device="cuda", seed: int = 0) -> Conditioning:
    """Token states with a ragged token mask (sample b has 1 + 13b mod 64
    tokens), a prefix, and a frame mask over the predicted frames with the
    last 7 padded in every third sample."""
    g = torch.Generator().manual_seed(seed)
    pred = DIP.pred_len
    frames = torch.ones(batch, pred, dtype=torch.bool)
    frames[::3, pred - 7:] = False
    tokens = 1 + (13 * torch.arange(batch)) % TOKENS
    return Conditioning(
        frames_mask=frames, text_embed=torch.randn(batch, TOKENS, 768, generator=g),
        text_tokens_mask=torch.arange(TOKENS)[None] < tokens[:, None],
        prefix=torch.randn(batch, DIP.context_len, DIP.input_feats, generator=g)).to(device)


def _timed_ms(fn) -> float:
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end)


def _profiled(fn, top: int = 12) -> dict:
    """One call under torch.profiler: its kernels' device ms, its dtype
    copies, and the host operations with the most self CPU time (calls, ms)."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    events = prof.key_averages()
    host = sorted(events, key=lambda e: -e.self_cpu_time_total)[:top]
    return dict(device_ms=sum(e.self_device_time_total for e in events) / 1e3,
                dtype_copies=sum(e.count for e in events if e.key == "aten::_to_copy"),
                host_ops={e.key: [e.count, e.self_cpu_time_total / 1e3] for e in host})


def measure(batch: int, runs: int = 3, profile: bool = False, gen=None) -> dict:
    gen = gen or make_generator()
    cond = make_cond(batch, seed=batch)
    call = lambda seed: gen.generate(cond, batch, FRAMES, torch.Generator("cuda").manual_seed(seed))
    call(0)
    torch.cuda.synchronize()
    ms = [_timed_ms(lambda: call(1 + r)) for r in range(runs)]
    layer_calls = -(-FRAMES // DIP.pred_len) * STEPS * DIP.num_layers
    row = dict(B=batch, ms_per_batch=ms, s_per_sample=min(ms) / 1000 / batch,
               ms_per_layer_call=min(ms) / layer_calls)
    if profile:
        prof = _profiled(lambda: call(0))
        row.update(prof, device_busy=prof["device_ms"] / min(ms))
    return row


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batch", type=int, nargs="+", default=[1, 32])
    ap.add_argument("--runs", type=int, default=3)
    ap.add_argument("--profile", action="store_true", help="the busy share and host operations")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("dip_probe: no CUDA device is visible")
    print(card_line())
    gen = make_generator()
    rows = [measure(b, args.runs, args.profile, gen) for b in args.batch]
    print(json.dumps({"device": torch.cuda.get_device_name(0), "dip": rows}))


if __name__ == "__main__":
    main()
