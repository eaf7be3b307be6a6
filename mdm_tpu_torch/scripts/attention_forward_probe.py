"""The attention forward core (csrc/attention.cu) alone on one GPU.

Prints the card, then one JSON line: each forward instance's registers and
spill bytes (the build's ptxas report) and SASS instruction count
(cuobjdump), and the forward's time on [B, 4, 197, 128] bf16 operands
with an f32 output for B = 1 (one block per query tile: a block's
latency), 64 and 128, with no bias, a full per-head f32 bias, and
in-kernel dropout at rate 0.1. CUDA events, mean of 50 calls after 3 warm.

    python -m mdm_tpu_torch.scripts.attention_forward_probe
"""
from __future__ import annotations

import json
import os
import re
import subprocess
import sys

import torch

from ..ops import _build
from ..ops._chain import attention_fwd, bhsd_view, dropout_args
from ._card import card_line

KERNEL = "attn_fwd_bf16"
H, S, DH = 4, 197, 128


def sass_counts(so) -> dict:
    """{instance: SASS instructions} of every forward instance in the library."""
    tool = os.path.join(os.path.dirname(_build._nvcc()), "cuobjdump")
    sass = subprocess.run([tool, "-sass", str(so)], capture_output=True, text=True,
                          check=True).stdout
    counts, name = {}, None
    for line in sass.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            name = _build.instance_name(m.group(1), KERNEL) if KERNEL in m.group(1) else None
            if name:
                counts[name] = 0
        elif name and re.search(r"/\*[0-9a-f]{4,}\*/\s+\S", line):
            counts[name] += 1
    return counts


def _ms(fn, iters: int = 50) -> float:
    for _ in range(3):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def measure() -> dict:
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    view = bhsd_view(H, S, DH)
    times = {}
    for B in (1, 64, 128):
        q, k, v = (torch.randn(B, H, S, DH, generator=g, device=dev).to(torch.bfloat16)
                   for _ in range(3))
        bias = torch.randn(B, H, S, S, generator=g, device=dev)
        out = torch.empty(B, H, S, DH, device=dev)
        for name, b, strides, drop in (
                ("none", None, (0, 0, 0), dropout_args(None, 0, 0.0)),
                ("full bias", bias, (H * S * S, S * S, S), dropout_args(None, 0, 0.0)),
                ("dropout 0.1", None, (0, 0, 0), dropout_args(None, 5, 0.1))):
            times[f"B={B} {name}"] = _ms(lambda: attention_fwd(q, k, v, view, out, view, B, S, H,
                                                               DH, b, strides, drop))
    return times


def main():
    if not torch.cuda.is_available():
        sys.exit("attention_forward_probe: no CUDA device is visible")
    so = _build.build()
    _build.load_library()
    print(card_line())
    print(json.dumps({"ptxas": _build.ptxas_report(so.with_suffix(".log").read_text(), KERNEL),
                      "sass_instructions": sass_counts(so), "ms": measure()}))


if __name__ == "__main__":
    main()
