"""Where a flagship training layer's time goes, kernel by kernel, on one GPU.

One AUTO training layer, the train attention block (#2 forward, #3
backward) feeding the encoder tail (#4, #5), at B=128, S=197, D=512, H=4,
F=1024, bf16, dropout 0.1 drawn in-kernel, a ragged key-padding mask,
random operands from seed 0. Its forward, then its backward (on a kept
graph), each run 10 times under torch.profiler after 3 warm runs. Prints
the card, then one JSON line: per direction, the device µs per call of
each kernel by name, and their sum.

    python -m mdm_tpu_torch.scripts.train_layer_probe
"""
from __future__ import annotations

import json
import sys

import torch

from ..ops.attention_train_block import fused_train_attention_block
from ..ops.encoder_tail import fused_encoder_tail
from ._card import card_line
from .gemm_probe import kernel_us

B, S, D, H, F, RATE = 128, 197, 512, 4, 1024, 0.1
CALLS = 10


def _operands():
    g = torch.Generator(device="cuda").manual_seed(0)
    r = lambda *s, sc=1.0: (torch.randn(*s, generator=g, device="cuda") * sc)
    bf = lambda t: t.to(torch.bfloat16).requires_grad_()
    x = bf(r(B, S, D))
    block = [bf(r(3 * D, D, sc=D ** -0.5)), bf(r(3 * D, sc=0.1)), bf(r(D, D, sc=D ** -0.5)),
             bf(r(D, sc=0.1))]
    tail = [bf(1 + r(D, sc=0.1)), bf(r(D, sc=0.1)), bf(r(F, D, sc=D ** -0.5)), bf(r(F, sc=0.1)),
            bf(r(D, F, sc=F ** -0.5)), bf(r(D, sc=0.1)), bf(1 + r(D, sc=0.1)), bf(r(D, sc=0.1))]
    mask = torch.zeros(B, S, dtype=torch.bool, device="cuda")
    mask[::3, S - 40:] = True
    return x, block, tail, mask, r(B, S, D).to(torch.bfloat16)


def _layer(x, block, tail, mask):
    attn = fused_train_attention_block(x, *block, H, RATE, 7, key_padding_mask=mask)
    return fused_encoder_tail(x, attn, *tail, RATE, 8)


def _profile(fn) -> dict:
    """Device µs per call of each kernel fn launches, by name, and their sum."""
    per = kernel_us(fn, CALLS, warm=3)
    return dict(sorted(per.items(), key=lambda kv: -kv[1]), total_us=sum(per.values()))


def main():
    if not torch.cuda.is_available():
        sys.exit("train_layer_probe: no CUDA device is visible")
    print(card_line())
    x, block, tail, mask, dz = _operands()
    leaves = [x, *block, *tail]
    with torch.no_grad():
        forward = _profile(lambda: _layer(x, block, tail, mask))
    out = _layer(x, block, tail, mask)
    backward = _profile(lambda: torch.autograd.grad(out, leaves, dz, retain_graph=True))
    print(json.dumps({"shape": dict(B=B, S=S, D=D, H=H, F=F, rate=RATE),
                      "forward_us": forward, "backward_us": backward}))


if __name__ == "__main__":
    main()
