"""Where a flagship training layer's time goes, kernel by kernel, on one GPU.

One AUTO training layer, the train attention block (#2 forward, #3
backward) feeding the encoder tail (#4, #5), at B=128, S=197, D=512, H=4,
F=1024, bf16, dropout 0.1 drawn in-kernel, a ragged key-padding mask,
random operands from seed 0. Its forward, then its backward (on a kept
graph), each run 10 times under torch.profiler after 3 warm runs. Then
the tail alone (#4, #5) on the same operands at rate 0.1 (bits drawn
in-kernel) and at rate 0 (mode 0: no draws, no masks), forward and
backward: the difference of the two is what the draws and the masks cost.
For each, the tail's row kernels' (``tail_*``) device µs, the bytes they
must move (each input read once, each output written once) and their
achieved GB/s against the H100's 3.35 TB/s. Prints the card, then one JSON
line: per direction, the device µs per call of each kernel by name, and
their sum, and the tail's split.

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
HBM_BYTES_PER_S = 3.35e12  # H100 SXM


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


def tail_row_bytes(rate: float) -> dict:
    """Bytes the tail's row kernels must move at the probe's shape, per
    direction: bf16 x, attn, y, hd, z, dz, do16, du16, dx, da; f32 y32, u, o,
    dhd, dy, ds2; with dropout on, the three packed masks ((2D + F) / 8
    bytes a row), written forward and read backward."""
    M = B * S
    masks = M * (2 * D + F) / 8 if rate > 0 else 0
    return {"forward": 20 * M * D + 6 * M * F + masks,
            "backward": 28 * M * D + 10 * M * F + masks}


def _tail_split(x, attn, tail, dz, rate) -> dict:
    """The tail alone at rate: device µs per kernel, forward and backward,
    and its row kernels' achieved rate."""
    leaves = [x, attn, *tail]
    with torch.no_grad():
        forward = _profile(lambda: fused_encoder_tail(x, attn, *tail, rate, 8))
    out = fused_encoder_tail(x, attn, *tail, rate, 8)
    backward = _profile(lambda: torch.autograd.grad(out, leaves, dz, retain_graph=True))
    row = {}
    for name, per, nbytes in (("forward", forward, tail_row_bytes(rate)["forward"]),
                              ("backward", backward, tail_row_bytes(rate)["backward"])):
        us = sum(v for k, v in per.items() if k.startswith("tail_"))
        row[name] = dict(kernels_us=per, row_kernels_us=us, row_bytes=nbytes,
                         row_GBps=nbytes / us / 1e3, row_share_of_hbm=nbytes / (us * 1e-6)
                         / HBM_BYTES_PER_S)
    return row


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
    g = torch.Generator(device="cuda").manual_seed(1)
    attn = torch.randn(B, S, D, generator=g, device="cuda").to(torch.bfloat16).requires_grad_()
    tail_split = {f"rate {r}": _tail_split(x, attn, tail, dz, r) for r in (RATE, 0.0)}
    print(json.dumps({"shape": dict(B=B, S=S, D=D, H=H, F=F, rate=RATE),
                      "forward_us": forward, "backward_us": backward, "tail": tail_split}))


if __name__ == "__main__":
    main()
