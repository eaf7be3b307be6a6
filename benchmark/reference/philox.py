"""A frozen copy of the dropout bit stream that the program's training
kernels draw: Philox4x32-10 (Salmon et al., SC'11), word 0 of
Philox(counter = (column, row, site, batch), key = (seed, 0)) for every
element, in int64 arithmetic. ``site`` is the head for attention
probabilities, 0 for the input-sequence mask, and 0 / 1 / 2 for the
layer tail's attn-out / ffn-hidden / ffn-out masks. An element is kept
where its word is below ``keep_threshold(rate)`` and scaled by
1 / (1 - rate) rounded to float32.
"""
from __future__ import annotations

import numpy as np
import torch

_M0, _M1 = 0xD2511F53, 0xCD9E8D57
_W0, _W1 = 0x9E3779B9, 0xBB67AE85
_MASK32 = 0xFFFFFFFF


def keep_threshold(rate: float) -> int:
    return min(int(round((1.0 - rate) * 2.0 ** 32)), 2 ** 32 - 1)


def _mulhilo(m: int, c: torch.Tensor):
    p_lo = m * (c & 0xFFFF)
    p_hi = m * (c >> 16)
    t = ((p_hi & 0xFFFF) << 16) + p_lo
    return (p_hi >> 16) + (t >> 32), t & _MASK32


def philox_word0(c0, c1, c2, c3, seed: int) -> torch.Tensor:
    k0, k1 = int(seed) & _MASK32, 0
    for r in range(10):
        if r:
            k0, k1 = (k0 + _W0) & _MASK32, (k1 + _W1) & _MASK32
        hi0, lo0 = _mulhilo(_M0, c0)
        hi1, lo1 = _mulhilo(_M1, c2)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
    return c0


def bits(seed: int, batch: int, sites, rows: int, cols: int, device) -> torch.Tensor:
    """int64 words [batch, *sites.shape, rows, cols]; ``sites`` an int or a
    1-d sequence of sites (the heads)."""
    site = torch.as_tensor(sites, dtype=torch.int64, device=device)
    b = torch.arange(batch, dtype=torch.int64, device=device)
    b = b.reshape((batch,) + (1,) * (site.dim() + 2))
    site = site.reshape((1,) + tuple(site.shape) + (1, 1))
    r = torch.arange(rows, dtype=torch.int64, device=device)[:, None]
    c = torch.arange(cols, dtype=torch.int64, device=device)[None, :]
    return philox_word0(c, r, site, b, seed)


def keep_factors(seed: int, batch: int, sites, rows: int, cols: int, rate: float,
                 device) -> torch.Tensor:
    """float32 keep factors: 1 / (1 - rate) where kept, else 0."""
    kept = bits(seed, batch, sites, rows, cols, device) < keep_threshold(rate)
    return torch.where(kept, float(np.float32(1.0 / (1.0 - rate))), 0.0).float()
