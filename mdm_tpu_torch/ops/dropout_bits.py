"""The dropout bit stream of the training kernels, and its two dump entry points.

The TPU kernels seed the hardware PRNG with ``seed + program_id(0)`` and
draw bits in a fixed per-cell order (mdm_tpu/ops/attention_train_block.py,
encoder_tail.py). On Hopper every element draws its own word from
Philox4x32-10 (``csrc/philox.cuh``), keyed on the int32 ``seed`` with the
counter (column, row, site, batch index): an element's bits depend on its
coordinates only, never on a tile or thread, so the backward kernels replay
the forward's mask whatever their tiling. ``site`` is the head in the
attention block and 0/1/2 for the tail's attn-out/ffn-hidden/ffn-out masks.

``philox_bits`` is the plain PyTorch version of that generator (int64
arithmetic, exact). The dumps replace the TPU test kernels
``attention_dropout.py::dropout_bits`` and ``encoder_tail.py::tail_dropout_bits``
and keep their layouts; they pin the in-kernel stream against the
injected-bits path, and give the plain routes their masks. A third dump,
``sequence_dropout_bits``, gives MDM's input-sequence dropout its mask
from the same stream. The keep rule is ``_keep_threshold``'s: keep where
``bits < t`` with ``t = min(round((1 - rate) 2^32), 2^32 - 1)``.

The dumps run on the card unless the caller asks for the CPU
(``device="cpu"``), where they return ``philox_bits``. On the card each
entry point is one launch of ``csrc/dropout_bits.cu::philox_dump``, the
tail's three outputs included, and counts one in ``LAUNCHES``.

Every entry point takes ``batch_offset``, added to the counter's batch
word: a data-parallel rank that holds the global rows [b0, b0 + n) passes
b0 and gets exactly those rows of the whole batch's words (the counterpart
of mdm_tpu/ops/__init__.py::shard_seed_offset, for every dropout site).
Under tensor parallelism a rank holds heads [h0, h0 + H) of an attention
and FFN columns [f0, f0 + F) of a layer: ``dropout_bits``' ``head_offset``
h0 is added to the site word (the heads are the sites) and
``tail_dropout_bits``' ``ffn_offset`` f0 to the column word of site 1, the
FFN-hidden mask, so the rank's words are exactly its slice of the whole
layer's. Sites 0 and 2 are [B, S, D], whole on every rank, and do not move.
At offset 0 every word is the one before.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from . import _build

LAUNCHES = {"dropout_bits": 0, "tail_dropout_bits": 0, "sequence_dropout_bits": 0}

_M0, _M1 = 0xD2511F53, 0xCD9E8D57
_W0, _W1 = 0x9E3779B9, 0xBB67AE85
_MASK32 = 0xFFFFFFFF


def keep_threshold(rate: float) -> int:
    """uint32 threshold t with P(bits < t) == 1 - rate."""
    return min(int(round((1.0 - rate) * 2.0 ** 32)), 2 ** 32 - 1)


def keep_factors(bits: torch.Tensor, rate: float) -> torch.Tensor:
    """f32 keep factor of each element: 1/(1-rate) where bits < t, else 0."""
    inv_keep = float(np.float32(1.0 / (1.0 - rate)))
    kept = bits.to(torch.int64) < keep_threshold(rate)  # uint32 has no CPU compare
    return torch.where(kept, inv_keep, 0.0).to(torch.float32)


def keep_mask_bits(bits: torch.Tensor, rate: float) -> torch.Tensor:
    """The packed keep mask of bits [..., n]: uint32 [..., ceil(n / 32)]
    with bit c % 32 of word c // 32 set where element c is kept (bits < t),
    the bits past n clear. The encoder tail's forward stores each dropout
    site's keep decisions so (csrc/encoder_tail.cu), and its backward reads
    them instead of drawing again."""
    kept = (bits.to(torch.int64) < keep_threshold(rate)).to(torch.int64)
    n = kept.shape[-1]
    kept = torch.nn.functional.pad(kept, (0, -n % 32))
    words = (kept.unflatten(-1, (-1, 32)) << torch.arange(32, device=bits.device)).sum(-1)
    return words.to(torch.uint32)


def _mulhilo(m: int, c: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(hi, lo) 32-bit halves of m * c for uint32 values held in int64."""
    p_lo = m * (c & 0xFFFF)
    p_hi = m * (c >> 16)
    t = ((p_hi & 0xFFFF) << 16) + p_lo
    return (p_hi >> 16) + (t >> 32), t & _MASK32


def philox4x32(counter, key) -> Tuple[torch.Tensor, ...]:
    """Philox4x32-10 on int64 tensors holding uint32 words (Salmon et al.,
    SC'11): ``counter`` four broadcastable tensors, ``key`` two ints."""
    c0, c1, c2, c3 = (torch.as_tensor(c, dtype=torch.int64) for c in counter)
    k0, k1 = key[0] & _MASK32, key[1] & _MASK32
    for r in range(10):
        if r:
            k0, k1 = (k0 + _W0) & _MASK32, (k1 + _W1) & _MASK32
        hi0, lo0 = _mulhilo(_M0, c0)
        hi1, lo1 = _mulhilo(_M1, c2)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
    return c0, c1, c2, c3


def philox_bits(seed: int, b: torch.Tensor, site, rows: int, cols: int,
                device=None, batch_offset: int = 0, col_offset: int = 0) -> torch.Tensor:
    """Word 0 of Philox(counter=(col + col_offset, row, site, b +
    batch_offset), key=(seed, 0)) for every (b, site, row, col): b and site
    broadcast against [rows, cols]. Returns int64 holding the uint32 bits,
    shape [*broadcast(b, site), rows, cols]."""
    r = torch.arange(rows, dtype=torch.int64, device=device)[:, None]
    c = (torch.arange(cols, dtype=torch.int64, device=device)[None, :] + col_offset) & _MASK32
    b = (torch.as_tensor(b, dtype=torch.int64, device=device)[..., None, None]
         + batch_offset) & _MASK32
    site = torch.as_tensor(site, dtype=torch.int64, device=device)[..., None, None]
    return philox4x32((c, r, site, b), (int(seed), 0))[0]


def _dump_into(outs, seed: int, B: int, H: int, site: int, R: int, batch_offset: int = 0,
               offset: int = 0) -> None:
    """Fill uint32 card tensors with the stream, in one launch: one output
    [B, H, R, C] at ``site`` (-1: the heads are the sites, from head
    ``offset``; ``mdm_philox_dump``), or the tail's three [B, R, C_s] at
    sites 0, 1 and 2, site 1's columns from ``offset``
    (``mdm_philox_dump3``). Raises on what the kernel cannot take."""
    for o in outs:
        if o.dtype != torch.uint32 or not o.is_contiguous():
            raise ValueError(f"a dump writes contiguous uint32 tensors, not {o.dtype}")
    lib = _build.load_library()
    st = torch.cuda.current_stream(outs[0].device).cuda_stream
    if len(outs) == 1:
        err = lib.mdm_philox_dump(outs[0].data_ptr(), int(seed), int(batch_offset), B, H, site,
                                  R, outs[0].shape[-1], int(offset), st)
    else:
        err = lib.mdm_philox_dump3(*(o.data_ptr() for o in outs), int(seed), int(batch_offset),
                                   B, R, *(o.shape[-1] for o in outs), int(offset), st)
    _build.check(err, "philox dump")


def _dump(name: str, seed: int, B: int, H: int, site: int, R: int, out_shapes, device,
          batch_offset: int, offset: int = 0) -> Tuple[torch.Tensor, ...]:
    outs = tuple(torch.empty(s, dtype=torch.uint32, device=device) for s in out_shapes)
    _dump_into(outs, seed, B, H, site, R, batch_offset, offset)
    LAUNCHES[name] += 1
    return outs


def dropout_bits(seed: int, B: int, num_heads: int, S: int, device="cuda", *,
                 key_len: Optional[int] = None, batch_offset: int = 0,
                 head_offset: int = 0) -> torch.Tensor:
    """[B, H, S, key_len or S] uint32: the bits the attention block draws
    for head h, query row i, key column j (attention_dropout.py::dropout_bits
    layout). ``key_len`` gives a cross-attention its [S, Sk] rows; a word
    is keyed on its coordinates, so the square case's words do not move.
    ``head_offset``: the global index of head 0 (a tensor-parallel rank's
    first head)."""
    device = torch.device(device)
    Sk = S if key_len is None else key_len
    if device.type == "cpu":
        b = torch.arange(B)[:, None]
        h = torch.arange(num_heads)[None, :] + head_offset
        return philox_bits(seed, b, h, S, Sk, batch_offset=batch_offset).to(torch.uint32)
    # site -1: the heads are the sites, out[b, h] holds site h + head_offset.
    return _dump("dropout_bits", seed, B, num_heads, -1, S, [(B, num_heads, S, Sk)], device,
                 batch_offset, head_offset)[0]


def tail_dropout_bits(seed: int, B: int, S: int, D: int, F: int, device="cuda", *,
                      batch_offset: int = 0, ffn_offset: int = 0
                      ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The tail's three masks' bits: attn-out [B,S,D] (site 0), ffn-hidden
    [B,S,F] (site 1), ffn-out [B,S,D] (site 2) (encoder_tail.py layout);
    one launch on the card. ``ffn_offset``: the global index of site 1's
    column 0 (a tensor-parallel rank's first FFN column)."""
    device = torch.device(device)
    shapes = [(B, S, D), (B, S, F), (B, S, D)]
    if device.type == "cpu":
        b = torch.arange(B)
        return tuple(philox_bits(seed, b, site, S, n, batch_offset=batch_offset,
                                 col_offset=ffn_offset if site == 1 else 0).to(torch.uint32)
                     for site, (_, _, n) in enumerate(shapes))
    return _dump("tail_dropout_bits", seed, B, 1, 0, S, shapes, device, batch_offset,
                 ffn_offset)


def sequence_dropout_bits(seed: int, B: int, S: int, D: int, device="cuda", *,
                          batch_offset: int = 0) -> torch.Tensor:
    """[B, S, D] uint32: the bits of MDM's input-sequence dropout, site 0 of
    the stream under its own seed (the layout of the tail's first mask)."""
    device = torch.device(device)
    if device.type == "cpu":
        return philox_bits(seed, torch.arange(B), 0, S, D, batch_offset=batch_offset
                           ).to(torch.uint32)
    return _dump("sequence_dropout_bits", seed, B, 1, 0, S, [(B, S, D)], device,
                 batch_offset)[0]
