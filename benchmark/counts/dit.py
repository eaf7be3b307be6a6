"""The operations and bytes of DiT's denoiser forward (``arch="dit"``), by
``flops.py``'s conventions: only the valid rows of a masked sequence and
the (query, key) pairs the masks leave are counted, each product's inputs
read once and its output written once.

Layers of the ``Work``:

- ``products``: the four products of every block (qkv, proj, fc1, fc2) and
  the one product before the layer loop that gives every block's and the
  final layer's modulation ([samples, d] x [d, L 6d + 2d], f32 out), all on
  the wgmma kernel;
- ``attention``: the attention core, 4 d operations a (query, key) pair;
- ``adaln``: the adaptive LayerNorm row kernel: the first call of a
  forward reads x and writes h, each of the 2L after it reads x and y and
  writes x' and h, in the working dtype, and each reads its sample's f32
  shift, scale (and gate) rows; about 10 operations a value, so its bytes
  bind it;
- ``other``: the float32 torch products outside the port's kernels (the
  frame embedding, the timestep MLP, the text projection, the output).
"""
from __future__ import annotations

from typing import Sequence

from benchmark.counts.flops import BYTES, Work, _pairs

ADALN_OPS = 10.0  # a value's operations: the gated residual, the two-pass statistics, the modulation
FREQ_DIM = 256


def adaln(work: Work, rows: int, samples: int, d: int, dtype: str, residual: bool,
          times: float = 1.0) -> None:
    """One call of the row kernel over ``rows`` valid rows of ``samples``
    samples."""
    e = BYTES[dtype]
    tensors, vectors = (4, 3) if residual else (2, 2)
    work.add("adaln", ADALN_OPS * rows * d, tensors * e * rows * d + vectors * 4 * samples * d,
             dtype, times)


def dit_forward(work: Work, cfg: dict, dtype: str, lengths: Sequence[int],
                times: float = 1.0) -> Work:
    """One DiT forward over a batch whose samples have ``lengths`` valid
    frames (one token a frame, no condition token)."""
    d, f, L = cfg["latent_dim"], cfg["ff_size"], cfg["num_layers"]
    feats = cfg["njoints"] * cfg["nfeats"]
    rows, B = sum(lengths), len(lengths)
    for K, N in ((d, 3 * d), (d, d), (d, f), (f, d)):
        work.product("products", rows, K, N, dtype, times=L * times)
    n_mod = L * 6 * d + 2 * d  # the modulation product, stored in f32
    work.add("products", 2.0 * B * d * n_mod, BYTES[dtype] * (B * d + d * n_mod) + 4 * B * n_mod,
             dtype, times)
    work.attention("attention", _pairs(lengths), rows, rows, d, dtype, times=L * times)
    adaln(work, rows, B, d, dtype, residual=False, times=times)
    adaln(work, rows, B, d, dtype, residual=True, times=2 * L * times)
    work.product("other", rows, feats, d, "float32", times=times)
    work.product("other", rows, d, feats, "float32", times=times)
    work.product("other", B, FREQ_DIM, d, "float32", times=times)
    work.product("other", B, d, d, "float32", times=times)
    work.product("other", B, cfg["text_dim"], d, "float32", times=times)
    return work
