"""The operations and bytes that the benchmark's work needs, counted from
its shapes, and the least time the card could take for them.

Conventions (those of the port's kernel table, which they reproduce):

- a product of [M, K] by [K, N] is 2 M K N operations and reads each input
  once and writes its output once; its backward is two products of the
  same size (dX and dW), nothing recomputed;
- attention is 4 H Dh operations for every (query, key) pair that the
  inputs need: a padded key is not needed, nor is a padded row, so only
  the valid rows of a masked sequence are counted; its backward is twice
  its forward; it reads q, k and v and writes its output (the backward
  reads q, k, v, the output and its gradient and writes three gradients);
- the least time of a piece is the larger of its operations over the
  dtype's peak and its bytes over the memory's peak (``peaks.json``).

A ``Work`` adds pieces under a layer's name (``products`` for the port's
product kernels, ``attention`` for its attention core, ``other`` for what
runs outside them), so that a metric divides the least time of one layer
by the device time of that layer's kernels, and the model's operations by
the chip's peak.
"""
from __future__ import annotations

import json
import os
from collections import defaultdict
from typing import Dict, Iterable, Sequence

PEAKS = json.load(open(os.path.join(os.path.dirname(os.path.abspath(__file__)), "peaks.json")))
BYTES = {"bfloat16": 2, "float32": 4}


def peak_flops(dtype: str) -> float:
    return PEAKS["flops_per_s"][dtype]


def least_time(flops: float, nbytes: float, dtype: str) -> float:
    return max(flops / peak_flops(dtype), nbytes / PEAKS["hbm_bytes_per_s"])


class Work:
    """Operations, bytes and least time, summed per layer."""

    def __init__(self):
        self.flops: Dict[str, float] = defaultdict(float)
        self.bytes: Dict[str, float] = defaultdict(float)
        self.least_s: Dict[str, float] = defaultdict(float)

    def add(self, layer: str, flops: float, nbytes: float, dtype: str, times: float = 1.0):
        self.flops[layer] += flops * times
        self.bytes[layer] += nbytes * times
        self.least_s[layer] += least_time(flops, nbytes, dtype) * times

    def product(self, layer: str, M: int, K: int, N: int, dtype: str, train: bool = False,
                times: float = 1.0):
        e = BYTES[dtype]
        self.add(layer, 2.0 * M * K * N, e * (M * K + K * N + M * N), dtype, times)
        if train:  # dX [M, K] from dY [M, N] and W; dW [N, K] from dY and X
            self.add(layer, 2.0 * M * K * N, e * (M * N + N * K + M * K), dtype, times)
            self.add(layer, 2.0 * M * K * N, e * (M * N + M * K + N * K), dtype, times)

    def attention(self, layer: str, pairs: float, q_rows: int, kv_rows: int, D: int, dtype: str,
                  train: bool = False, times: float = 1.0):
        """``pairs``: the (query, key) pairs needed, summed over the batch and
        over the heads' shared positions; q_rows / kv_rows: the rows read."""
        e = BYTES[dtype]
        self.add(layer, 4.0 * D * pairs, e * D * (2 * q_rows + 2 * kv_rows), dtype, times)
        if train:
            self.add(layer, 8.0 * D * pairs, e * D * (4 * q_rows + 4 * kv_rows), dtype, times)

    def total_flops(self) -> float:
        return sum(self.flops.values())

    def merge(self, other: "Work") -> "Work":
        for d, src in ((self.flops, other.flops), (self.bytes, other.bytes),
                       (self.least_s, other.least_s)):
            for k, v in src.items():
                d[k] += v
        return self


def encoder_layer(work: Work, rows: int, pairs: float, D: int, F: int, dtype: str,
                  train: bool = False, times: float = 1.0):
    """One post-LN encoder layer over ``rows`` valid rows: four products on
    the product kernels, the attention core."""
    for K, N in ((D, 3 * D), (D, D), (D, F), (F, D)):
        work.product("products", rows, K, N, dtype, train, times)
    work.attention("attention", pairs, rows, rows, D, dtype, train, times)


def _pairs(lengths: Iterable[int]) -> float:
    return float(sum(n * n for n in lengths))


def mdm_forward(work: Work, cfg: dict, dtype: str, lengths: Sequence[int], train: bool = False,
                memory_lengths: Sequence[int] = (), times: float = 1.0):
    """One denoiser forward (and its backward when ``train``) over a batch
    whose samples have ``lengths`` valid positions in the transformer (the
    condition token included for trans_enc); ``memory_lengths``: trans_dec's
    real text tokens a sample."""
    D, F, L = cfg["latent_dim"], cfg["ff_size"], cfg["num_layers"]
    feats = cfg["njoints"] * cfg["nfeats"]
    rows, B = sum(lengths), len(lengths)
    frames = rows - (B if cfg["arch"] == "trans_enc" else 0)
    # the pose embedding and the output projection, the time MLP and the
    # text projection: float32 torch products outside the port's kernels
    work.product("other", frames, feats, D, "float32", train, times)
    work.product("other", frames, D, feats, "float32", train, times)
    work.product("other", B, D, D, "float32", train, 2 * times)
    text_rows = sum(memory_lengths) if cfg["arch"] == "trans_dec" else B
    work.product("other", text_rows, cfg["text_dim"], D, "float32", train, times)
    if cfg["arch"] == "trans_enc":
        encoder_layer(work, rows, _pairs(lengths), D, F, dtype, train, L * times)
        return work
    # trans_dec: self-attention and the tail as the encoder's, then the
    # cross-attention (torch products and einsum) over the text tokens
    encoder_layer(work, rows, _pairs(lengths), D, F, dtype, train, L * times)
    cross_pairs = float(sum(n * m for n, m in zip(lengths, memory_lengths)))
    for r, K, N in ((rows, D, D), (text_rows, D, 2 * D), (rows, D, D)):
        work.product("other", r, K, N, dtype, train, L * times)
    work.attention("other", cross_pairs, rows, text_rows, D, dtype, train, L * times)
    return work


def clip_forward(work: Work, cfg: dict, lengths: Sequence[int], times: float = 1.0):
    """CLIP's text tower over prompts of ``lengths`` tokens (start and end
    included): the positions up to the end token, which the pooled state
    depends on, causally. All of it runs outside the port's kernels."""
    w, rows = cfg["width"], sum(lengths)
    for K, N in ((w, 3 * w), (w, w), (w, 4 * w), (4 * w, w)):
        work.product("other", rows, K, N, "float32", times=cfg["layers"] * times)
    causal = float(sum(n * (n + 1) // 2 for n in lengths))
    work.attention("other", causal, rows, rows, w, "float32", times=cfg["layers"] * times)
    work.product("other", len(lengths), w, cfg["embed_dim"], "float32", times=times)
    return work


def distilbert_forward(work: Work, cfg: dict, lengths: Sequence[int], times: float = 1.0):
    """DistilBERT over prompts of ``lengths`` real tokens: its attention
    block (projections and core) on the port's kernels in float32, its FFN
    as torch products."""
    d, h, rows = cfg["dim"], cfg["hidden_dim"], sum(lengths)
    n = cfg["n_layers"] * times
    work.product("products", rows, d, 3 * d, "float32", times=n)
    work.product("products", rows, d, d, "float32", times=n)
    work.attention("attention", _pairs(lengths), rows, rows, d, "float32", times=n)
    work.product("other", rows, d, h, "float32", times=n)
    work.product("other", rows, h, d, "float32", times=n)
    return work
