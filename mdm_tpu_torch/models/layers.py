"""Transformer building blocks with torch checkpoint layout.

Counterpart of mdm_tpu/models/layers.py. The encoder layer holds
torch.nn.TransformerEncoderLayer's own parameter names
(``self_attn.in_proj_weight`` [3D, D], ``in_proj_bias``,
``self_attn.out_proj``, ``linear1``, ``linear2``, ``norm1``, ``norm2``) and
the decoder layer torch.nn.TransformerDecoderLayer's (``self_attn``,
``multihead_attn`` packed the same way, ``linear1``, ``linear2``,
``norm1``-``norm3``) — the layout mdm_tpu/models/convert.py reads — so
published checkpoints load without conversion.

The layer and its attention choose their kernels where the JAX modules do
(layers.py:113-247 and :337-399), from the flags of ``mdm_tpu_torch.ops``
and the same shape gates, so one configuration takes one route on both
sides. Under AUTO a deterministic layer is the whole-layer kernel
(ops/layer_inference.py) and a training layer the train attention block
followed by the encoder tail (ops/attention_train_block.py,
ops/encoder_tail.py). The JAX package lifts its rate-0 exclusions under
interpret mode only; the port's kernels draw no TPU bits, so it lifts them
always. Every training route draws its dropout seeds from the step's CPU
generator and its masks from the Philox stream of ops/dropout_bits.py, so
the CPU and the card drop the same elements and the einsum route and the
dropout kernel compute the same function under the same seed. Every
dropout site passes ``ops.shard_seed_offset()`` as its batch offset, so a
data-parallel rank drops exactly its rows of the one-process masks.

Under tensor parallelism (parallel/tp_rules.py) an attention holds its
rank's heads and a layer its FFN columns, and both hold the mesh's model
group (``tp_group``). Megatron's conjugate pair of collectives runs over
it (``_dense`` with the group): *f*, the identity forward whose backward sums the input gradient of a
column-parallel product (the packed q/k/v, the cross-attention's q, k and
v, ``linear1``), and *g*, which sums the row-parallel partial products
(``out_proj``, ``linear2``) before their bias and passes the gradient
through. Both sum f32 partials and round once to the compute dtype, where
the one-process product rounds its whole sum. Each
dropout site of the rank's heads or columns adds the rank's
``head_offset`` or ``ffn_offset`` to its Philox counter, so a rank draws
exactly its slice of the one-process masks. Under ``remat`` a layer's
backward reruns its forward, *g*'s all-reduces included: every rank runs
the same graph, so each reruns them in the same order and the ranks'
collectives still pair up. Without a group (one process, data
parallelism) neither collective exists.

``DiTBlock`` is DiT's AdaLN-Zero block (models/mdm.py's ``arch="dit"``),
forward only, through ops/adaln.py.

Spans (utils/tracing.py): ``denoiser.layer`` around each layer call of a
stack, and a decoder layer's ``denoiser.self_attn`` (with its dropout and
first LayerNorm), ``denoiser.cross_attn`` and ``denoiser.tail``; a DiT
block's ``denoiser.self_attn`` (the attention and the adaptive LayerNorm
after it) and ``denoiser.tail`` (the MLP and the one after it).
"""
from __future__ import annotations

import math
from typing import Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from .. import ops
from ..ops.adaln import adaln_modulate, gelu_tanh_mlp
from ..ops.attention_dropout import fused_dropout_attention
from ..ops.attention_train_block import (fused_block_attention_inference,
                                         fused_train_attention_block)
from ..ops.attention_v2 import fused_attention_v2
from ..ops.dropout_bits import (dropout_bits, keep_factors, sequence_dropout_bits,
                                tail_dropout_bits)
from ..ops.encoder_tail import fused_encoder_tail, fused_encoder_tail_inference
from ..ops.layer_inference import fused_layer_inference
from ..utils.tracing import span

_INT32_MAX = 2 ** 31 - 1


def draw_seeds(rng: Optional[torch.Generator], n: int) -> list:
    """n int32 dropout seeds from a CPU generator (JAX's per-layer
    ``randint(make_rng("dropout"), (), 0, int32 max)``); drawn on the host,
    so passing them to a kernel never waits for the card. No generator
    gives zeros, for rate-0 training."""
    if rng is None:
        return [0] * n
    return torch.randint(0, _INT32_MAX, (n,), generator=rng).tolist()


def gelu_exact(x: torch.Tensor) -> torch.Tensor:
    """erf-based GELU, torch's F.gelu default (the checkpoint parity surface)."""
    return torch.nn.functional.gelu(x, approximate="none")


def sinusoidal_table(max_len: int, d_model: int) -> np.ndarray:
    """Classic sin/cos positional table [max_len, d_model], built in f64."""
    position = np.arange(max_len, dtype=np.float64)[:, None]
    div_term = np.exp(np.arange(0, d_model, 2, dtype=np.float64) * (-np.log(10000.0) / d_model))
    pe = np.zeros((max_len, d_model), dtype=np.float64)
    pe[:, 0::2] = np.sin(position * div_term)
    pe[:, 1::2] = np.cos(position * div_term)
    return pe.astype(np.float32)


def key_padding_bias(padding_mask: Optional[torch.Tensor]) -> Optional[torch.Tensor]:
    """[B, Sk] bool (True = ignore) -> additive f32 bias [B, 1, 1, Sk]."""
    if padding_mask is None:
        return None
    zero = torch.zeros((), dtype=torch.float32, device=padding_mask.device)
    return torch.where(padding_mask, zero - 1e9, zero)[:, None, None, :]


def _lecun_normal_(w: torch.Tensor, generator: torch.Generator) -> None:
    """In-place N(0, 1/fan_in) draw for a torch [out, in] weight."""
    w.copy_(torch.randn(w.shape, generator=generator) / math.sqrt(w.shape[-1]))


def init_weights_(module: nn.Module, generator: torch.Generator) -> None:
    """Seeded init of every parameter below ``module``, drawn on the CPU
    from ``generator`` (flax's defaults: lecun-normal kernels, zero biases,
    unit LayerNorm scales; the GRU's kernels lecun-normal over their input
    width)."""
    with torch.no_grad():
        for m in module.modules():
            if isinstance(m, nn.Linear):
                _lecun_normal_(m.weight, generator)
                m.bias.zero_()
            elif isinstance(m, MultiHeadAttention):
                for w in m.in_proj_weight.chunk(3):  # q, k, v: three [D, D] kernels
                    _lecun_normal_(w, generator)
                m.in_proj_bias.zero_()
            elif isinstance(m, nn.LayerNorm):
                m.weight.fill_(1.0)
                m.bias.zero_()
            elif isinstance(m, nn.GRU):
                for name, p in m.named_parameters():
                    if name.startswith("weight"):
                        _lecun_normal_(p, generator)
                    else:
                        p.zero_()


def _row_bias(bias: Optional[torch.Tensor], keys: int) -> Optional[torch.Tensor]:
    """A [B, 1, 1, Sk] additive bias as the f32 key-padding row [B, Sk]."""
    return None if bias is None else bias.reshape(bias.shape[0], -1)[:, -keys:].float()


def layer_seeds(rng: Optional[torch.Generator], n: int, rate: float) -> list:
    """A training layer's n dropout seeds, drawn from the step's CPU
    generator before the layer runs, so a rematerialised layer replays
    them instead of drawing again."""
    if rng is None and rate > 0.0:
        raise ValueError("a training forward with dropout needs the step's generator")
    return draw_seeds(rng, n)


class _CopyToModelGroup(torch.autograd.Function):
    """Megatron's *f*: the identity forward. A column-parallel product
    gives each rank only its columns' part of its input's gradient, so the
    backward sums the parts over the model group, in f32 (``_dense`` gives
    it the f32 input, so the sum is rounded once, by the cast before it)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        import torch.distributed as dist

        total = grad.to(torch.float32, memory_format=torch.contiguous_format, copy=True)
        dist.all_reduce(total, group=ctx.group)
        return total.to(grad.dtype), None


class _SumOverModelGroup(torch.autograd.Function):
    """Megatron's *g*: sums the row-parallel partial products over the
    model group (in place, on the f32 partials). The backward is the
    identity: each rank's partial product takes the whole gradient."""

    @staticmethod
    def forward(ctx, partial, group):
        import torch.distributed as dist

        dist.all_reduce(partial, group=group)
        ctx.mark_dirty(partial)
        return partial

    @staticmethod
    def backward(ctx, grad):
        return grad, None


def _dense(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor, dt: torch.dtype,
           group=None, column: bool = False):
    """flax nn.Dense(dtype=dt): the product and the bias in dt. With a
    tensor-parallel ``group`` the product is split over it and computed in
    f32 on the dt-rounded operands, rounded once to dt where the whole
    product is. ``column``: the weight holds this rank's output columns,
    and the f32 input passes *f*, so the ranks' partial input gradients are
    summed in f32 and rounded once, where the whole product's gradient is.
    Else the weight holds this rank's input columns (row-parallel): *g*
    sums the partial products, then the bias is added once."""
    if group is None:
        return F.linear(x.to(dt), weight.to(dt), bias.to(dt))
    x, w, b = x.to(dt).float(), weight.to(dt).float(), bias.to(dt).float()
    if column:
        return F.linear(_CopyToModelGroup.apply(x, group), w, b).to(dt)
    return (_SumOverModelGroup.apply(F.linear(x, w), group) + b).to(dt)


class MultiHeadAttention(nn.Module):
    """Multi-head attention with torch.nn.MultiheadAttention's parameters
    (packed ``in_proj_weight`` [3D, D], ``in_proj_bias``, ``out_proj``) and
    the JAX module's five routes, tried in its order under its gates:
    the sample block (#2 at rate 0), the train block (#2/#3), the dropout
    kernel (#7/#8), the v2 kernel (#11), then the einsum route with
    probability dropout when training. ``attn_bias`` is additive, broadcast
    to [B, 1|H, Sq, Sk]; the kernels take only its key-padding row.
    Under tensor parallelism (``tp_rules.shard_model_``) it holds heads
    [``head_offset``, ``head_offset`` + ``num_heads``) of the whole
    attention and the model group ``tp_group``, and takes the einsum
    route."""

    tp_group = None  # the mesh's model group under tensor parallelism
    head_offset = 0  # the global index of this rank's first head

    def __init__(self, d_model: int, num_heads: int, dropout: float = 0.0,
                 compute_dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.d_model, self.num_heads = d_model, num_heads
        self.dropout = dropout
        self.compute_dtype = compute_dtype
        self.in_proj_weight = nn.Parameter(torch.empty(3 * d_model, d_model))
        self.in_proj_bias = nn.Parameter(torch.zeros(3 * d_model))
        self.out_proj = nn.Linear(d_model, d_model)
        nn.init.xavier_uniform_(self.in_proj_weight)
        self._cast = None  # (key, the four weights in the compute dtype)

    def forward(self, query: torch.Tensor, key: torch.Tensor, value: torch.Tensor,
                attn_bias: Optional[torch.Tensor] = None, deterministic: bool = True,
                seed: int = 0) -> torch.Tensor:
        """``seed``: a training forward's dropout seed, drawn by the layer
        from the step's CPU generator; every route drops under it."""
        D, H = self.d_model, self.num_heads
        cdt = self.compute_dtype or query.dtype
        self_attention = query is key and key is value
        row_bias = attn_bias is None or attn_bias.shape[-2] == 1
        same_len = query.shape[1] == key.shape[1]
        kpm = _row_bias(attn_bias, key.shape[1])
        weights = (self.in_proj_weight, self.in_proj_bias, self.out_proj.weight,
                   self.out_proj.bias)
        if deterministic and not torch.is_grad_enabled():
            weights = _cached_cast(self, weights, cdt)

        if (ops.pallas_sample_block_enabled() and deterministic and self_attention and row_bias
                and D % 128 == 0):
            return fused_block_attention_inference(query.to(cdt), *weights, H,
                                                   key_padding_mask=kpm)
        if (ops.pallas_train_block_enabled() and not deterministic and self_attention
                and row_bias and D % 128 == 0):
            # The casts sit inside the autograd graph: the parameter
            # gradients come back rounded to cdt, as the JAX wrappers' do.
            return fused_train_attention_block(query.to(cdt), *weights, H, self.dropout, seed,
                                               key_padding_mask=kpm,
                                               batch_offset=ops.shard_seed_offset())

        q, k, v = self._project(query, key, value, *weights[:2], cdt)
        if (ops.pallas_train_attention_enabled() and not deterministic and self.dropout > 0.0
                and same_len and row_bias and D % 128 == 0):
            out = fused_dropout_attention(q, k, v, H, self.dropout, seed, key_padding_mask=kpm,
                                          batch_offset=ops.shard_seed_offset())
            return _dense(out.to(cdt), *weights[2:], cdt)
        if (ops.pallas_attention_enabled() and deterministic and same_len and row_bias
                and D % 128 == 0):
            out = fused_attention_v2(q, k, v, H, key_padding_mask=kpm).to(cdt)
            return _dense(out, *weights[2:], cdt)
        return self._einsum(q, k, v, attn_bias, deterministic, seed, weights[2:], cdt)

    def _project(self, query, key, value, w, b, cdt):
        """q, k, v: column-parallel under tensor parallelism."""
        dense = lambda t, wi, bi: _dense(t, wi, bi, cdt, self.tp_group, column=True)
        if query is key and key is value:
            return dense(query, w, b).chunk(3, dim=-1)
        return tuple(dense(t, wi, bi)
                     for t, wi, bi in zip((query, key, value), w.chunk(3), b.chunk(3)))

    def _einsum(self, q, k, v, attn_bias, deterministic, seed, out_proj, cdt):
        """The JAX module's non-kernel route, in cdt (layers.py:234-247)."""
        B, Sq, D = q.shape
        Sk, H = k.shape[1], self.num_heads
        Dh = D // H
        split = lambda t: t.reshape(B, t.shape[1], H, Dh).transpose(1, 2)  # [B, H, S, Dh]
        logits = split(q) @ split(k).transpose(-1, -2) / torch.sqrt(
            torch.tensor(Dh, dtype=cdt, device=q.device))
        if attn_bias is not None:
            logits = logits + attn_bias.to(logits.dtype)
        weights = torch.softmax(logits.float(), dim=-1).to(cdt)
        if self.dropout > 0.0 and not deterministic:
            bits = dropout_bits(seed, B, H, Sq, device=q.device, key_len=Sk,
                                batch_offset=ops.shard_seed_offset(),
                                head_offset=self.head_offset)
            weights = (weights.float() * keep_factors(bits, self.dropout)).to(cdt)
        out = (weights @ split(v)).transpose(1, 2).reshape(B, Sq, D)
        return _dense(out, *out_proj, cdt, self.tp_group)


def _cached_cast(layer: nn.Module, params, dt: torch.dtype):
    """``params`` in dtype dt, detached, cast once and kept on ``layer``
    until a parameter is replaced or updated in place (load_state_dict,
    .to): for sampling only, since no gradient flows through the cache."""
    if all(p.dtype == dt for p in params):
        return params
    key = (dt,) + tuple((p.data_ptr(), p._version) for p in params)
    if layer._cast is None or layer._cast[0] != key:
        with torch.no_grad():
            layer._cast = (key, tuple(p.detach().to(dt) for p in params))
    return layer._cast[1]


def _plain_tail(x, attn, norm_a, linear1, linear2, norm_b, keep=(None, None, None), group=None):
    """The JAX layers' non-kernel tail (layers.py:387-399, :433-441) in
    attn's dtype, LayerNorm in f32: dropout + residual + ``norm_a``, the
    GELU FFN, dropout + residual + ``norm_b``. ``keep``: the keep factors
    of the three dropout sites (attn-out, ffn-hidden, ffn-out), the fused
    tail's, or None where nothing is dropped. ``group``: the model group
    of a tensor-parallel layer, whose ``linear1`` is column- and
    ``linear2`` row-parallel."""
    cdt = attn.dtype
    y = norm_a((x + _drop(attn, keep[0])).float()).to(cdt)
    h = gelu_exact(_dense(y, linear1.weight, linear1.bias, cdt, group, column=True))
    h = _dense(_drop(h, keep[1]), linear2.weight, linear2.bias, cdt, group)
    return norm_b((y + _drop(h, keep[2])).float()).to(cdt)


def _drop(t: torch.Tensor, keep: Optional[torch.Tensor]) -> torch.Tensor:
    return t if keep is None else (t.float() * keep).to(t.dtype)


def _tail(layer: nn.Module, x, attn, norms, deterministic: bool, seed: int):
    """A layer's attention -> FFN half (the encoder's, or the decoder's
    cross-attention -> FFN) with its LayerNorms ``norms``: the fused tail
    (#4/#5, or #4's rate-0 entry when deterministic) under the tail flag
    and the width gates, else the plain tail with the fused tail's three
    keep sites drawn under the same seed."""
    norm_a, norm_b = norms
    d_model, ff_size = layer.linear1.in_features, layer.linear1.out_features
    params = (norm_a.weight, norm_a.bias, layer.linear1.weight, layer.linear1.bias,
              layer.linear2.weight, layer.linear2.bias, norm_b.weight, norm_b.bias)
    if ops.pallas_encoder_tail_enabled(deterministic) and d_model % 128 == 0 and ff_size % 128 == 0:
        if deterministic:
            return fused_encoder_tail_inference(x, attn, *_cached_cast(layer, params, attn.dtype))
        return fused_encoder_tail(x, attn, *params, layer.dropout, seed,
                                  batch_offset=ops.shard_seed_offset())
    keep = (None, None, None)
    if not deterministic and layer.dropout > 0.0:
        B, S, D = x.shape
        keep = tuple(keep_factors(b, layer.dropout)
                     for b in tail_dropout_bits(seed, B, S, D, ff_size, device=x.device,
                                                batch_offset=ops.shard_seed_offset(),
                                                ffn_offset=layer.ffn_offset))
    return _plain_tail(x, attn, norm_a, layer.linear1, layer.linear2, norm_b, keep,
                       layer.tp_group)


class TransformerEncoderLayer(nn.Module):
    """Post-LN encoder layer (torch default semantics, exact-erf GELU) with
    the JAX layer's three routes: the whole-layer kernel, attention plus the
    fused tail, and attention plus the plain LN/Linear/GELU/dropout tail."""

    N_SEEDS = 2  # a training forward's dropout seeds: attention, tail
    tp_group = None  # the mesh's model group under tensor parallelism
    ffn_offset = 0  # the global index of this rank's first FFN column

    def __init__(self, d_model: int, num_heads: int, ff_size: int,
                 compute_dtype: Optional[torch.dtype] = None, dropout: float = 0.1):
        super().__init__()
        self.num_heads = num_heads
        self.compute_dtype = compute_dtype
        self.dropout = dropout
        self.self_attn = MultiHeadAttention(d_model, num_heads, dropout, compute_dtype)
        self.linear1 = nn.Linear(d_model, ff_size)
        self.linear2 = nn.Linear(ff_size, d_model)
        self.norm1 = nn.LayerNorm(d_model, eps=1e-5)
        self.norm2 = nn.LayerNorm(d_model, eps=1e-5)
        self._cast = None  # (key, weights in the compute dtype)

    def _params(self):
        a = self.self_attn
        return (a.in_proj_weight, a.in_proj_bias, a.out_proj.weight, a.out_proj.bias,
                self.norm1.weight, self.norm1.bias, self.linear1.weight, self.linear1.bias,
                self.linear2.weight, self.linear2.bias, self.norm2.weight, self.norm2.bias)

    def forward(self, x: torch.Tensor, padding_bias: Optional[torch.Tensor] = None,
                deterministic: bool = True, seeds: Optional[Sequence[int]] = None
                ) -> torch.Tensor:
        """``seeds``: a training forward's two dropout seeds (attention,
        then the tail), drawn by the stack from the step's CPU generator;
        without them only a rate-0 training forward runs."""
        if seeds is None:
            seeds = layer_seeds(None, self.N_SEEDS, 0.0 if deterministic else self.dropout)
        d_model, ff_size = self.linear1.in_features, self.linear1.out_features
        cdt = self.compute_dtype or x.dtype
        if (ops.pallas_layer_inference_enabled() and deterministic
                and d_model % 128 == 0 and ff_size % 128 == 0
                and (padding_bias is None or padding_bias.shape[-2] == 1)):
            return fused_layer_inference(x.to(cdt), *_cached_cast(self, self._params(), cdt),
                                         self.num_heads,
                                         key_padding_mask=_row_bias(padding_bias, x.shape[1]))
        attn = self.self_attn(x, x, x, padding_bias, deterministic, seeds[0])
        return _tail(self, x.to(attn.dtype), attn, (self.norm1, self.norm2), deterministic,
                     seeds[1])


class TransformerDecoderLayer(nn.Module):
    """Post-LN decoder layer (torch.nn.TransformerDecoderLayer's semantics
    and parameter names, exact-erf GELU; mdm_tpu/models/layers.py:402-442):
    self-attention through ``MultiHeadAttention``'s routes (#2 under AUTO:
    the rate-0 entry when deterministic, the train block #2/#3 in
    training), dropout on its output, a plain first LayerNorm,
    cross-attention on the einsum route (no kernel takes Sq != Sk) with
    its [B, H, Sq, Sk] probability dropout, then the cross-attention ->
    FFN half through the fused tail (#4/#5, or #4's rate-0 entry) or the
    plain tail. The whole-layer kernel (#1) is the encoder's: its flag is
    not read here."""

    N_SEEDS = 4  # self-attention, its output's dropout, cross-attention, tail
    tp_group = None  # the mesh's model group under tensor parallelism
    ffn_offset = 0  # the global index of this rank's first FFN column

    def __init__(self, d_model: int, num_heads: int, ff_size: int,
                 compute_dtype: Optional[torch.dtype] = None, dropout: float = 0.1):
        super().__init__()
        self.compute_dtype = compute_dtype
        self.dropout = dropout
        self.self_attn = MultiHeadAttention(d_model, num_heads, dropout, compute_dtype)
        self.multihead_attn = MultiHeadAttention(d_model, num_heads, dropout, compute_dtype)
        self.linear1 = nn.Linear(d_model, ff_size)
        self.linear2 = nn.Linear(ff_size, d_model)
        self.norm1 = nn.LayerNorm(d_model, eps=1e-5)
        self.norm2 = nn.LayerNorm(d_model, eps=1e-5)
        self.norm3 = nn.LayerNorm(d_model, eps=1e-5)
        self._cast = None  # (key, the tail's weights in the compute dtype)

    def forward(self, tgt: torch.Tensor, memory: torch.Tensor,
                tgt_bias: Optional[torch.Tensor] = None,
                memory_bias: Optional[torch.Tensor] = None,
                deterministic: bool = True, seeds: Optional[Sequence[int]] = None
                ) -> torch.Tensor:
        """``seeds``: a training forward's four dropout seeds (``N_SEEDS``),
        drawn by the stack from the step's CPU generator; without them only
        a rate-0 training forward runs. The output of the self-attention
        drops with the mask of ``sequence_dropout_bits`` under its own seed
        (site 0, [B, S, D]: one dump)."""
        if seeds is None:
            seeds = layer_seeds(None, self.N_SEEDS, 0.0 if deterministic else self.dropout)
        s_self, s_out, s_cross, s_tail = seeds
        with span("denoiser.self_attn"):
            attn = self.self_attn(tgt, tgt, tgt, tgt_bias, deterministic, s_self)
            if not deterministic and self.dropout > 0.0:
                bits = sequence_dropout_bits(s_out, *attn.shape, device=attn.device,
                                             batch_offset=ops.shard_seed_offset())
                attn = _drop(attn, keep_factors(bits, self.dropout))
            cdt = self.compute_dtype or attn.dtype
            tgt = self.norm1((tgt + attn).float()).to(cdt)
        with span("denoiser.cross_attn"):
            cross = self.multihead_attn(tgt, memory, memory, memory_bias, deterministic, s_cross)
        with span("denoiser.tail"):
            return _tail(self, tgt.to(cross.dtype), cross, (self.norm2, self.norm3),
                         deterministic, s_tail)


def _run_layers(layers: nn.ModuleList, x: torch.Tensor, args: tuple, deterministic: bool,
                rng: Optional[torch.Generator], remat: bool) -> torch.Tensor:
    """Each layer in turn, with its dropout seeds drawn from ``rng`` before
    the call (in layer order: the stream the layers drew themselves). With
    ``remat`` and autograd on, each layer is rematerialised
    (``torch.utils.checkpoint``, JAX's ``nn.remat``): its backward reruns
    its forward under the same seeds, so the same masks, and the generator
    moves as it does without remat (checkpoint restores only the global
    and device RNGs, not an explicit generator). Under tensor parallelism
    the rerun forward reruns *g*'s all-reduces over the model group; every
    rank reruns the same layers in the same order, so the collectives pair
    up as they did in the forward."""
    for layer in layers:
        seeds = None if deterministic else layer_seeds(rng, layer.N_SEEDS, layer.dropout)
        with span("denoiser.layer"):
            if remat and torch.is_grad_enabled():
                x = checkpoint(layer, x, *args, deterministic, seeds, use_reentrant=False,
                               preserve_rng_state=False)
            else:
                x = layer(x, *args, deterministic, seeds)
    return x


class TransformerEncoder(nn.Module):
    def __init__(self, d_model: int, num_heads: int, ff_size: int, num_layers: int,
                 compute_dtype: Optional[torch.dtype] = None, dropout: float = 0.1,
                 remat: bool = False):
        super().__init__()
        self.remat = remat
        self.layers = nn.ModuleList(
            TransformerEncoderLayer(d_model, num_heads, ff_size, compute_dtype, dropout)
            for _ in range(num_layers))

    def forward(self, x: torch.Tensor, padding_mask: Optional[torch.Tensor] = None,
                deterministic: bool = True, rng: Optional[torch.Generator] = None
                ) -> torch.Tensor:
        """``rng``: the step's CPU generator, which a training forward
        draws every layer's dropout seeds from."""
        return _run_layers(self.layers, x, (key_padding_bias(padding_mask),), deterministic,
                           rng, self.remat)


class TransformerDecoder(nn.Module):
    def __init__(self, d_model: int, num_heads: int, ff_size: int, num_layers: int,
                 compute_dtype: Optional[torch.dtype] = None, dropout: float = 0.1,
                 remat: bool = False):
        super().__init__()
        self.remat = remat
        self.layers = nn.ModuleList(
            TransformerDecoderLayer(d_model, num_heads, ff_size, compute_dtype, dropout)
            for _ in range(num_layers))

    def forward(self, tgt: torch.Tensor, memory: torch.Tensor,
                tgt_padding_mask: Optional[torch.Tensor] = None,
                memory_padding_mask: Optional[torch.Tensor] = None,
                deterministic: bool = True, rng: Optional[torch.Generator] = None
                ) -> torch.Tensor:
        """Padding masks [B, S] and [B, L] bool, True = ignore. ``rng``: as
        the encoder's."""
        args = (memory, key_padding_bias(tgt_padding_mask), key_padding_bias(memory_padding_mask))
        return _run_layers(self.layers, tgt, args, deterministic, rng, self.remat)


class DiTAttention(nn.Module):
    """timm's ``Attention`` as DiT holds it: a packed ``qkv`` [3D, D] (q, k,
    v, each heads of D / H) and ``proj``, both with biases."""

    def __init__(self, d_model: int, num_heads: int):
        super().__init__()
        self.num_heads = num_heads
        self.qkv = nn.Linear(d_model, 3 * d_model)
        self.proj = nn.Linear(d_model, d_model)


class DiTMlp(nn.Module):
    """timm's ``Mlp``: ``fc1``, GELU's tanh form, ``fc2``."""

    def __init__(self, d_model: int, ff_size: int):
        super().__init__()
        self.fc1 = nn.Linear(d_model, ff_size)
        self.fc2 = nn.Linear(ff_size, d_model)


class DiTBlock(nn.Module):
    """DiT's block with adaptive LayerNorm-Zero conditioning (DiT ``models.py``
    ``DiTBlock``, its parameter names): from the condition c,
    ``adaLN_modulation`` = (SiLU, Linear(D, 6D)) gives per sample (shift1,
    scale1, gate1, shift2, scale2, gate2), and

        x <- x + gate1 * attn(LN(x) * (1 + scale1) + shift1)
        x <- x + gate2 * mlp(LN(x) * (1 + scale2) + shift2)

    with no LayerNorm affine (eps 1e-6). The model computes every block's
    modulation in one product before the loop (ops/adaln.py::modulation),
    so a call takes this block's six rows ``mod`` [B, 6D] and the next
    LayerNorm's shift and scale (the next block's first, or the final
    layer's): the block's input h is its first modulated LayerNorm, and it
    returns (x, the next one). Forward only."""

    def __init__(self, d_model: int, num_heads: int, ff_size: int):
        super().__init__()
        if d_model % num_heads:
            raise ValueError(f"DiTBlock: d_model {d_model} does not split into {num_heads} heads")
        self.attn = DiTAttention(d_model, num_heads)
        self.mlp = DiTMlp(d_model, ff_size)
        self.adaLN_modulation = nn.Sequential(nn.SiLU(), nn.Linear(d_model, 6 * d_model))
        self._cast = None  # (key, the products' weights in the compute dtype)

    def _params(self):
        a, m = self.attn, self.mlp
        return (a.qkv.weight, a.qkv.bias, a.proj.weight, a.proj.bias, m.fc1.weight, m.fc1.bias,
                m.fc2.weight, m.fc2.bias)

    def forward(self, x: torch.Tensor, h: torch.Tensor, mod: torch.Tensor,
                next_shift: torch.Tensor, next_scale: torch.Tensor,
                key_bias: Optional[torch.Tensor] = None):
        """x, h [B, S, D] in the compute dtype, which the products take their
        weights in; ``mod`` f32 [B, 6D] (a view of the stacked modulation);
        ``key_bias`` f32 [B, S] additive key padding."""
        D = x.shape[-1]
        _, _, g1, sh2, sc2, g2 = (mod[:, i * D:(i + 1) * D] for i in range(6))
        wqkv, bqkv, wo, bo, w1, b1, w2, b2 = _cached_cast(self, self._params(), x.dtype)
        with span("denoiser.self_attn"):
            a = fused_block_attention_inference(h, wqkv, bqkv, wo, bo, self.attn.num_heads,
                                                key_padding_mask=key_bias)
            x, h = adaln_modulate(x, a, g1, sh2, sc2)
        with span("denoiser.tail"):
            y = gelu_tanh_mlp(h, w1, b1, w2, b2)
            return adaln_modulate(x, y, g2, next_shift, next_scale)


class TimestepEmbedder(nn.Module):
    """PE-table lookup + 2-layer SiLU MLP (reference mdm.py:316-330); keys
    ``time_embed.0`` / ``time_embed.2`` as in the torch checkpoints."""

    def __init__(self, latent_dim: int, max_len: int = 5000):
        super().__init__()
        self.register_buffer("pe", torch.from_numpy(sinusoidal_table(max_len, latent_dim)),
                             persistent=False)
        self.time_embed = nn.Sequential(
            nn.Linear(latent_dim, latent_dim), nn.SiLU(), nn.Linear(latent_dim, latent_dim))

    def forward(self, timesteps: torch.Tensor) -> torch.Tensor:
        return self.time_embed(self.pe[timesteps])
