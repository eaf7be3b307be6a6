"""The training encoder-layer tail: dropout + residual + LN1 + FFN + LN2,
forward and backward, as chains of hand-written Hopper kernels.

Replaces mdm_tpu/ops/encoder_tail.py: ``_call_fwd`` (kernel #4,
``pallas_call`` at :309,313) and ``_call_bwd`` (kernel #5, at :358,364),
which run one program per batch cell with W1 and W2 resident in VMEM and
three in-kernel dropout sites. On the card (``csrc/encoder_tail.cu``, the
products, forward and backward, on ``csrc/gemm_sm90.cu``):

    forward   y32 = LN1(x + drop0(attn)); y = dt(y32)   tail_ln_fwd, mask0
              u   = y . W1^T + b1 (f32)                  gemm
              hd  = dt(drop1(gelu(u)))                   tail_gelu_dropout, mask1
              o   = hd . W2^T + b2 (f32)                 gemm
              z   = dt(LN2(y32 + drop2(o)))              tail_ln_fwd, mask2
    backward  ds2, do = drop2(ds2); dg2, dbl2, db2       tail_ln_bwd
              dW2 = do16^T hd, dhd = do16 . W2           gemm (split-K f32 / f32)
              du  = drop1(dhd) gelu'(u); db1             tail_gelu_bwd
              dW1 = du16^T y, dy = ds2 + du16 . W1       gemm
              dx = ds1, da = drop0(ds1); dg1, dbl1       tail_ln_bwd

What bounds it on an H100: the two FFN products forward and the four
backward carry ~95% of the tail's FLOPs (tensor-core bound: wgmma, f32
accumulation); the row and elementwise kernels move a few bytes per
element, and the forward draws one Philox4x32-10 word per element of the
three dropout sites, keyed on (batch, site, row, column). Each word is
drawn once: with dropout on, the forward keeps each site's keep decisions
as a packed mask (bit c % 32 of word c // 32 of a row, ``keep_mask_bits``
is its plain version, (2D + F) / 8 bytes a row) and the backward reads the
masks and draws nothing. The LayerNorm kernels hold a row in registers up
to D = 1024 (above it a block streams the row); the backward's six column
sums are fused into its row kernels as partials over fixed chunks of
CHUNK_ROWS rows, summed in chunk order, as the weight gradients reduce in
fixed split-K chunks: no float atomics. The forward keeps y, y32, u, hd
and o for the backward instead of recomputing them as the TPU kernel does
(two GEMMs less, ~10*M*F bytes more per layer).

Rounding points (the TPU kernel's): y32 and the linear2 output stay f32,
y and hd go to dt; backward do and du go to dt for the products while db2
and db1 sum their f32 values; dx and da leave in dt. LayerNorm variance
is E[s^2] - E[s]^2 (eps 1e-5) and its backward follows ``_ln_bwd``. GELU
is exact (erf), with derivative Phi(u) + u phi(u); the TPU kernel's A&S
7.1.26 erf is within 1.5e-7 of it. The parameter gradients come back
rounded to dt, as ``_tail_core_bwd``'s ``cast``.

``encoder_tail_reference`` and ``encoder_tail_bwd_reference`` are the
plain PyTorch versions with those rounding points (torch layout: W1
[F, D], W2 [D, F]).
"""
from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from . import _build
from ._chain import (check_dtype, check_shapes, dev, dropout_args, gemm, ptr, splits_for,
                     stream)
from .dropout_bits import keep_factors, tail_dropout_bits

LAUNCHES = {"fwd": 0, "bwd": 0}  # kernel-chain launches, one per tail call

_LN_EPS = 1e-5
_INV_SQRT2 = float(np.float32(1.0 / np.sqrt(2.0)))
_INV_SQRT2PI = float(np.float32(1.0 / np.sqrt(2.0 * np.pi)))

Bits = Optional[Sequence[torch.Tensor]]  # attn-out [B,S,D], ffn-hidden [B,S,F], ffn-out [B,S,D]


def _ln_fwd(s, g, b):
    """Row LayerNorm in f32: (out, xhat, rstd) (encoder_tail.py::_ln_fwd)."""
    mu = s.mean(dim=-1, keepdim=True)
    var = (s * s).mean(dim=-1, keepdim=True) - mu * mu
    rstd = torch.rsqrt(var + _LN_EPS)
    xhat = (s - mu) * rstd
    return xhat * g + b, xhat, rstd


def _ln_bwd(dout, xhat, rstd, g):
    """ds given the upstream dout (all f32) (encoder_tail.py::_ln_bwd)."""
    dxhat = dout * g
    m1 = dxhat.mean(dim=-1, keepdim=True)
    m2 = (dxhat * xhat).mean(dim=-1, keepdim=True)
    return (dxhat - m1 - xhat * m2) * rstd


def _gelu(u):
    return u * 0.5 * (1.0 + torch.erf(u * _INV_SQRT2))


def _gelu_grad(u):
    phi = torch.exp(-0.5 * (u * u)) * _INV_SQRT2PI
    return 0.5 * (1.0 + torch.erf(u * _INV_SQRT2)) + u * phi


def _recompute(x, attn, g1, bl1, w1, b1, w2, b2, g2, bl2, rate, bits):
    """The forward's values at _recompute's rounding points."""
    dt = x.dtype
    par = lambda t: t.to(dt).float()
    keep = [None] * 3
    if rate > 0.0:
        if bits is None:
            raise ValueError("rate > 0 needs the dropout bits")
        keep = [keep_factors(b, rate) for b in bits]
    a32 = attn.float() if keep[0] is None else attn.float() * keep[0]
    y32, xhat1, rstd1 = _ln_fwd(x.float() + a32, par(g1), par(bl1))
    y = y32.to(dt)
    u = y.float() @ par(w1).T + par(b1)
    gact = _gelu(u) if keep[1] is None else _gelu(u) * keep[1]
    hd = gact.to(dt)
    o = hd.float() @ par(w2).T + par(b2)
    if keep[2] is not None:
        o = o * keep[2]
    z32, xhat2, rstd2 = _ln_fwd(y32 + o, par(g2), par(bl2))
    return dict(z=z32.to(dt), y=y, u=u, hd=hd, keep=keep, xhat1=xhat1, rstd1=rstd1,
                xhat2=xhat2, rstd2=rstd2)


def encoder_tail_reference(x, attn, g1, bl1, w1, b1, w2, b2, g2, bl2, rate: float = 0.0,
                           bits: Bits = None) -> torch.Tensor:
    """Plain forward: z = LN2(y + drop2(linear2(drop1(gelu(linear1(y)))))),
    y = LN1(x + drop0(attn)), in x's dtype."""
    return _recompute(x, attn, g1, bl1, w1, b1, w2, b2, g2, bl2, rate, bits)["z"]


def encoder_tail_bwd_reference(x, attn, g1, bl1, w1, b1, w2, b2, g2, bl2, dz,
                               rate: float = 0.0, bits: Bits = None):
    """Plain backward at _bwd_kernel's rounding points. Returns (dx, da in
    dt; dg1, dbl1, dW1 [F, D], db1, dW2 [D, F], db2, dg2, dbl2 in f32,
    summed over the batch)."""
    dt = x.dtype
    r = _recompute(x, attn, g1, bl1, w1, b1, w2, b2, g2, bl2, rate, bits)
    keep0, keep1, keep2 = r["keep"]
    rows = lambda t: t.reshape(-1, t.shape[-1])
    dz32 = dz.float()
    ds2 = _ln_bwd(dz32, r["xhat2"], r["rstd2"], g2.to(dt).float())
    dg2, dbl2 = rows(dz32 * r["xhat2"]).sum(0), rows(dz32).sum(0)
    do = ds2 if keep2 is None else ds2 * keep2
    do16 = do.to(dt)
    dw2 = rows(do16).float().T @ rows(r["hd"]).float()
    db2 = rows(do).sum(0)
    dhd = do16.float() @ w2.to(dt).float()
    du = (dhd if keep1 is None else dhd * keep1) * _gelu_grad(r["u"])
    du16 = du.to(dt)
    dw1 = rows(du16).float().T @ rows(r["y"]).float()
    db1 = rows(du).sum(0)
    dy = ds2 + du16.float() @ w1.to(dt).float()
    ds1 = _ln_bwd(dy, r["xhat1"], r["rstd1"], g1.to(dt).float())
    dg1, dbl1 = rows(dy * r["xhat1"]).sum(0), rows(dy).sum(0)
    da = ds1 if keep0 is None else ds1 * keep0
    return ds1.to(dt), da.to(dt), dg1, dbl1, dw1, db1, dw2, db2, dg2, dbl2


def _check(x, attn, params, bits):
    if x.dim() != 3:
        raise ValueError(f"x must be [B, S, D], got {tuple(x.shape)}")
    check_dtype(x, "encoder tail")
    B, S, D = x.shape
    F = params[2].shape[0]
    if D % 8 or F % 8:
        raise ValueError(f"d_model {D} and ff_size {F} must be multiples of 8")
    shapes = [(attn, (B, S, D)), (params[0], (D,)), (params[1], (D,)), (params[2], (F, D)),
              (params[3], (F,)), (params[4], (D, F)), (params[5], (D,)), (params[6], (D,)),
              (params[7], (D,))]
    if bits is not None:
        shapes += list(zip(bits, [(B, S, D), (B, S, F), (B, S, D)]))
        if any(b.dtype != torch.uint32 for b in bits):
            raise ValueError("bits must be uint32")
    check_shapes(x, shapes, "encoder tail")


CHUNK_ROWS = 32  # csrc/encoder_tail.cu: rows per backward block, one column partial each


def mask_words(n: int) -> int:
    """uint32 words of one row's packed keep mask over n columns."""
    return -(-n // 32)


def _fwd_cuda(x, attn, params, rate, seed, bits, boff=0):
    """The forward chain; returns (z, the activations the backward reads:
    x, attn, y, y32, u, hd, o, and the three sites' packed keep masks, or
    None at rate 0)."""
    _check(x, attn, params, bits)
    g1, bl1, w1, b1, w2, b2, g2, bl2 = (dev(p) for p in params)
    B, S, D = x.shape
    M, F, dt = B * S, w1.shape[0], x.dtype
    code = check_dtype(x, "encoder tail")
    bits0, bits1, bits2 = bits if bits is not None else (None, None, None)
    xs, a = dev(x).view(M, D), dev(attn, dt).view(M, D)
    masks = None
    if rate > 0.0:
        masks = tuple(torch.empty((M, mask_words(n)), dtype=torch.uint32, device=x.device)
                      for n in (D, F, D))
    m0, m1, m2 = masks if masks is not None else (None, None, None)
    lib = _build.load_library()
    st = stream(x)
    y = torch.empty((M, D), dtype=dt, device=x.device)
    y32 = torch.empty((M, D), dtype=torch.float32, device=x.device)
    _build.check(lib.mdm_tail_ln1_fwd(ptr(xs), ptr(a), *dropout_args(bits0, seed, rate, boff), ptr(m0),
                                      ptr(g1), ptr(bl1), ptr(y), ptr(y32), M, S, D, code, st),
                 "tail ln1")
    u = gemm(y, w1, bias=b1, out_f32=True)
    hd = torch.empty((M, F), dtype=dt, device=x.device)
    _build.check(lib.mdm_tail_gelu_dropout(ptr(u), *dropout_args(bits1, seed, rate, boff), ptr(m1),
                                           ptr(hd), M, S, F, code, st), "tail gelu")
    o = gemm(hd, w2, bias=b2, out_f32=True)
    z = torch.empty((M, D), dtype=dt, device=x.device)
    _build.check(lib.mdm_tail_ln2_fwd(ptr(y32), ptr(o), *dropout_args(bits2, seed, rate, boff), ptr(m2),
                                      ptr(g2), ptr(bl2), ptr(z), M, S, D, code, st), "tail ln2")
    LAUNCHES["fwd"] += 1
    return z.view(B, S, D), (xs, a, y, y32, u, hd, o, masks)


def _bwd_cuda(x, params, acts, rate, dz):
    g1, _, w1, _, w2, _, g2, _ = (dev(p) for p in params)
    xs, a, y, y32, u, hd, o, masks = acts
    B, S, D = x.shape
    M, F, dt = B * S, w1.shape[0], x.dtype
    code = check_dtype(x, "encoder tail")
    m0, m1, m2 = masks if masks is not None else (None, None, None)
    inv_keep = dropout_args(None, 0, rate)[4]
    f32 = lambda *shape: torch.empty(shape, dtype=torch.float32, device=x.device)
    low = lambda n: torch.empty((M, n), dtype=dt, device=x.device)
    chunks = -(-M // CHUNK_ROWS)
    lib = _build.load_library()
    st = stream(x)
    dz = dev(dz, dt).view(M, D)
    ds2, do16, sums2 = f32(M, D), low(D), f32(3, D)  # sums2: dg2, dbl2, db2
    _build.check(lib.mdm_tail_ln2_bwd(ptr(y32), ptr(o), ptr(m2), inv_keep, ptr(g2), ptr(dz),
                                      ptr(ds2), ptr(do16), ptr(f32(chunks, 3, D)), ptr(sums2),
                                      M, D, code, st), "tail ln2 backward")
    dw2 = gemm(do16, hd, a_km=True, b_kn=True, out_f32=True, splits=splits_for(D, F, M))
    dhd = gemm(do16, w2, b_kn=True, out_f32=True)
    du16, db1 = low(F), f32(F)
    _build.check(lib.mdm_tail_gelu_bwd(ptr(u), ptr(dhd), ptr(m1), inv_keep, ptr(du16),
                                       ptr(f32(chunks, F)), ptr(db1), M, F, code, st),
                 "tail gelu backward")
    dw1 = gemm(du16, y, a_km=True, b_kn=True, out_f32=True, splits=splits_for(F, D, M))
    dy = gemm(du16, w1, b_kn=True, r=ds2, out_f32=True)
    dx, da, sums1 = low(D), low(D), f32(2, D)  # sums1: dg1, dbl1
    _build.check(lib.mdm_tail_ln1_bwd(ptr(xs), ptr(a), ptr(m0), inv_keep, ptr(g1), ptr(dy),
                                      ptr(dx), ptr(da), ptr(f32(chunks, 2, D)), ptr(sums1), M, D,
                                      code, st), "tail ln1 backward")
    grads = (dx.view(B, S, D), da.view(B, S, D), sums1[0], sums1[1], dw1, db1, dw2, sums2[2],
             sums2[0], sums2[1])
    LAUNCHES["bwd"] += 1
    return grads


class _Tail(torch.autograd.Function):
    """The backward reads the three keep masks the forward stored (on the
    card) or the bits it drew (on the CPU). Every tensor it reads, the
    card's activations too, is saved through ``save_for_backward``, so a
    checkpointed layer (``MDMConfig.remat``) drops and recomputes them."""

    @staticmethod
    def forward(ctx, x, attn, g1, bl1, w1, b1, w2, b2, g2, bl2, bits, rate, seed, boff):
        params = (g1, bl1, w1, b1, w2, b2, g2, bl2)
        ctx.rate, ctx.on_card = rate, x.device.type == "cuda"
        if ctx.on_card:
            z, (*acts, masks) = _fwd_cuda(x, attn, params, rate, seed, bits, boff)
            ctx.save_for_backward(x, attn, *params, *acts, *(masks or (None,) * 3))
            return z
        if rate > 0.0 and bits is None:  # the kernels' own Philox stream, drawn on the CPU
            B, S, D = x.shape
            bits = tail_dropout_bits(seed, B, S, D, w1.shape[0], device=x.device,
                                     batch_offset=boff)
        ctx.save_for_backward(x, attn, *params, *(bits or (None,) * 3))
        return encoder_tail_reference(x, attn, *params, rate, bits)

    @staticmethod
    def backward(ctx, dz):
        x, attn, *rest = ctx.saved_tensors
        params, rest = rest[:8], rest[8:]
        if ctx.on_card:
            grads = _bwd_cuda(x, params, (*rest[:7], tuple(rest[7:])), ctx.rate, dz)
        else:
            bits = None if rest[0] is None else tuple(rest)
            grads = encoder_tail_bwd_reference(x, attn, *params, dz, ctx.rate, bits)
        dt = x.dtype
        return (*grads[:2], *(g.to(dt) for g in grads[2:]), None, None, None, None)


def _bits_arg(x, bits):
    if bits is None:
        return None
    return tuple(dev(b) for b in bits) if x.device.type == "cuda" else tuple(bits)


def fused_encoder_tail(
    x: torch.Tensor,  # [B, S, D] layer input (the attention block's input)
    attn: torch.Tensor,  # [B, S, D] attention block output
    g1, bl1,  # norm1 weight / bias [D]
    w1, b1,  # linear1 weight [F, D] / bias [F]
    w2, b2,  # linear2 weight [D, F] / bias [D]
    g2, bl2,  # norm2 weight / bias [D]
    rate: float,
    seed: int,  # int32, drawn per layer per step
    bits: Bits = None,  # injected uint32 bits for the three sites (use_prng=False)
    batch_offset: int = 0,  # global batch index of row 0 (data parallelism)
) -> torch.Tensor:
    """Training encoder tail with three dropouts, differentiable in x, attn
    and the eight parameters (cast to x's dtype inside the autograd graph,
    so their gradients come back rounded to it). CPU tensors run the plain
    versions; CUDA tensors run the kernel chains (each direction adds one
    to ``LAUNCHES``) or raise. ``batch_offset`` moves the draws' batch
    word; the backward reads the forward's masks, so it draws nothing."""
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"fused_encoder_tail runs on cpu or cuda, not {x.device}")
    dt = x.dtype
    params = (g1, bl1, w1, b1, w2, b2, g2, bl2)
    return _Tail.apply(x, attn.to(dt), *(p.to(dt) for p in params), _bits_arg(x, bits),
                       float(rate), int(seed), int(batch_offset))


@torch.no_grad()
def fused_encoder_tail_inference(x, attn, g1, bl1, w1, b1, w2, b2, g2, bl2) -> torch.Tensor:
    """Forward-only tail at rate 0 (sampling); not differentiable."""
    params = (g1, bl1, w1, b1, w2, b2, g2, bl2)
    if x.device.type == "cpu":
        return encoder_tail_reference(x, attn, *params)
    if x.device.type != "cuda":
        raise ValueError(f"fused_encoder_tail_inference runs on cpu or cuda, not {x.device}")
    dt = x.dtype
    return _fwd_cuda(x, attn.to(dt), tuple(p.to(dt) for p in params), 0.0, 0, None)[0]
