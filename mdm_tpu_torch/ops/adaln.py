"""DiT's AdaLN-Zero chain pieces (Peebles & Xie, arXiv:2212.09748), forward
only: the adaptive LayerNorm row kernel, the tanh-GELU MLP and the stacked
modulation product, each beside its plain PyTorch version.

No TPU kernel stands behind these: DiT is no configuration of the JAX
package. A DiT block (models/layers.py::DiTBlock) on the card is

    q|k|v, attn     the rate-0 attention block          gemm, attention_fwd, gemm
    x, h = adaln(x, attn, g1, sh2, sc2)                  adaln_modulate
    y    = fc2(gelu_tanh(fc1(h)))                        gemm (tanh-GELU epilogue), gemm
    x, h = adaln(x, y, g2, sh1', sc1')                   adaln_modulate

where ``adaln(x, y, g, sh, sc)`` is x' = x + g * y and h = LN(x') * (1 + sc)
+ sh per sample (LayerNorm without affine, eps 1e-6), and the primed
vectors are the next block's (or the final layer's). The first ``adaln`` of
a forward has no residual: the LayerNorm and the modulation alone.

What bounds it on an H100 at DiT-XL's widths (D=1152, F=4608) and the
sampling batch (2 x 128 motions of 196 frames, M = 50,176 rows): the block's
four products carry ~96% of its operations and run the wgmma kernel; the
row kernel moves 8 bytes a bf16 value (x and y in, x' and h out), so it is
bound by bytes, ~0.46 GB a call at 3.35 TB/s. It reads each row once into
registers and writes it once: the gated residual, the LayerNorm and the
modulation fused, where DiT's own code makes five passes. Every sample's
shift, scale and gate come from one product before the layer loop
(``modulation``): the 28 blocks and the final layer read the same
condition, so their [2B, 1152] x [1152, 6 x 1152] products are one.

Rounding points: products accumulate in f32 and round to the working type
dt (the attention's q/k/v, p, ctx and out, the GELU output, fc2's output);
the modulation stays f32; x' and h round to dt, the LayerNorm reads the
f32 sum. On a CPU tensor each function runs its plain version, on a CUDA
tensor the kernels, or raises.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from . import _build
from ._chain import DTYPES, dev, gemm, ptr, stream

LAUNCHES = 0  # adaln_modulate launches
EPS = 1e-6  # DiT's LayerNorm eps


def adaln_modulate_reference(x: torch.Tensor, y: Optional[torch.Tensor],
                             gate: Optional[torch.Tensor], shift: torch.Tensor,
                             scale: torch.Tensor) -> Tuple[Optional[torch.Tensor], torch.Tensor]:
    """Plain version of ``adaln_modulate`` at the kernel's rounding points."""
    dt = x.dtype
    s = x.float()
    if y is not None:
        s = s + gate.float()[:, None, :] * y.float()
    h = F.layer_norm(s, s.shape[-1:], eps=EPS) * (1.0 + scale.float()[:, None, :])
    h = (h + shift.float()[:, None, :]).to(dt)
    return (None if y is None else s.to(dt)), h


def _row_stride(t: torch.Tensor, B: int, D: int, what: str) -> int:
    if (t.dtype != torch.float32 or tuple(t.shape) != (B, D) or t.stride(1) != 1
            or t.data_ptr() % 16 or t.stride(0) % 4):
        raise ValueError(f"adaln_modulate: {what} must be f32 [{B}, {D}] rows, 16-byte aligned, "
                         f"with a row stride of a multiple of 4; got {tuple(t.shape)} "
                         f"{t.dtype} strides {t.stride()}")
    return t.stride(0)


def adaln_modulate(x: torch.Tensor, y: Optional[torch.Tensor], gate: Optional[torch.Tensor],
                   shift: torch.Tensor, scale: torch.Tensor
                   ) -> Tuple[Optional[torch.Tensor], torch.Tensor]:
    """(x', h) for x, y [B, S, D] in dt and the per-sample f32 rows gate,
    shift, scale [B, D] (column blocks of one modulation tensor: a shared
    row stride): x' = x + gate * y (None when y is None) and h = LN(x') *
    (1 + scale) + shift, both in dt."""
    if x.device.type == "cpu":
        return adaln_modulate_reference(x, y, gate, shift, scale)
    if x.device.type != "cuda":
        raise ValueError(f"adaln_modulate runs on cpu or cuda, not {x.device}")
    global LAUNCHES
    B, S, D = x.shape
    if x.dtype not in DTYPES or D % 8:
        raise ValueError(f"adaln_modulate: x must be f32 or bf16 with D % 8 == 0, got "
                         f"{x.dtype} D={D}")
    rows = [(shift, "shift"), (scale, "scale")] + ([] if y is None else [(gate, "gate")])
    strides = {_row_stride(t, B, D, what) for t, what in rows}
    if len(strides) != 1:
        raise ValueError(f"adaln_modulate: gate, shift and scale must share a row stride, "
                         f"got {sorted(strides)}")
    xs = dev(x)
    ys = None if y is None else dev(y, x.dtype)
    if ys is not None and ys.shape != x.shape:
        raise ValueError(f"adaln_modulate: y {tuple(y.shape)} against x {tuple(x.shape)}")
    x_out = None if y is None else torch.empty_like(xs)
    h = torch.empty_like(xs)
    _build.check(_build.load_library().mdm_adaln_modulate(
        ptr(xs), ptr(ys), ptr(gate if y is not None else None), ptr(shift), ptr(scale),
        strides.pop(), ptr(x_out), ptr(h), B * S, S, D, EPS, DTYPES[x.dtype], stream(x)),
        "adaln_modulate")
    LAUNCHES += 1
    return x_out, h


def gelu_tanh_mlp_reference(h: torch.Tensor, w1, b1, w2, b2) -> torch.Tensor:
    """fc2(gelu_tanh(fc1(h))) at the kernels' rounding points: each product
    in f32 on dt-rounded operands, the GELU output and the result in dt."""
    dt = h.dtype
    u = h.float() @ w1.to(dt).float().T + b1.to(dt).float()
    g = F.gelu(u, approximate="tanh").to(dt)
    return (g.float() @ w2.to(dt).float().T + b2.to(dt).float()).to(dt)


def gelu_tanh_mlp(h: torch.Tensor, w1, b1, w2, b2) -> torch.Tensor:
    """DiT's MLP on [B, S, D] h (weights in torch layout): two products on
    the card, the first with the tanh-GELU epilogue."""
    if h.device.type == "cpu":
        return gelu_tanh_mlp_reference(h, w1, b1, w2, b2)
    B, S, D = h.shape
    dt = h.dtype
    u = gemm(dev(h).view(B * S, D), dev(w1, dt), bias=dev(b1, dt), gelu="tanh")
    return gemm(u, dev(w2, dt), bias=dev(b2, dt)).view(B, S, D)


def modulation_reference(c: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                         dt: torch.dtype) -> torch.Tensor:
    """SiLU(c) . W^T + b in f32 on dt-rounded operands: every block's shift,
    scale and gate, [B, rows of W]."""
    a = F.silu(c.float()).to(dt).float()
    return a @ w.to(dt).float().T + b.to(dt).float()


def modulation(c: torch.Tensor, w: torch.Tensor, b: torch.Tensor, dt: torch.dtype) -> torch.Tensor:
    """The stacked modulation product of ``modulation_reference``: one
    product, f32 out, on the card."""
    if c.device.type == "cpu":
        return modulation_reference(c, w, b, dt)
    return gemm(dev(F.silu(c.float()), dt), dev(w, dt), bias=dev(b, dt), out_f32=True)
