"""The products of the plain reference, at a stated precision.

Every matrix product of the reference goes through one ``Precision``:

- ``f32``: float32 with TF32 off, the reference itself;
- ``tf32``: float32 operands on TF32 (10-bit mantissas), the control of a
  float32 configuration;
- ``fp8``: each product's operands rounded to float8 e4m3 with a scale per
  tensor (its largest magnitude to 448), accumulated in float32, and in a
  backward the incoming gradient rounded to e5m2 the same way: the control
  of a bfloat16 configuration.

Nothing here imports the program under test.
"""
from __future__ import annotations

import contextlib

import torch

PRECISIONS = ("f32", "tf32", "fp8")
_E4M3_MAX = 448.0
_E5M2_MAX = 57344.0


def round_fp8(t: torch.Tensor, dtype=torch.float8_e4m3fn, top: float = _E4M3_MAX) -> torch.Tensor:
    """``t`` rounded to an fp8 format under one scale for the whole tensor,
    returned in float32."""
    t = t.float()
    amax = t.abs().amax()
    scale = torch.where(amax > 0, top / amax, torch.ones_like(amax))
    return (t * scale).to(dtype).float() / scale


class _Fp8Product(torch.autograd.Function):
    """a @ b on fp8-rounded operands; the backward's products round the
    incoming gradient to e5m2 and reuse the rounded operands."""

    @staticmethod
    def forward(ctx, a, b):
        qa, qb = round_fp8(a), round_fp8(b)
        ctx.save_for_backward(qa, qb)
        return qa @ qb

    @staticmethod
    def backward(ctx, g):
        qa, qb = ctx.saved_tensors
        qg = round_fp8(g, torch.float8_e5m2, _E5M2_MAX)
        return qg @ qb.transpose(-1, -2), qa.transpose(-1, -2) @ qg


class Precision:
    def __init__(self, name: str = "f32"):
        if name not in PRECISIONS:
            raise ValueError(f"precision {name!r}: one of {PRECISIONS}")
        self.name = name

    @contextlib.contextmanager
    def scope(self):
        """TF32 on for ``tf32`` and off otherwise, for the body; restored after."""
        saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
        on = self.name == "tf32"
        torch.backends.cuda.matmul.allow_tf32 = on
        torch.backends.cudnn.allow_tf32 = on
        try:
            yield self
        finally:
            torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved

    def mm(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        """a [..., M, K] @ b [..., K, N], both of one rank."""
        if self.name == "fp8":
            return _Fp8Product.apply(a, b)
        return a.float() @ b.float()

    def linear(self, x: torch.Tensor, w: torch.Tensor, b=None) -> torch.Tensor:
        """x [..., K] . w[N, K]^T (+ b)."""
        y = self.mm(x.reshape(-1, x.shape[-1]), w.t()).reshape(*x.shape[:-1], w.shape[0])
        return y if b is None else y + b
