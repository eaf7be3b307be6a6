"""mdm_tpu_torch.ops.encoder_tail against the JAX kernel on the CPU.

The JAX side runs kernels #4 and #5 through ``tail_fwd_with_bits`` /
``tail_bwd_with_bits`` (the injected-bits path) under the Pallas
interpreter; the port's plain versions get the same three bit tensors (at
S=37 JAX's bits cover the rows padded to 48, the port gets rows [:37]).
Tolerances: in f32 the two sides differ by summation order and by the TPU
kernel's A&S 7.1.26 erf (within 1.5e-7 of erf), so 2e-5 on values of size
~1 and 5e-5 relative on the gradients, which sum B*S terms through two
LayerNorm backwards. In bf16 the rounding points agree; a value near a
bf16 rounding boundary may round either way: one bf16 ulp (2^-6 near 1)
on outputs, a few ulps on gradients.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from mdm_tpu.ops import encoder_tail as JET  # noqa: E402
from mdm_tpu_torch.ops import dropout_bits as DB  # noqa: E402
from mdm_tpu_torch.ops import encoder_tail as ET  # noqa: E402

B, D, F = 2, 64, 128
RATE = 0.2
F32_TOL = dict(atol=2e-5, rtol=2e-5)
F32_GRAD_TOL = dict(atol=5e-5, rtol=5e-5)
BF16_TOL = dict(atol=2 ** -6, rtol=2 ** -6)
BF16_GRAD_TOL = dict(atol=2 ** -3, rtol=2 ** -4)


def _operands(S, seed=0):
    rng = np.random.default_rng(seed)
    n = lambda *s, sc=1.0: (rng.normal(size=s) * sc).astype(np.float32)
    x, attn = n(B, S, D), n(B, S, D)
    params = [1 + n(D, sc=0.1), n(D, sc=0.1), n(D, F, sc=D ** -0.5), n(F, sc=0.1),
              n(F, D, sc=F ** -0.5), n(D, sc=0.1), 1 + n(D, sc=0.1), n(D, sc=0.1)]  # JAX layout
    S_pad = -(-S // 16) * 16
    bits = [rng.integers(0, 2 ** 32, size=(B, S_pad, k), dtype=np.uint32) for k in (D, F, D)]
    dz = n(B, S, D)
    return x, attn, params, bits, dz


def _port(x, attn, params, bits, dz, dtype):
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dtype)
    S = x.shape[1]
    g1, bl1, w1, b1, w2, b2, g2, bl2 = params
    tp = [t(g1), t(bl1), t(w1.T), t(b1), t(w2.T), t(b2), t(g2), t(bl2)]
    tb = [torch.from_numpy(np.ascontiguousarray(b[:, :S])).to(torch.uint32) for b in bits]
    return t(x), t(attn), tp, tb, t(dz)


def _jax(x, attn, params, bits, dz, dtype):
    c = lambda a: jnp.asarray(a).astype(dtype)
    ops = [c(x), c(attn), *(c(p) for p in params)]
    jb = [jnp.asarray(b) for b in bits]
    out = JET.tail_fwd_with_bits(*ops, RATE, *jb, interpret=True)
    grads = JET.tail_bwd_with_bits(*ops, RATE, *jb, c(dz), interpret=True)
    f = lambda a: np.asarray(jnp.asarray(a).astype(jnp.float32))
    dx, da, dg1, dbl1, dw1, db1, dw2, db2, dg2, dbl2 = (f(g) for g in grads)
    torch_layout = [dx, da, dg1[0], dbl1[0], dw1.T, db1[0], dw2.T, db2[0], dg2[0], dbl2[0]]
    return f(out), torch_layout


@pytest.mark.parametrize("S", [32, 37])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_forward_and_backward_match_jax_kernel(S, dtype):
    ops = _operands(S)
    ref_out, ref_grads = _jax(*ops, getattr(jnp, dtype))
    x, attn, params, bits, dz = _port(*ops, getattr(torch, dtype))
    out = ET.encoder_tail_reference(x, attn, *params, RATE, bits)
    grads = ET.encoder_tail_bwd_reference(x, attn, *params, dz, RATE, bits)
    f32 = dtype == "float32"
    np.testing.assert_allclose(out.float().numpy(), ref_out, **(F32_TOL if f32 else BF16_TOL))
    names = ["dx", "dattn", "dg1", "dbl1", "dW1", "db1", "dW2", "db2", "dg2", "dbl2"]
    for name, g, r in zip(names, grads, ref_grads):
        np.testing.assert_allclose(g.float().numpy(), r, err_msg=name,
                                   **(F32_GRAD_TOL if f32 else BF16_GRAD_TOL))


def test_autograd_wrapper_is_the_plain_pair_with_grads_in_the_working_dtype():
    x, attn, params, bits, dz = _port(*_operands(32, seed=1), torch.bfloat16)
    leaves = [t.float().requires_grad_() for t in params]
    xr, ar = x.clone().requires_grad_(), attn.clone().requires_grad_()
    z = ET.fused_encoder_tail(xr, ar, *leaves, RATE, seed=0, bits=bits)
    z.backward(dz)
    assert torch.equal(z, ET.encoder_tail_reference(x, attn, *params, RATE, bits))
    ref = ET.encoder_tail_bwd_reference(x, attn, *params, dz, RATE, bits)
    assert torch.equal(xr.grad, ref[0]) and torch.equal(ar.grad, ref[1])
    for p, g in zip(leaves, ref[2:]):  # f32 sums rounded to bf16, then widened
        assert torch.equal(p.grad, g.to(torch.bfloat16).float())


def test_cpu_path_draws_the_kernels_philox_stream():
    x, attn, params, _, _ = _port(*_operands(37, seed=2), torch.float32)
    z = ET.fused_encoder_tail(x, attn, *params, RATE, seed=-77)
    bits = DB.tail_dropout_bits(-77, B, 37, D, F, device="cpu")
    assert torch.equal(z, ET.encoder_tail_reference(x, attn, *params, RATE, bits))
    for b in bits:
        kept = (DB.keep_factors(b, RATE) > 0).float().mean().item()
        assert abs(kept - (1 - RATE)) < 0.02


def test_rate0_inference_entry_matches_jax():
    x, attn, params, bits, dz = _operands(37, seed=3)
    ref = JET.fused_encoder_tail_inference(jnp.asarray(x), jnp.asarray(attn),
                                           *(jnp.asarray(p) for p in params), interpret=True)
    xt, at, tp, _, _ = _port(x, attn, params, bits, dz, torch.float32)
    out = ET.fused_encoder_tail_inference(xt, at, *tp)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **F32_TOL)


def test_chunk_rows_and_mask_words_match_the_kernels():
    """The chain sizes the backward's column partials by csrc/encoder_tail.cu's
    fixed chunk of rows, and each site's packed mask row by keep_mask_bits's
    words."""
    import re

    from mdm_tpu_torch.ops import _build

    src = (_build.CSRC / "encoder_tail.cu").read_text()
    assert int(re.search(r"constexpr int CHUNK_ROWS = (\d+);", src).group(1)) == ET.CHUNK_ROWS
    for n in (8, 32, 40, 520, 1000, 1024):
        bits = torch.zeros(2, n, dtype=torch.uint32)
        assert DB.keep_mask_bits(bits, RATE).shape == (2, ET.mask_words(n))
