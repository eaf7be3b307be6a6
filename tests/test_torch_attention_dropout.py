"""mdm_tpu_torch.ops.attention_dropout against the JAX kernels #7 and #8 on
the CPU.

The JAX side runs ``_call_fwd`` / ``_call_bwd`` under the Pallas
interpreter on the injected-bits path (``use_prng=False``), on the
operands its own wrapper builds (``_pad_operands``: q pre-scaled by
1/sqrt(Dh), S padded to 16 with -1e9 keys); the port's plain versions get
the same unpadded operands and the [:S, :S] slice of the same bits. JAX's
dq is the gradient of the pre-scaled q, so the port's is held against it
times the scale.

Tolerances: in f32 both sides compute the same products in another
summation order, 2e-5 absolute. In bf16 the forward rounds at the same
point (w before w . v): one bf16 ulp, 2^-6. The JAX backward runs in f32
while the port rounds dout, w and dlog to bf16 for its tensor-core
products (ops/attention_dropout.py): a few bf16 ulps on gradients of size
~1, 2^-4 absolute and 2^-5 relative (the train block's gradient bound,
tests/test_torch_attention_train_block.py).

The cases also sit on both sides of every tile and resident-row limit of
the card's forward (csrc/attention.cu: 64-row tiles, logits resident up to
S = 256) at head dims 32, 96, 128 and 256 (96 and 256: padded and widest
instances): these plain versions are the card's
oracle at exactly those shapes.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from mdm_tpu.ops import attention_dropout as JAD  # noqa: E402
from mdm_tpu_torch.ops import attention_dropout as AD  # noqa: E402
from mdm_tpu_torch.ops import dropout_bits as DB  # noqa: E402

B, D, H = 2, 64, 2
RATE = 0.25
F32_TOL = dict(atol=2e-5, rtol=2e-5)
BF16_TOL = dict(atol=2 ** -6, rtol=2 ** -6)
BF16_GRAD_TOL = dict(atol=2 ** -4, rtol=2 ** -5)


def _operands(S, mask, seed=0, width=D):
    rng = np.random.default_rng(seed)
    q, k, v, do = (rng.normal(size=(B, S, width)).astype(np.float32) for _ in range(4))
    kpm = None
    if mask == "bool":
        kpm = np.zeros((B, S), bool)
        kpm[1, max(S - 5, 1):] = True
    elif mask == "float":
        kpm = rng.normal(size=(B, S)).astype(np.float32)
    S_pad = -(-S // 16) * 16
    bits = rng.integers(0, 2 ** 32, size=(B, H, S_pad, S_pad), dtype=np.uint32)
    return q, k, v, do, kpm, bits


def _jax_kernels(q, k, v, do, kpm, bits, dtype, rate):
    """JAX #7 and #8 on the wrapper's padded, pre-scaled operands."""
    S = q.shape[1]
    c = lambda a: jnp.asarray(a).astype(dtype)
    qp, kp, vp, mask_row = JAD._pad_operands(c(q), c(k), c(v), H,
                                             None if kpm is None else jnp.asarray(kpm))
    S_pad = qp.shape[1]
    jbits = jnp.asarray(bits)
    out = JAD._call_fwd(qp, kp, vp, mask_row, None, jbits, H, rate, True)
    do_p = jnp.pad(jnp.asarray(do), [(0, 0), (0, S_pad - S), (0, 0)])
    dq, dk, dv = JAD._call_bwd(qp, kp, vp, mask_row, None, jbits, do_p, H, rate, True)
    f = lambda a: np.asarray(jnp.asarray(a[:, :S]).astype(jnp.float32))
    assert out.dtype == jnp.float32  # the pre-scale promotes q, and so the output
    scale = np.float32(1.0 / np.sqrt(q.shape[2] // H))
    return f(out), [f(dq) * scale, f(dk), f(dv)]


def _port(q, k, v, do, kpm, bits, dtype):
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dtype)
    S = q.shape[1]
    return (t(q), t(k), t(v), torch.from_numpy(do),
            None if kpm is None else torch.from_numpy(kpm),
            torch.from_numpy(np.ascontiguousarray(bits[:, :, :S, :S])))


# (S, Dh): the first two cases keep their ids; the rest are the card's
# tiling edges (1, 64 | 65, 256 | 257) at head dims 32, 96, 128 and 256.
EDGES = [(32, D // H), (37, D // H)] + [(S, Dh) for Dh in (32, 96, 128, 256)
                                      for S in (1, 64, 65, 256, 257)]
EDGE_IDS = ["32", "37"] + [f"{S}-dh{Dh}" for S, Dh in EDGES[2:]]


@pytest.mark.parametrize("S, Dh", EDGES, ids=EDGE_IDS)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("mask", [None, "bool", "float"])
def test_plain_forward_and_backward_match_jax_kernels(S, Dh, dtype, mask):
    ops = _operands(S, mask, width=H * Dh)
    ref_out, ref_grads = _jax_kernels(*ops, getattr(jnp, dtype), RATE)
    q, k, v, do, kpm, bits = _port(*ops, getattr(torch, dtype))
    out = AD.dropout_attention_reference(q, k, v, H, RATE, bits, kpm)
    grads = AD.dropout_attention_bwd_reference(q, k, v, H, do, RATE, bits, kpm)
    f32 = dtype == "float32"
    assert out.dtype == torch.float32 and all(g.dtype == torch.float32 for g in grads)
    np.testing.assert_allclose(out.numpy(), ref_out, **(F32_TOL if f32 else BF16_TOL))
    for name, g, r in zip(("dq", "dk", "dv"), grads, ref_grads):
        np.testing.assert_allclose(g.numpy(), r, err_msg=name,
                                   **(F32_TOL if f32 else BF16_GRAD_TOL))


def test_rate_zero_is_plain_attention():
    """At rate 0 the kernels draw nothing: #7 is #11's arithmetic."""
    from mdm_tpu_torch.ops import attention_v2 as TV2

    q, k, v, _, kpm, _ = _port(*_operands(37, "bool", seed=3), torch.float32)
    assert torch.equal(AD.dropout_attention_reference(q, k, v, H, 0.0, None, kpm),
                       TV2.attention_v2_reference(q, k, v, H, kpm))


def test_autograd_wrapper_is_the_plain_pair_with_grads_in_the_input_dtype():
    q, k, v, do, kpm, bits = _port(*_operands(32, "bool", seed=1), torch.bfloat16)
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    out = AD.fused_dropout_attention(*leaves, H, RATE, seed=0, key_padding_mask=kpm, bits=bits)
    out.backward(do)
    assert out.dtype == torch.float32
    assert torch.equal(out, AD.dropout_attention_reference(q, k, v, H, RATE, bits, kpm))
    ref = AD.dropout_attention_bwd_reference(q, k, v, H, do, RATE, bits, kpm)
    for leaf, g in zip(leaves, ref):  # autograd casts the f32 gradients to bf16
        assert leaf.grad.dtype == torch.bfloat16
        assert torch.equal(leaf.grad, g.to(torch.bfloat16))


def test_cpu_path_draws_the_kernels_philox_stream():
    """No injected bits: the plain path draws dropout_bits(seed, ...), the
    stream the CUDA kernels draw in-kernel."""
    q, k, v, _, kpm, _ = _port(*_operands(37, None, seed=2), torch.float32)
    out = AD.fused_dropout_attention(q, k, v, H, RATE, seed=4321)
    bits = DB.dropout_bits(4321, B, H, 37, device="cpu")
    assert torch.equal(out, AD.dropout_attention_reference(q, k, v, H, RATE, bits))
    assert not torch.equal(out, AD.dropout_attention_reference(q, k, v, H, RATE,
                                                               DB.dropout_bits(4322, B, H, 37, device="cpu")))
