"""mdm_tpu_torch.ops.attention_train_block against the JAX kernel on the CPU.

The JAX side runs kernels #2 and #3 (``TB._call_fwd`` / ``_call_bwd``)
under the Pallas interpreter on the injected-bits path; the port's plain
versions get the same bits (at S=37 JAX runs the rows and keys padded to
48 and the port gets the [:37, :37] slice). Tolerances: in f32 both sides
compute the same products in another summation order, so 2e-5 absolute on
values of size ~1 and 2e-5 relative on the weight gradients, which sum
B*S terms. In bf16 the rounding points agree, but a value that lands near
a bf16 rounding boundary may round either way, and the flip carries
through the later products: one bf16 ulp of the value's size (2^-7
relative, 2^-6 absolute near 1) for outputs and a few ulps for gradients.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from mdm_tpu.ops import attention_train_block as JTB  # noqa: E402
from mdm_tpu_torch.ops import attention_train_block as TB  # noqa: E402
from mdm_tpu_torch.ops import dropout_bits as DB  # noqa: E402

B, D, H = 2, 64, 2
RATE = 0.25
F32_TOL = dict(atol=2e-5, rtol=2e-5)
BF16_TOL = dict(atol=2 ** -6, rtol=2 ** -6)
BF16_GRAD_TOL = dict(atol=2 ** -4, rtol=2 ** -5)


def _operands(S, seed=0, D=D):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(B, S, D)).astype(np.float32)
    ws = [(rng.normal(size=(D, D)) / np.sqrt(D)).astype(np.float32) for _ in range(4)]  # [in, out]
    bs = [(rng.normal(size=(D,)) * 0.1).astype(np.float32) for _ in range(4)]
    kpm = np.zeros((B, S), bool)
    kpm[1, S - 5:] = True
    S_pad = -(-S // 16) * 16
    bits = rng.integers(0, 2 ** 32, size=(B, H, S_pad, S_pad), dtype=np.uint32)
    do = rng.normal(size=(B, S, D)).astype(np.float32)
    return x, ws, bs, kpm, bits, do


def _jax_call(x, ws, bs, kpm, bits, do, dtype, rate):
    """JAX kernels #2/#3 on padded operands (the wrapper's own padding)."""
    S, D = x.shape[1:]
    S_pad = bits.shape[-1]
    pad = [(0, 0), (0, S_pad - S), (0, 0)]
    mask_row = np.zeros((B, 1, S_pad), np.float32)
    mask_row[:, :, S:] = -1e9
    mask_row[:, 0, :S] += np.where(kpm, -1e9, 0.0).astype(np.float32)
    c = lambda a: jnp.asarray(a).astype(dtype)
    xp = jnp.pad(c(x), pad)
    wb = [t for w, b in zip(ws, bs) for t in (c(w), c(b).reshape(1, D))]
    out = JTB._call_fwd(xp, *wb, jnp.asarray(mask_row), None, jnp.asarray(bits), H, rate, True)
    grads = JTB._call_bwd(xp, *wb[:7], jnp.asarray(mask_row), None, jnp.asarray(bits),
                          jnp.pad(c(do), pad), H, rate, True)
    f = lambda a: np.asarray(jnp.asarray(a).astype(jnp.float32))
    return f(out[:, :S]), [f(grads[0][:, :S])] + [f(g) for g in grads[1:]]


def _port_operands(x, ws, bs, kpm, bits, do, dtype):
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dtype)
    S = x.shape[1]
    wqkv = t(np.concatenate([w.T for w in ws[:3]]))
    bqkv = t(np.concatenate(bs[:3]))
    bits_s = torch.from_numpy(np.ascontiguousarray(bits[:, :, :S, :S])).to(torch.uint32)
    return t(x), wqkv, bqkv, t(ws[3].T), t(bs[3]), torch.from_numpy(kpm), bits_s, t(do)


def _jax_grads_torch_layout(grads):
    """JAX (dx, dwq, dbq, dwk, dbk, dwv, dbv, dwo, dbo) -> the port's
    (dx, dWqkv [3D, D], dbqkv, dWo [D, D], dbo)."""
    dx, dwq, dbq, dwk, dbk, dwv, dbv, dwo, dbo = grads
    return [dx, np.concatenate([dwq.T, dwk.T, dwv.T]), np.concatenate([dbq, dbk, dbv], axis=-1)[0],
            dwo.T, dbo[0]]


# (S, head dim): the first two keep their ids; Dh 96 runs in a padded
# instance of the card's core.
@pytest.mark.parametrize("S, Dh", [(32, D // H), (37, D // H), (37, 96)],
                         ids=["32", "37", "37-dh96"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_forward_and_backward_match_jax_kernel(S, Dh, dtype):
    ops = _operands(S, D=H * Dh)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    ref_out, ref_grads = _jax_call(*ops, jdt, RATE)
    x, wqkv, bqkv, wo, bo, kpm, bits, do = _port_operands(*ops, tdt)
    out = TB.train_attention_block_reference(x, wqkv, bqkv, wo, bo, H, RATE, bits, kpm)
    grads = TB.train_attention_block_bwd_reference(x, wqkv, bqkv, wo, H, do, RATE, bits, kpm)
    f32 = dtype == "float32"
    np.testing.assert_allclose(out.float().numpy(), ref_out, **(F32_TOL if f32 else BF16_TOL))
    names = ["dx", "dWqkv", "dbqkv", "dWo", "dbo"]
    for name, g, r in zip(names, grads, _jax_grads_torch_layout(ref_grads)):
        np.testing.assert_allclose(g.float().numpy(), r, err_msg=name,
                                   **(F32_TOL if f32 else BF16_GRAD_TOL))


def test_autograd_wrapper_is_the_plain_pair_with_grads_in_the_working_dtype():
    x, ws, bs, kpm, bits, do = _operands(32, seed=1)
    x, wqkv, bqkv, wo, bo, kpm, bits, do = _port_operands(x, ws, bs, kpm, bits, do,
                                                          torch.bfloat16)
    params = [t.float().requires_grad_() for t in (wqkv, bqkv, wo, bo)]
    xr = x.clone().requires_grad_()
    out = TB.fused_train_attention_block(xr, *params, H, RATE, seed=0, key_padding_mask=kpm,
                                         bits=bits)
    out.backward(do)
    assert torch.equal(out, TB.train_attention_block_reference(x, wqkv, bqkv, wo, bo, H, RATE,
                                                               bits, kpm))
    ref = TB.train_attention_block_bwd_reference(x, wqkv, bqkv, wo, H, do, RATE, bits, kpm)
    assert torch.equal(xr.grad, ref[0])
    for p, g in zip(params, ref[1:]):  # f32 sums rounded to bf16, then widened
        assert p.grad.dtype == torch.float32
        assert torch.equal(p.grad, g.to(torch.bfloat16).float())


def test_cpu_path_draws_the_kernels_philox_stream():
    """No injected bits: the plain path draws dropout_bits(seed, ...), the
    stream the CUDA kernel draws in-kernel."""
    x, ws, bs, kpm, bits, do = _operands(37, seed=2)
    x, wqkv, bqkv, wo, bo, kpm, _, _ = _port_operands(x, ws, bs, kpm, bits, do, torch.float32)
    out = TB.fused_train_attention_block(x, wqkv, bqkv, wo, bo, H, RATE, seed=1234)
    bits = DB.dropout_bits(1234, B, H, 37, device="cpu")
    assert torch.equal(out, TB.train_attention_block_reference(x, wqkv, bqkv, wo, bo, H, RATE,
                                                               bits))
    kept = (DB.keep_factors(bits, RATE) > 0).float().mean().item()
    assert abs(kept - (1 - RATE)) < 0.02


def test_philox_matches_random123_known_answers():
    """Philox4x32-10 of csrc/philox.cuh, in its plain torch form, against
    the Random123 known-answer vectors (kat_vectors, philox4x32_10)."""
    kat = [((0, 0, 0, 0), (0, 0), (0x6627E8D5, 0xE169C58D, 0xBC57AC4C, 0x9B00DBD8)),
           ((0xFFFFFFFF,) * 4, (0xFFFFFFFF,) * 2, (0x408F276D, 0x41C83B0E, 0xA20BC7C6, 0x6D5451FD)),
           ((0x243F6A88, 0x85A308D3, 0x13198A2E, 0x03707344), (0xA4093822, 0x299F31D0),
            (0xD16CFE09, 0x94FDCCEB, 0x5001E420, 0x24126EA1))]
    for ctr, key, want in kat:
        assert tuple(int(w) for w in DB.philox4x32(ctr, key)) == want


@pytest.mark.parametrize("masked", [False, True])
def test_rate0_inference_entry_matches_jax(masked):
    x, ws, bs, kpm, bits, do = _operands(37, seed=3)
    kpm_j = jnp.asarray(kpm) if masked else None
    ref = JTB.fused_block_attention_inference(
        jnp.asarray(x), *(t for w, b in zip(ws, bs) for t in (jnp.asarray(w), jnp.asarray(b))),
        H, key_padding_mask=kpm_j, interpret=True)
    xt, wqkv, bqkv, wo, bo, kpm_t, _, _ = _port_operands(x, ws, bs, kpm, bits, do,
                                                         torch.float32)
    out = TB.fused_block_attention_inference(xt, wqkv, bqkv, wo, bo, H,
                                             key_padding_mask=kpm_t if masked else None)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **F32_TOL)
