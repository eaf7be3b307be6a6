"""mdm_tpu_torch.ops: the whole-layer op and the key-padding helper against
the JAX package, whose Pallas layer kernel runs here in interpret mode.

On the CPU the port's wrapper runs its plain PyTorch version; the CUDA
kernel chain itself is compared with that plain version on the card by
chip_smoke.py. Both sides round to the working dtype at the same points, so
f32 agrees to summation order (the 2e-5 bar of test_layer_inference.py).
In bf16 the two accumulate in f32 in different orders, so a value that
lands near a bf16 rounding boundary can round to its neighbour (one bf16
ulp is 2^-5 for |z| in [4, 8)); the bf16 bar is atol 2^-4 with rtol 2^-6.
"""
import re

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from mdm_tpu.ops import layer_inference as jax_li  # noqa: E402
from mdm_tpu.ops._mask import row_bias_contrib as jax_row_bias  # noqa: E402
from mdm_tpu_torch.ops import _build, layer_inference as li  # noqa: E402
from mdm_tpu_torch.ops._mask import row_bias_contrib  # noqa: E402

B, S, D, F, H = 3, 37, 128, 256, 4
NAMES = ("wq", "bq", "wk", "bk", "wv", "bv", "wo", "bo",
         "g1", "bl1", "w1", "b1", "w2", "b2", "g2", "bl2")
TOL = {"float32": dict(atol=2e-5, rtol=2e-5), "bfloat16": dict(atol=2 ** -4, rtol=2 ** -6)}


def _inputs(seed=0):
    rng = np.random.default_rng(seed)
    n = lambda *s, sc=1.0: (rng.normal(size=s) * sc).astype(np.float32)
    p = {}
    for k in ("wq", "wk", "wv", "wo"):
        p[k] = n(D, D, sc=D ** -0.5)
    for k in ("bq", "bk", "bv", "bo", "bl1", "b2", "bl2"):
        p[k] = n(D, sc=0.1)
    p["g1"], p["g2"] = 1 + n(D, sc=0.1), 1 + n(D, sc=0.1)
    p["w1"], p["b1"] = n(D, F, sc=D ** -0.5), n(F, sc=0.1)
    p["w2"] = n(F, D, sc=F ** -0.5)
    return n(B, S, D), p, rng


def torch_layer_args(p):
    """flax-layout layer weights ([in, out], separate q/k/v) -> the port's
    torch layout ([out, in], packed in_proj)."""
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a))
    return (t(np.concatenate([p["wq"].T, p["wk"].T, p["wv"].T])),
            t(np.concatenate([p["bq"], p["bk"], p["bv"]])),
            t(p["wo"].T), t(p["bo"]), t(p["g1"]), t(p["bl1"]),
            t(p["w1"].T), t(p["b1"]), t(p["w2"].T), t(p["b2"]), t(p["g2"]), t(p["bl2"]))


def _mask(kind, rng):
    if kind is None:
        return None
    pad = np.zeros((B, S), bool)
    pad[0, 30:] = True
    pad[2, 10:] = True
    if kind == "bool":
        return pad
    # an additive row: -1e9 on padding plus finite biases elsewhere
    return np.where(pad, -1e9, rng.normal(size=(B, S))).astype(np.float32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("mask", [None, "bool", "float"])
def test_layer_matches_jax_kernel(mask, dtype):
    x, p, rng = _inputs()
    m = _mask(mask, rng)
    ref = jax_li.fused_layer_inference(
        jnp.asarray(x).astype(dtype), *(jnp.asarray(p[k]) for k in NAMES), H,
        key_padding_mask=None if m is None else jnp.asarray(m), interpret=True)
    ref = np.asarray(ref.astype(jnp.float32))

    launches = li.LAUNCHES
    out = li.fused_layer_inference(
        torch.from_numpy(x).to(getattr(torch, dtype)), *torch_layer_args(p), H,
        key_padding_mask=None if m is None else torch.from_numpy(m))
    assert li.LAUNCHES == launches, "the CPU path must not count a kernel launch"
    assert out.dtype == getattr(torch, dtype) and out.shape == (B, S, D)
    np.testing.assert_allclose(out.float().numpy(), ref, **TOL[dtype])


def test_wrapper_on_cpu_is_the_plain_version():
    x, p, rng = _inputs(1)
    args = (torch.from_numpy(x), *torch_layer_args(p), H)
    m = torch.from_numpy(_mask("bool", rng))
    assert torch.equal(li.fused_layer_inference(*args, key_padding_mask=m),
                       li.layer_inference_reference(*args, key_padding_mask=m))


def test_row_bias_contrib_matches_jax():
    rng = np.random.default_rng(2)
    pad = rng.random((2, 9)) < 0.4
    row = rng.normal(size=(2, 9)).astype(np.float32)
    for v in (pad, row):
        ours = row_bias_contrib(torch.from_numpy(v))
        assert ours.dtype == torch.float32
        np.testing.assert_array_equal(ours.numpy(), np.asarray(jax_row_bias(jnp.asarray(v))))
    # a float row passes through unchanged
    assert torch.equal(row_bias_contrib(torch.from_numpy(row)), torch.from_numpy(row))


def _weights(D, F):
    return [torch.zeros(s) for s in ((3 * D, D), (3 * D,), (D, D), (D,), (D,), (D,),
                                     (F, D), (F,), (D, F), (D,), (D,), (D,))]


def test_kernel_operand_checks():
    check = li.check_kernel_operands
    flagship = torch.zeros(2, 5, 512, dtype=torch.bfloat16)
    check(flagship, _weights(512, 1024), 4, torch.zeros(2, 5, dtype=torch.bool))  # Dh = 128
    check(torch.zeros(2, 5, 128), _weights(128, 256), 4)  # the tests' width: Dh = 32
    # Every head dim runs: up to 256 in a padded instance of the core (rows
    # of 2-byte copies where they are no multiple of 8), above in the wide
    # kernels.
    check(torch.zeros(2, 5, 64), _weights(64, 128), 4)  # Dh = 16
    check(torch.zeros(2, 5, 384), _weights(384, 1024), 4)  # Dh = 96
    check(torch.zeros(2, 5, 1024, dtype=torch.bfloat16), _weights(1024, 1024), 4)  # Dh = 256
    check(torch.zeros(2, 5, 16), _weights(16, 32), 4)  # Dh = 4
    check(torch.zeros(2, 5, 512), _weights(512, 1024), 1)  # Dh = 512
    with pytest.raises(ValueError, match="multiples of 16"):
        check(flagship, _weights(512, 1000), 4)
    with pytest.raises(ValueError, match="dtype"):
        check(flagship.half(), _weights(512, 1024), 4)
    with pytest.raises(ValueError, match="divisible"):
        check(flagship, _weights(512, 1024), 3)
    bad = _weights(512, 1024)
    bad[8] = torch.zeros(1024, 512)  # linear2 given as [F, D]
    with pytest.raises(ValueError, match="operand 9"):
        check(flagship, bad, 4)
    with pytest.raises(ValueError, match="operand 13"):
        check(flagship, _weights(512, 1024), 4, torch.zeros(2, 6, dtype=torch.bool))


@pytest.mark.parametrize("D, heads, dh", [
    (128, 128, 1), (128, 32, 4), (384, 32, 12), (384, 4, 96), (1056, 4, 264), (1024, 2, 512),
    (1024, 1, 1024)])
def test_check_head_dim_takes_every_head_dim(D, heads, dh):
    """From 1 up (above 1024 too): the card runs each, forward and backward
    (chip_smoke.py's edge phases hold Dh 4, 12, 264, 512 and 1024)."""
    assert li.check_head_dim(D, heads, "layer") == dh


@pytest.mark.parametrize("D, heads", [(512, 3), (128, 0), (128, -4)])
def test_check_head_dim_raises_on_heads_that_do_not_split_d_model(D, heads):
    with pytest.raises(ValueError, match="not divisible"):
        li.check_head_dim(D, heads, "layer")


@pytest.mark.parametrize("backward", [False, True])
@pytest.mark.parametrize("S, dh", [(197, 12092), (197, 5849), (13000, 8)])
def test_the_f32_attention_path_names_its_row_limit(backward, S, dh, monkeypatch):
    """The f32 path has no row limit left: it streams its q, dO and S-long
    rows (csrc/attention.cu), so head dims and S past the 48 KB of shared
    memory it once held a row in (Dh 12092 forward and 5849 backward at
    S=197, S=13000) reach the kernel's entry point unrefused, with their
    shapes. A stand-in library records the launch."""
    from mdm_tpu_torch.ops import _chain

    calls = []

    class Lib:
        def __getattr__(self, name):
            return lambda *args: calls.append((name, args)) or 0

    monkeypatch.setattr(_chain._build, "load_library", lambda: Lib())
    monkeypatch.setattr(_chain, "stream", lambda t: 0)
    q = torch.zeros(1, S, dh)
    view = _chain.bsd_view(S, dh, dh)
    if backward:
        _chain.attention_bwd(q, q, q, view, q, view, q, q, q, 1, S, 1, dh)
    else:
        _chain.attention_fwd(q, q, q, view, q, view, 1, S, 1, dh)
    name = "mdm_attention_bwd" if backward else "mdm_attention_fwd"
    assert [c[0] for c in calls] == [name]
    assert calls[0][1][-6:] == (1, S, 1, dh, 0, 0)  # B, S, H, Dh, f32, stream


def test_other_devices_raise():
    x, p, _ = _inputs()
    with pytest.raises(ValueError, match="cpu or cuda"):
        li.fused_layer_inference(torch.from_numpy(x).to("meta"), *torch_layer_args(p), H)


def test_c_signatures_match_the_source():
    """Every ctypes binding declares as many arguments as its C function."""
    src = "".join((_build.CSRC / name).read_text() for name in _build.SOURCES)
    found = {m.group(1): m.group(2) for m in re.finditer(
        r'extern "C" int (\w+)\(([^)]*)\)', src)}
    assert set(found) == set(_build.SIGNATURES)
    for name, argtypes in _build.SIGNATURES.items():
        assert len(found[name].split(",")) == len(argtypes), name
    assert _build.library_path().parent == _build.BUILD_DIR
