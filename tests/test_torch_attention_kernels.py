"""The forward-only attention kernels of mdm_tpu_torch against the JAX
kernels on the CPU: #10 ``fused_attention``, #11 ``fused_attention_v2`` and
#12 ``fused_attention_block``, each JAX function run through the Pallas
interpreter (``interpret=True``), the port's plain version on the same
inputs from numpy seeds.

Tolerances: in f32 both sides compute the same products in another
summation order (the JAX wrappers pre-scale q, the port scales the f32
logits), 2e-5 absolute on values of size ~1. In bf16 the rounding points
agree (p rounded to v's dtype; #12 also q/k/v, the attention output and
the projection); a value near a bf16 rounding boundary may round either
way after another summation order: one bf16 ulp of the value's size, 2^-6
absolute and relative (tests/test_torch_attention_train_block.py's bound).
No row is masked in full (see ops/attention_v2.py).

#10's cases also sit on both sides of every tile and resident-row limit of
the card's forward (csrc/attention.cu: 64-row tiles, logits resident up to
S = 256) at head dims 32, 96, 128 and 256 (96 and 256: padded and widest
instances), 4 (rows of 2-byte copies) and 512 (csrc/attention_wide.cu):
these plain versions are the card's oracle at exactly those shapes.
"""
import ctypes
import re

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from mdm_tpu.ops import attention as JA  # noqa: E402
from mdm_tpu.ops import attention_block as JAB  # noqa: E402
from mdm_tpu.ops import attention_v2 as JV2  # noqa: E402
from mdm_tpu_torch.ops import _build  # noqa: E402
from mdm_tpu_torch.ops import attention as TA  # noqa: E402
from mdm_tpu_torch.ops import attention_block as TAB  # noqa: E402
from mdm_tpu_torch.ops import attention_v2 as TV2  # noqa: E402

B, D, H = 2, 64, 2
F32_TOL = dict(atol=2e-5, rtol=2e-5)
BF16_TOL = dict(atol=2 ** -6, rtol=2 ** -6)


def _tol(dtype):
    return F32_TOL if dtype == "float32" else BF16_TOL


def _mask(S, kind, rng):
    """None, a ragged bool key-padding mask [B, S] (True = ignore; the first
    keys of every row kept), or a finite float row."""
    if kind == "bool":
        kpm = np.zeros((B, S), bool)
        kpm[1, max(S - 5, 1):] = True
        kpm[0, max(S // 2, 1):] = True
        return kpm
    if kind == "float":
        return rng.normal(size=(B, S)).astype(np.float32)
    return None


def _jnp(a, dtype):
    return jnp.asarray(a).astype(getattr(jnp, dtype))


def _torch(a, dtype):
    return torch.from_numpy(np.ascontiguousarray(a)).to(getattr(torch, dtype))


# (S, Dh): the first two cases keep their ids; the rest are the card's
# tiling edges (1, 64 | 65, 256 | 257) at head dims 32, 96, 128 and 256, 4
# (no multiple of 8: 2-byte row copies) and 512 (the wide kernels).
EDGES = [(32, D // H), (37, D // H)] + [(S, Dh) for Dh in (32, 96, 128, 256, 4, 512)
                                      for S in (1, 64, 65, 256, 257)]
EDGE_IDS = ["32", "37"] + [f"{S}-dh{Dh}" for S, Dh in EDGES[2:]]


@pytest.mark.parametrize("S, Dh", EDGES, ids=EDGE_IDS)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("bias_kind", ["none", "row", "full_shared", "full_per_head"])
def test_xla_attention_matches_fused_attention(S, Dh, dtype, bias_kind):
    """#10 on [B, H, S, Dh] with no bias, a [B, 1, 1, S] row, or a full
    [B, 1|H, S, S] bias."""
    rng = np.random.default_rng(S)
    q, k, v = (rng.normal(size=(B, H, S, Dh)).astype(np.float32) for _ in range(3))
    bias = {"none": None,
            "row": np.where(_mask(S, "bool", rng), -1e9, 0.0)[:, None, None, :],
            "full_shared": rng.normal(size=(B, 1, S, S)),
            "full_per_head": rng.normal(size=(B, H, S, S))}[bias_kind]
    bias = None if bias is None else bias.astype(np.float32)
    ref = JA.fused_attention(_jnp(q, dtype), _jnp(k, dtype), _jnp(v, dtype),
                             None if bias is None else jnp.asarray(bias), interpret=True)
    out = TA.xla_attention(_torch(q, dtype), _torch(k, dtype), _torch(v, dtype),
                           None if bias is None else torch.from_numpy(bias))
    assert out.dtype == torch.float32 and ref.dtype == jnp.float32
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **_tol(dtype))
    cpu = TA.fused_attention(_torch(q, dtype), _torch(k, dtype), _torch(v, dtype),
                             None if bias is None else torch.from_numpy(bias))
    assert torch.equal(cpu, out)  # a CPU tensor runs the plain version


def test_xla_attention_is_the_jax_einsum_route_in_f32():
    rng = np.random.default_rng(7)
    q, k, v = (rng.normal(size=(B, H, 21, 32)).astype(np.float32) for _ in range(3))
    bias = rng.normal(size=(B, H, 21, 21)).astype(np.float32)
    ref = JA.xla_attention(*(jnp.asarray(t) for t in (q, k, v, bias)))
    out = TA.xla_attention(*(torch.from_numpy(t) for t in (q, k, v, bias)))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **F32_TOL)


@pytest.mark.parametrize("S", [32, 37])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("mask", [None, "bool", "float"])
def test_attention_v2_reference_matches_jax_kernel(S, dtype, mask):
    """#11 on [B, S, H*Dh] with a key-padding row."""
    rng = np.random.default_rng(100 + S)
    q, k, v = (rng.normal(size=(B, S, D)).astype(np.float32) for _ in range(3))
    kpm = _mask(S, mask, rng)
    ref = JV2.fused_attention_v2(_jnp(q, dtype), _jnp(k, dtype), _jnp(v, dtype), H,
                                 key_padding_mask=None if kpm is None else jnp.asarray(kpm),
                                 interpret=True)
    tq, tk, tv = (_torch(t, dtype) for t in (q, k, v))
    tkpm = None if kpm is None else torch.from_numpy(kpm)
    out = TV2.attention_v2_reference(tq, tk, tv, H, tkpm)
    assert out.dtype == torch.float32 and ref.dtype == jnp.float32
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **_tol(dtype))
    assert torch.equal(TV2.fused_attention_v2(tq, tk, tv, H, tkpm), out)


@pytest.mark.parametrize("S", [32, 37])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("masked", [False, True])
def test_attention_block_reference_matches_jax_kernel(S, dtype, masked):
    """#12: projections + attention + out projection, bool mask only."""
    rng = np.random.default_rng(200 + S)
    x = rng.normal(size=(B, S, D)).astype(np.float32)
    ws = [(rng.normal(size=(D, D)) / np.sqrt(D)).astype(np.float32) for _ in range(4)]
    bs = [(rng.normal(size=(D,)) * 0.1).astype(np.float32) for _ in range(4)]
    params = [t for w, b in zip(ws, bs) for t in (w, b)]
    kpm = _mask(S, "bool", rng) if masked else None
    ref = JAB.fused_attention_block(_jnp(x, dtype), *(jnp.asarray(t) for t in params), H,
                                    key_padding_mask=None if kpm is None else jnp.asarray(kpm),
                                    interpret=True)
    tkpm = None if kpm is None else torch.from_numpy(kpm)
    tparams = [torch.from_numpy(t) for t in params]
    out = TAB.attention_block_reference(_torch(x, dtype), *tparams, H, tkpm)
    assert out.dtype == getattr(torch, dtype)
    np.testing.assert_allclose(out.float().numpy(), np.asarray(ref.astype(jnp.float32)),
                               **_tol(dtype))
    assert torch.equal(TAB.fused_attention_block(_torch(x, dtype), *tparams, H, tkpm), out)


def test_attention_block_takes_a_bool_mask_only():
    x = torch.zeros(1, 4, 8)
    w, b = torch.eye(8), torch.zeros(8)
    with pytest.raises(ValueError, match="bool"):
        TAB.fused_attention_block(x, w, b, w, b, w, b, w, b, 2,
                                  key_padding_mask=torch.zeros(1, 4))


_C_TYPES = {"long long": ctypes.c_longlong, "unsigned": ctypes.c_uint, "float": ctypes.c_float,
            "int": ctypes.c_int}


def test_c_argument_types_match_the_bindings():
    """Every argument of every exported C function has the ctypes type of
    its binding: a pointer c_void_p, a 64-bit stride c_longlong (a c_int
    would cut it), int/unsigned/float their own."""
    src = "".join((_build.CSRC / name).read_text() for name in _build.SOURCES)
    found = {m.group(1): m.group(2) for m in re.finditer(r'extern "C" int (\w+)\(([^)]*)\)', src)}
    assert set(found) == set(_build.SIGNATURES)
    for name, argtypes in _build.SIGNATURES.items():
        for arg, ctype in zip(found[name].split(","), argtypes):
            decl = " ".join(arg.split()[:-1]).replace("const ", "")
            want = ctypes.c_void_p if "*" in arg else _C_TYPES[decl]
            assert ctype is want, f"{name}: {arg.strip()} bound as {ctype.__name__}"


def test_ptxas_report_names_each_forward_instance():
    """The build log's ptxas lines, per instance of a kernel, under its
    template arguments; other kernels' lines are left out."""
    log = "\n".join([
        "ptxas info    : Compiling entry function "
        "'_ZN12_GLOBAL__N_113attn_fwd_bf16ILi128EfLb1EEEvNS_4AttnI13__nv_bfloat16EEPT0_NS_4ViewE'"
        " for 'sm_90a'",
        "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads",
        "ptxas info    : Used 214 registers, used 1 barriers, 464 bytes cmem[0]",
        "ptxas info    : Compiling entry function "
        "'_ZN12_GLOBAL__N_113attn_fwd_bf16ILi32E13__nv_bfloat16Lb0EEEvNS_4AttnIS1_EEPT0_NS_4ViewE'"
        " for 'sm_90a'",
        "    8 bytes stack frame, 4 bytes spill stores, 8 bytes spill loads",
        "ptxas info    : Used 128 registers",
        "ptxas info    : Compiling entry function "
        "'_ZN12_GLOBAL__N_116attn_bwd_dq_bf16ILi128EEEvv' for 'sm_90a'",
        "ptxas info    : Used 255 registers"])
    assert _build.ptxas_report(log, "attn_fwd_bf16") == {
        "attn_fwd_bf16<128, float, true>": dict(spill_stores=0, spill_loads=0, registers=214),
        "attn_fwd_bf16<32, bf16, false>": dict(spill_stores=4, spill_loads=8, registers=128)}
