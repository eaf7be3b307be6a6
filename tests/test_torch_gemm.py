"""mdm_tpu_torch.ops._chain's products: which kernel takes each product
form of the layer, the attention block, the encoder tail and their
backwards, what the wgmma kernel refuses (raising, never rerouting), its
tile plan, the build log's names for its instances, and the f32 kernel's
precision scheme (3xTF32, emulated in torch).

The kernels themselves run only on the card: chip_smoke.py holds them
against ``a.float() @ w.float().T + b`` there. Here the operands are CPU
tensors of the call sites' shapes (flagship widths, a few rows).
"""
import pytest

torch = pytest.importorskip("torch")

from mdm_tpu_torch.ops import _build, _chain  # noqa: E402

M, D, F = 6 * 197, 512, 1024
bf, f32 = torch.bfloat16, torch.float32


def _t(*shape, dt=bf):
    return torch.zeros(*shape, dtype=dt)


def _shifted(*shape, dt=bf):
    """A contiguous tensor whose base lies one element past a 16-byte boundary."""
    n = 1
    for s in shape:
        n *= s
    return torch.zeros(n + 1, dtype=dt)[1:].view(*shape)


# (call site, operands and options as the wrapper passes them, kernel)
FORMS = [
    # forwards: x . W^T (+ bias), bf16 -> the wgmma kernel
    ("block/layer qkv = x Wqkv^T + b", lambda: (_t(M, D), _t(3 * D, D), dict(bias=_t(3 * D))),
     "wgmma"),
    ("block/layer out = ctx Wo^T + b", lambda: (_t(M, D), _t(D, D), dict(bias=_t(D))), "wgmma"),
    ("layer h = gelu(y W1^T + b1)", lambda: (_t(M, D), _t(F, D), dict(bias=_t(F))), "wgmma"),
    ("layer/tail o = h W2^T + b2 (f32 out)", lambda: (_t(M, F), _t(D, F), dict(bias=_t(D))),
     "wgmma"),
    ("tail u = y W1^T + b1 (f32 out)", lambda: (_t(M, D), _t(F, D), dict(bias=_t(F))), "wgmma"),
    ("no bias", lambda: (_t(M, D), _t(D, D), {}), "wgmma"),
    # backwards: dY . W and dY^T . X split-K, bf16 -> the wgmma kernel too
    ("block dctx = dO Wo", lambda: (_t(M, D), _t(D, D), dict(b_kn=True)), "wgmma"),
    ("block dWo = dO^T ctx", lambda: (_t(M, D), _t(M, D), dict(a_km=True, b_kn=True,
                                                               out_f32=True, splits=2)),
     "wgmma"),
    ("block dWqkv = dqkv^T x",
     lambda: (_t(M, 3 * D), _t(M, D), dict(a_km=True, b_kn=True, out_f32=True, splits=2)),
     "wgmma"),
    ("block dx = dqkv Wqkv", lambda: (_t(M, 3 * D), _t(3 * D, D), dict(b_kn=True)), "wgmma"),
    ("tail dW2 = do^T hd", lambda: (_t(M, D), _t(M, F), dict(a_km=True, b_kn=True,
                                                             out_f32=True, splits=2)),
     "wgmma"),
    ("tail dhd = do W2", lambda: (_t(M, D), _t(D, F), dict(b_kn=True, out_f32=True)), "wgmma"),
    ("tail dW1 = du^T y", lambda: (_t(M, F), _t(M, D), dict(a_km=True, b_kn=True,
                                                            out_f32=True, splits=2)),
     "wgmma"),
    ("tail dy = ds2 + du W1", lambda: (_t(M, F), _t(F, D), dict(b_kn=True, out_f32=True,
                                                                 r=_t(M, D, dt=f32))),
     "wgmma"),
    # split-K is the kernel's on every form
    ("x W^T split-K", lambda: (_t(M, D), _t(D, D), dict(out_f32=True, splits=2)), "wgmma"),
    ("dY^T X with K = 1", lambda: (_t(1, D), _t(1, D), dict(a_km=True, b_kn=True)), "wgmma"),
    # float32 (compute_dtype="float32") -> 3xTF32, every form
    ("f32 qkv", lambda: (_t(M, D, dt=f32), _t(3 * D, D, dt=f32), dict(bias=_t(3 * D, dt=f32))),
     "tf32x3"),
    ("f32 dWqkv", lambda: (_t(M, 3 * D, dt=f32), _t(M, D, dt=f32),
                           dict(a_km=True, b_kn=True, splits=2)), "tf32x3"),
    ("f32 dy", lambda: (_t(M, F, dt=f32), _t(F, D, dt=f32), dict(b_kn=True, r=_t(M, D, dt=f32))),
     "tf32x3"),
]


@pytest.mark.parametrize("site, operands, kernel", FORMS, ids=[f[0] for f in FORMS])
def test_each_product_form_takes_its_kernel(site, operands, kernel):
    a, b, opts = operands()
    assert _chain.gemm_kernel(a, b, **opts) == kernel


REFUSED = [
    ("K not a multiple of 8", lambda: (_t(M, 12), _t(D, 12), {}), "multiples of 8"),
    ("N not a multiple of 8", lambda: (_t(M, D), _t(12, D), {}), "multiples of 8"),
    ("a misaligned", lambda: (_shifted(M, D), _t(D, D), {}), "a contiguous and 16-byte"),
    ("b misaligned", lambda: (_t(M, D), _shifted(D, D), {}), "b contiguous and 16-byte"),
    ("bias misaligned", lambda: (_t(M, D), _t(D, D), dict(bias=_shifted(D))),
     "bias contiguous and 16-byte"),
    ("a not contiguous", lambda: (_t(D, M).T, _t(D, D), {}), "a contiguous"),
    ("a residual", lambda: (_t(M, D), _t(D, D), dict(r=_t(M, D, dt=f32))),
     "residual on the dY . W form only"),
    ("dY W + r, r misaligned", lambda: (_t(M, F), _t(F, D), dict(b_kn=True, out_f32=True,
                                                                  r=_shifted(M, D, dt=f32))),
     "r contiguous and 16-byte"),
    ("dY^T X + r", lambda: (_t(M, D), _t(M, D), dict(a_km=True, b_kn=True, out_f32=True,
                                                     r=_t(D, D, dt=f32))),
     "residual on the dY . W form only"),
    ("x W^T, one split of a split-K form", lambda: (_t(M, D), _t(D, D), dict(splits=2)),
     "f32 out"),
    ("bias in another dtype", lambda: (_t(M, D), _t(D, D), dict(bias=_t(D, dt=f32))),
     "share float32 or bfloat16"),
    ("a float16 operand", lambda: (_t(M, D, dt=torch.float16), _t(D, D, dt=torch.float16), {}),
     "share float32 or bfloat16"),
    # the backward forms
    ("dY W, N not a multiple of 8", lambda: (_t(M, D), _t(D, 12), dict(b_kn=True)),
     "multiples of 8"),
    ("dY W, K not a multiple of 8", lambda: (_t(M, 12), _t(12, D), dict(b_kn=True)),
     "multiples of 8"),
    ("dY^T X, M not a multiple of 8", lambda: (_t(M, 12), _t(M, D), dict(a_km=True, b_kn=True)),
     "multiples of 8"),
    ("dY^T X, N not a multiple of 8", lambda: (_t(M, D), _t(M, 12), dict(a_km=True, b_kn=True)),
     "multiples of 8"),
    ("dY W, b misaligned", lambda: (_t(M, D), _shifted(D, D), dict(b_kn=True)),
     "b contiguous and 16-byte"),
    ("dY^T X, a misaligned", lambda: (_shifted(M, D), _t(M, D), dict(a_km=True, b_kn=True)),
     "a contiguous and 16-byte"),
    ("dY W + r, r not contiguous", lambda: (_t(M, F), _t(F, D), dict(b_kn=True, out_f32=True,
                                                                      r=_t(D, M, dt=f32).T)),
     "r contiguous"),
    ("split-K into bf16", lambda: (_t(M, D), _t(M, D), dict(a_km=True, b_kn=True, splits=2)),
     "f32 out"),
    ("split-K with a residual",
     lambda: (_t(M, D), _t(M, D), dict(a_km=True, b_kn=True, out_f32=True, splits=2,
                                       r=_t(D, D, dt=f32))), "no bias, GELU or residual"),
    ("a split left empty", lambda: (_t(100, D), _t(100, D), dict(a_km=True, b_kn=True,
                                                                 out_f32=True, splits=3)),
     "leave one empty"),
    ("A^T . B^T", lambda: (_t(M, D), _t(D, M), dict(a_km=True)), "no A\\^T"),
    ("GELU on dY W", lambda: (_t(M, D), _t(D, D), dict(b_kn=True, gelu=True)),
     "GELU on the x . W\\^T form only"),
    ("GELU with a residual", lambda: (_t(M, D), _t(D, D), dict(gelu=True, r=_t(M, D, dt=f32))),
     "residual on the dY . W form only"),
]


@pytest.mark.parametrize("case, operands, match", REFUSED, ids=[r[0] for r in REFUSED])
def test_the_wrapper_raises_on_what_the_kernel_cannot_take(case, operands, match):
    """gemm raises before it builds or launches anything, and counts nothing."""
    a, b, opts = operands()
    before = dict(_chain.GEMM_LAUNCHES)
    with pytest.raises(ValueError, match=match):
        _chain.gemm(a, b, **opts)
    assert _chain.GEMM_LAUNCHES == before


@pytest.mark.parametrize("M_, N, K, row_tiles, tiles, k_steps, grid", [
    (12608, 512, 512, 99, 396, 8, 132),     # sampling out projection: 3 waves
    (12608, 1024, 512, 99, 792, 8, 132),    # sampling linear1: 6 waves
    (12608, 1536, 512, 99, 1188, 8, 132),   # sampling q/k/v: 9 waves
    (12608, 512, 1024, 99, 396, 16, 132),   # sampling linear2
    (25216, 1536, 512, 197, 2364, 8, 132),  # training q/k/v
    (394, 512, 512, 4, 16, 8, 16),          # serving batch 1 (CFG batch 2)
    (1, 1536, 512, 1, 12, 8, 12),
    (129, 512, 8, 2, 8, 1, 8),
])
def test_wgmma_plan(M_, N, K, row_tiles, tiles, k_steps, grid):
    plan = _chain.wgmma_plan(M_, N, K, sms=132)
    assert (plan["row_tiles"], plan["tiles"], plan["k_steps"], plan["grid"]) == (
        row_tiles, tiles, k_steps, grid)
    assert plan["waves"] == tiles / 132
    assert plan["col_tiles"] * plan["row_tiles"] == tiles


# The four weight gradients of the flagship training layer (K = B x S =
# 128 x 197 rows): (m, n, splits, items, K tiles per item, grid).
DW_PLANS = [
    ("dWo [D, D]", D, D, 8, 128, 50, 128),
    ("dWqkv [3D, D]", 3 * D, D, 8, 384, 50, 132),
    ("dW2 [D, F]", D, F, 4, 128, 99, 128),
    ("dW1 [F, D]", F, D, 4, 128, 99, 128),
]


@pytest.mark.parametrize("site, m, n, splits, items, k_steps, grid", DW_PLANS,
                         ids=[p[0] for p in DW_PLANS])
def test_split_k_plan_of_the_weight_gradients(site, m, n, splits, items, k_steps, grid):
    """splits_for gives each dW product (tile, split) items that fill the
    132 SMs (one or three whole waves, or within 5% of the best count), no
    split empty; wgmma_plan's schedule of them."""
    K = 128 * 197
    assert _chain.splits_for(m, n, K) == splits
    plan = _chain.wgmma_plan(m, n, K, sms=132, splits=splits)
    assert (plan["tiles"] * plan["splits"], plan["k_steps"], plan["grid"]) == (items, k_steps,
                                                                                grid)
    assert plan["waves"] == items / 132
    assert (splits - 1) * _chain.split_rows(K, splits) < K <= splits * _chain.split_rows(K, splits)
    assert _chain.split_rows(K, splits) % 64 == 0


@pytest.mark.parametrize("m, n, k, splits", [
    (D, D, 394, 1),     # the serving batch: too shallow to split
    (D, D, 1024, 2),    # 512 rows a split at least
    (128, 128, 25216, 31),
    (3 * D, D, 64 * 197, 8),
])
def test_splits_for_keeps_splits_deep_and_none_empty(m, n, k, splits):
    assert _chain.splits_for(m, n, k) == splits
    assert splits == 1 or k // splits >= 512
    assert (splits - 1) * _chain.split_rows(k, splits) < k


def test_the_sampling_products_fill_whole_waves():
    """At the CFG batch (M = 64 x 197 = 12608, 98.5 row tiles of 128) every
    product of the layer quantises onto the H100's 132 SMs exactly."""
    for N, K in ((3 * D, D), (D, D), (F, D), (D, F)):
        assert _chain.wgmma_plan(64 * 197, N, K)["waves"] in (3.0, 6.0, 9.0)


def test_ptxas_report_names_each_wgmma_instance():
    """Instances by (output type, epilogue: 0 plain, 1 GELU, 2 residual,
    A stored [K, M], B stored [K, N])."""
    mangled = ("_ZN12_GLOBAL__N_115gemm_bf16_wgmmaI{}EEv14CUtensorMap_stS1_S1_PK13__nv_bfloat16"
               "PKfiiiii")
    log = "\n".join([
        f"ptxas info    : Compiling entry function "
        f"'{mangled.format('13__nv_bfloat16Li1ELb0ELb0E')}' for 'sm_90a'",
        "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads",
        "ptxas info    : Used 168 registers, used 1 barriers, 1152 bytes cmem[0]",
        f"ptxas info    : Compiling entry function '{mangled.format('fLi0ELb1ELb1E')}' "
        "for 'sm_90a'",
        "    16 bytes stack frame, 8 bytes spill stores, 12 bytes spill loads",
        "ptxas info    : Used 154 registers",
        "ptxas info    : Compiling entry function "
        "'_ZN12_GLOBAL__N_115gemm_f32_tf32x3ILb0ELb1ELb1EEEvPKfS2_S2_S2_Pfiiiib' for 'sm_90a'",
        "ptxas info    : Used 176 registers"])
    assert _build.ptxas_report(log, "gemm_bf16_wgmma") == {
        "gemm_bf16_wgmma<bf16, 1, false, false>": dict(spill_stores=0, spill_loads=0,
                                                       registers=168),
        "gemm_bf16_wgmma<float, 0, true, true>": dict(spill_stores=8, spill_loads=12,
                                                      registers=154)}
    # the f32 kernel's instances by (A stored [K, M], B stored [K, N], 16-byte copies)
    assert _build.ptxas_report(log, "gemm_f32_tf32x3") == {
        "gemm_f32_tf32x3<false, true, true>": dict(registers=176)}
    assert _build.instance_name(mangled.format("fLi2ELb0ELb1E"), "gemm_bf16_wgmma") == \
        "gemm_bf16_wgmma<float, 2, false, true>"
    assert _build.instance_name("_Z3foov", "gemm_bf16_wgmma") == "_Z3foov"
    # a kernel that is no template reads as its name
    assert _build.instance_name("_ZN50_GLOBAL__N__346dd856_17_attention_wide_cu_9e269c3a16"
                                "attn_bwd_dq_wideEN3mdm4attn4AttnI13__nv_bfloat16EEPKS3_NS1_"
                                "4ViewEPS3_Pfi", "attn_bwd_dq_wide") == "attn_bwd_dq_wide"


def test_the_wgmma_kernel_is_built_and_bound():
    assert "gemm_sm90.cu" in _build.SOURCES
    assert _build.SIGNATURES["mdm_gemm_wgmma"][-1] is _build.SIGNATURES["mdm_gemm_f32"][-1]
    assert "mdm_gemm" not in _build.SIGNATURES  # bf16 products are the wgmma kernel's alone
    assert "mdm_attention_rowmask" not in _build.SIGNATURES


# The f32 kernel's arithmetic (csrc/gemm.cu, gemm_f32_tf32x3), emulated:
# each operand split into hi = tf32(x) and lo = tf32(x - hi) (cvt.rna),
# lo.hi + hi.lo + hi.hi per m16n8k8 step on the tensor cores (the
# products exact, their sum with the accumulator truncated toward zero to
# f32, as the tensor cores round), each 32-deep K tile summed from zero
# and added to the f32 accumulator with an ordinary rounding add.
TILE_K = 32


def tf32_rna(x: torch.Tensor) -> torch.Tensor:
    """cvt.rna.tf32.f32: 10 explicit mantissa bits, rounded to nearest on the
    13 dropped bits, ties away from zero (sign and magnitude: the carry may
    reach the exponent)."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def _mma_steps(acc: torch.Tensor, terms, k0: int, k1: int) -> torch.Tensor:
    """acc after the m16n8k8 steps over K [k0, k1) of each (a, b) term in
    turn: per step the 8 products and acc summed exactly (f64 holds them),
    then truncated toward zero to f32."""
    for s in range(k0, k1, 8):
        for a, b in terms:
            exact = acc.double() + a[:, s:s + 8].double() @ b[s:s + 8].double()
            f = exact.float()
            acc = torch.where(f.double().abs() > exact.abs(), torch.nextafter(f, torch.zeros_like(f)),
                              f)
    return acc


def product_3xtf32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    ah, bh = tf32_rna(a), tf32_rna(b)
    al, bl = tf32_rna(a - ah), tf32_rna(b - bh)
    acc = torch.zeros(a.shape[0], b.shape[1])
    for k0 in range(0, a.shape[1], TILE_K):
        part = _mma_steps(torch.zeros_like(acc), ((al, bh), (ah, bl), (ah, bh)), k0,
                          min(a.shape[1], k0 + TILE_K))
        acc = acc + part
    return acc


def product_1xtf32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """One TF32 pass into one accumulator: what TF32 matmuls do."""
    return _mma_steps(torch.zeros(a.shape[0], b.shape[1]), ((tf32_rna(a), tf32_rna(b)),), 0,
                      a.shape[1])


def test_tf32_rounding_is_to_nearest_ties_away():
    one = 1.0
    x = torch.tensor([one + 2 ** -11, -(one + 2 ** -11), one + 2 ** -12, one + 3 * 2 ** -11,
                      2 - 2 ** -12, 0.0, -0.0])
    want = torch.tensor([one + 2 ** -10, -(one + 2 ** -10), one, one + 2 ** -9, 2.0, 0.0, -0.0])
    got = tf32_rna(x)
    assert torch.equal(got, want) and torch.equal(torch.signbit(got), torch.signbit(want))
    v = torch.randn(1000, generator=torch.Generator().manual_seed(0))
    hi = tf32_rna(v)
    assert (hi.view(torch.int32) & 0x1FFF).eq(0).all()
    assert ((v - hi).abs() <= v.abs() * 2 ** -11).all()


# The main paths' reduction depths: K = 512 (the projections), 1024 (the
# FFN's second product), 3072 (DistilBERT's), and one split-K chunk of the
# weight gradients over B x S = 128 x 197 rows (splits_for gives 8: 3168
# rows, whole 32-row steps).
PRECISION_K = (512, 1024, 3072, 128 * 197 // 8 + 16)


@pytest.mark.parametrize("K", PRECISION_K)
@pytest.mark.parametrize("data", ["normal", "positive"])
def test_3xtf32_holds_the_f32_tolerance_and_1xtf32_does_not(K, data):
    """At 64 x 64 outputs of a product of depth K, against the f64 product:
    3xTF32 within TRAIN_REL["float32"] of max |product| (f32-level), one
    TF32 pass outside it. "positive": activations after a GELU (one-signed
    sums, where truncation's bias builds up)."""
    from chip_smoke import TRAIN_REL

    g = torch.Generator().manual_seed(K)
    a = torch.randn(64, K, generator=g)
    if data == "positive":
        a = torch.nn.functional.gelu(a)
    b = torch.randn(K, 64, generator=g) * K ** -0.5
    exact = a.double() @ b.double()
    scale = exact.abs().max()
    err3 = ((product_3xtf32(a, b).double() - exact).abs().max() / scale).item()
    err1 = ((product_1xtf32(a, b).double() - exact).abs().max() / scale).item()
    assert err3 <= TRAIN_REL["float32"] / 10, err3
    assert err1 > TRAIN_REL["float32"], err1
