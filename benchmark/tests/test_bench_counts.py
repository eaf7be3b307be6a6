"""The operation counts reproduce the bounds of the port's kernel table
(PERF.md), which were counted by hand from the same conventions: each of
those kernels is bound by its operations, its bytes being the whole
chain's inputs and outputs. A piece of ``Work`` is one kernel's, with the
bytes that kernel itself reads and writes."""
import pytest

from benchmark.counts import flops


def _layer_ms(parts, B, S, D, F, dtype, heads_dim=None):
    w = flops.Work()
    M = B * S
    shapes = {"qkv": (D, 3 * D), "out": (D, D), "ffn1": (D, F), "ffn2": (F, D)}
    for p in parts:
        if p == "attn":
            w.attention("x", B * S * S, M, M, D, dtype)
        else:
            w.product("x", M, *shapes[p], dtype)
    return w.flops["x"] / flops.peak_flops(dtype) * 1e3


@pytest.mark.parametrize("what, parts, B, S, D, F, dtype, ms", [
    ("#1 sampling layer", ("qkv", "out", "ffn1", "ffn2", "attn"), 64, 197, 512, 1024, "bfloat16", 0.0586),
    ("#1 f32", ("qkv", "out", "ffn1", "ffn2", "attn"), 64, 197, 512, 1024, "float32", 0.3513),
    ("#2 train block forward", ("qkv", "out", "attn"), 128, 197, 512, 1024, "bfloat16", 0.0638),
    ("#4 encoder tail forward", ("ffn1", "ffn2"), 128, 197, 512, 1024, "bfloat16", 0.0535),
    ("#2 rate-0 at DiP's shape", ("qkv", "out", "attn"), 64, 60, 512, 1024, "bfloat16", 0.0086),
    ("#2 at DistilBERT's shape, f32", ("qkv", "out", "attn"), 32, 64, 768, 3072, "float32", 0.0610),
])
def test_forward_bounds(what, parts, B, S, D, F, dtype, ms):
    assert _layer_ms(parts, B, S, D, F, dtype) == pytest.approx(ms, abs=5e-5), what


@pytest.mark.parametrize("what, layer, ms", [("#3 train block backward", "attention", 0.1275),
                                             ("#5 encoder tail backward", "tail", 0.1069)])
def test_backward_bounds(what, layer, ms):
    w = flops.Work()
    M, D, F = 128 * 197, 512, 1024
    if layer == "attention":
        for K, N in ((D, 3 * D), (D, D)):
            w.product("x", M, K, N, "bfloat16", train=True)
        w.attention("x", 128 * 197 * 197, M, M, D, "bfloat16", train=True)
        forward = 0.0638
    else:
        for K, N in ((D, F), (F, D)):
            w.product("x", M, K, N, "bfloat16", train=True)
        forward = 0.0535
    assert w.flops["x"] / 989e12 * 1e3 - forward == pytest.approx(ms, abs=1e-4), what


def test_least_time_is_the_larger_bound():
    assert flops.least_time(989e9, 0, "bfloat16") == pytest.approx(1e-3)
    assert flops.least_time(1.0, 3.35e9, "bfloat16") == pytest.approx(1e-3)
    assert flops.least_time(165e9, 0, "float32") == pytest.approx(1e-3)


def test_masked_rows_count_only_what_the_masks_leave():
    cfg = dict(latent_dim=512, ff_size=1024, num_layers=8, njoints=263, nfeats=1,
               text_dim=512, arch="trans_enc")
    full = flops.mdm_forward(flops.Work(), cfg, "bfloat16", [197] * 4)
    half = flops.mdm_forward(flops.Work(), cfg, "bfloat16", [99] * 4)
    assert half.flops["products"] == pytest.approx(full.flops["products"] * 99 / 197)
    assert half.flops["attention"] == pytest.approx(full.flops["attention"] * (99 / 197) ** 2)


def test_attention_at_197_rows_is_bound_by_its_bytes():
    """q, k and v read once, the output written once: S / 2 operations a
    byte in bf16, below the card's ridge, so the bytes bind."""
    w = flops.Work()
    w.attention("x", 64 * 197 * 197, 64 * 197, 64 * 197, 512, "bfloat16")
    assert w.bytes["x"] == 2 * 512 * 4 * 64 * 197
    assert w.least_s["x"] == pytest.approx(w.bytes["x"] / 3.35e12)
