"""The three dump entry points of mdm_tpu_torch.ops.dropout_bits run on the
card unless the caller asks for the CPU, and on the CPU they return the
plain Philox stream (``philox_bits``) that the kernels draw in-kernel."""
import inspect

import pytest

torch = pytest.importorskip("torch")

from mdm_tpu_torch.ops import dropout_bits as DB  # noqa: E402

SEED, B, H, S, D, F = -1234, 2, 3, 5, 8, 12


def _stream(b, site, rows, cols):
    return DB.philox_bits(SEED, b, site, rows, cols).to(torch.uint32)


@pytest.mark.parametrize("name, args, expected", [
    ("dropout_bits", (B, H, S),
     lambda: (_stream(torch.arange(B)[:, None], torch.arange(H)[None, :], S, S),)),
    ("tail_dropout_bits", (B, S, D, F),
     lambda: tuple(_stream(torch.arange(B), site, S, n) for site, n in enumerate((D, F, D)))),
    ("sequence_dropout_bits", (B, S, D), lambda: (_stream(torch.arange(B), 0, S, D),)),
])
def test_dump_defaults_to_the_card_and_cpu_returns_philox_bits(name, args, expected):
    fn = getattr(DB, name)
    assert inspect.signature(fn).parameters["device"].default == "cuda"
    got = fn(SEED, *args, device="cpu")
    got = got if isinstance(got, tuple) else (got,)
    want = expected()
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.dtype == torch.uint32 and g.device.type == "cpu"
        assert torch.equal(g.to(torch.int64), w.to(torch.int64))


@pytest.mark.parametrize("shape", [(5,), (3, 32), (2, 3, 37), (1, 4, 520), (2, 1, 1000)])
@pytest.mark.parametrize("rate", [0.0, 0.1, 0.5, 0.9])
def test_keep_mask_bits_packs_the_keep_decisions(shape, rate):
    """Bit c % 32 of word c // 32 is set exactly where bits < keep_threshold:
    each element checked one by one in that order, ragged widths (not
    multiples of 32) leaving the last word's high bits clear."""
    g = torch.Generator().manual_seed(sum(shape))
    bits = torch.randint(0, 2 ** 32, shape, generator=g, dtype=torch.int64)
    bits[..., 0] = DB.keep_threshold(rate) - 1  # both sides of the threshold
    bits[..., -1] = DB.keep_threshold(rate)
    words = DB.keep_mask_bits(bits.to(torch.uint32), rate)
    n = shape[-1]
    assert words.dtype == torch.uint32 and words.shape == (*shape[:-1], -(-n // 32))
    w = words.to(torch.int64) & 0xFFFFFFFF
    kept = bits < DB.keep_threshold(rate)
    for c in range(-(-n // 32) * 32):
        bit = (w[..., c // 32] >> (c % 32)) & 1
        want = kept[..., c] if c < n else torch.zeros_like(bit, dtype=torch.bool)
        assert torch.equal(bit.bool(), want), c
    assert torch.equal(DB.keep_factors(bits, rate) > 0, kept)
