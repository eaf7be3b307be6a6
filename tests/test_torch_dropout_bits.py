"""The three dump entry points of mdm_tpu_torch.ops.dropout_bits run on the
card unless the caller asks for the CPU, and on the CPU they return the
plain Philox stream (``philox_bits``) that the kernels draw in-kernel."""
import inspect
import re
import types

import pytest

torch = pytest.importorskip("torch")

from mdm_tpu_torch.ops import _build  # noqa: E402
from mdm_tpu_torch.ops import dropout_bits as DB  # noqa: E402

SEED, B, H, S, D, F = -1234, 2, 3, 5, 8, 12


_M32 = 0xFFFFFFFF
# Each entry point at the small shape and at the edges of the card's plan:
# one word a row, odd and even rows, 1, 3 and 32 heads, batch 1 and 5,
# ragged tail widths (d_model 8 and 136, ff 12 and 4096), row widths of
# one word, 197 and 1025; each at these seeds and the edge seeds.
DUMP_CASES = [
    ("dropout_bits", (B, H, S)), ("dropout_bits", (1, 1, 1)), ("dropout_bits", (5, 3, 3)),
    ("dropout_bits", (1, 32, 4)), ("dropout_bits", (5, 1, 37)),
    ("tail_dropout_bits", (B, S, D, F)), ("tail_dropout_bits", (1, 1, 8, 12)),
    ("tail_dropout_bits", (5, 3, 136, 12)), ("tail_dropout_bits", (1, 4, 8, 4096)),
    ("sequence_dropout_bits", (B, S, D)), ("sequence_dropout_bits", (1, 1, 1)),
    ("sequence_dropout_bits", (5, 3, 1025)), ("sequence_dropout_bits", (1, 8, 197)),
]
DUMP_SEEDS = (SEED, 0, -1, 2 ** 31 - 1)


def _philox_word(seed, c0, c1, c2, c3):
    """Word 0 of Philox4x32-10 at counter (c0..c3), key (seed, 0), on Python
    ints straight from Salmon et al. (SC'11): independent of philox4x32."""
    k0, k1 = seed & _M32, 0
    for r in range(10):
        if r:
            k0, k1 = (k0 + 0x9E3779B9) & _M32, (k1 + 0xBB67AE85) & _M32
        p0, p1 = 0xD2511F53 * c0, 0xCD9E8D57 * c2
        c0, c1, c2, c3 = ((p1 >> 32) ^ c1 ^ k0) & _M32, p1 & _M32, ((p0 >> 32) ^ c3 ^ k1) & _M32, \
            p0 & _M32
    return c0


def _streams(name, args):
    """Each output's (batch, site, rows, columns) in the stream; site None:
    the attention dump's, whose site is the head."""
    if name == "dropout_bits":
        b, _, s = args
        return [(b, None, s, s)]
    if name == "tail_dropout_bits":
        b, s, d, f = args
        return [(b, site, s, n) for site, n in enumerate((d, f, d))]
    b, s, d = args
    return [(b, 0, s, d)]


def _corners(shape):
    """The first, last and a middle index of an array of this shape."""
    return [tuple(0 for _ in shape), tuple(n - 1 for n in shape), tuple(n // 2 for n in shape)]


@pytest.mark.parametrize("seed", DUMP_SEEDS)
@pytest.mark.parametrize("name, args", DUMP_CASES)
def test_dump_defaults_to_the_card_and_cpu_returns_philox_bits(name, args, seed):
    """On the CPU each output is philox_bits at its sites (the attention
    dump's head h at site h, the tail's three at 0, 1, 2); its corners are
    held against the scalar Philox at (column, row, site, batch)."""
    fn = getattr(DB, name)
    assert inspect.signature(fn).parameters["device"].default == "cuda"
    got = fn(seed, *args, device="cpu")
    got = got if isinstance(got, tuple) else (got,)
    streams = _streams(name, args)
    assert len(got) == len(streams)
    for g, (nb, site, rows, cols) in zip(got, streams):
        assert g.dtype == torch.uint32 and g.device.type == "cpu"
        b = torch.arange(nb)
        if site is None:
            want = DB.philox_bits(seed, b[:, None], torch.arange(g.shape[1])[None, :], rows, cols)
        else:
            want = DB.philox_bits(seed, b, site, rows, cols)
        g = g.to(torch.int64)
        assert g.shape == want.shape and torch.equal(g, want)
        for idx in _corners(g.shape):
            at = idx[1] if site is None else site
            assert g[idx].item() == _philox_word(seed, idx[-1], idx[-2], at, idx[0]), idx


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


def test_card_entry_points_launch_once_with_the_c_arguments(monkeypatch):
    """On the card each entry point is one call of its C function, whose
    arguments (named as in csrc/dropout_bits.cu) get the entry point's
    shape: the tail's three outputs through mdm_philox_dump3, the other two
    through mdm_philox_dump (site -1: the heads are the sites). A stand-in
    library records the calls; meta tensors stand in for the card's."""
    src = (_build.CSRC / "dropout_bits.cu").read_text()
    params = {m.group(1): [a.split()[-1].lstrip("*") for a in m.group(2).split(",")]
              for m in re.finditer(r'extern "C" int (\w+)\(([^)]*)\)', src)}
    assert params == {"mdm_philox_dump": ["out", "seed", "boff", "B", "H", "site", "R", "C",
                                          "hoff", "stream"],
                      "mdm_philox_dump3": ["out0", "out1", "out2", "seed", "boff", "B", "R", "C0",
                                           "C1", "C2", "foff", "stream"]}
    for name, names in params.items():
        assert len(_build.SIGNATURES[name]) == len(names)
    calls = []

    class Lib:
        def __getattr__(self, name):
            return lambda *args: calls.append((name, dict(zip(params[name], args)))) or 0

    monkeypatch.setattr(DB._build, "load_library", lambda: Lib())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: types.SimpleNamespace(cuda_stream=7))
    monkeypatch.setattr(DB, "LAUNCHES", dict.fromkeys(DB.LAUNCHES, 0))
    outs = DB.tail_dropout_bits(SEED, B, S, D, F, device="meta")
    assert [tuple(o.shape) for o in outs] == [(B, S, D), (B, S, F), (B, S, D)]
    bits = DB.dropout_bits(SEED, B, H, S, device="meta")
    seq = DB.sequence_dropout_bits(SEED, B, S, D, device="meta")
    assert bits.shape == (B, H, S, S) and seq.shape == (B, S, D)
    common = dict(seed=SEED, boff=0, B=B, R=S, stream=7)
    assert calls == [
        ("mdm_philox_dump3", dict(out0=0, out1=0, out2=0, C0=D, C1=F, C2=D, foff=0, **common)),
        ("mdm_philox_dump", dict(out=0, H=H, site=-1, C=S, hoff=0, **common)),
        ("mdm_philox_dump", dict(out=0, H=1, site=0, C=D, hoff=0, **common)),
    ]
    assert DB.LAUNCHES == {"dropout_bits": 1, "tail_dropout_bits": 1, "sequence_dropout_bits": 1}
    # A data-parallel rank's first global row reaches the counter's batch word.
    DB.sequence_dropout_bits(SEED, B, S, D, device="meta", batch_offset=B)
    DB.tail_dropout_bits(SEED, B, S, D, F, device="meta", batch_offset=2 * B)
    assert [c[1]["boff"] for c in calls[3:]] == [B, 2 * B]
    # A tensor-parallel rank's first head and first FFN column reach theirs.
    DB.dropout_bits(SEED, B, H, S, device="meta", head_offset=3 * H)
    DB.tail_dropout_bits(SEED, B, S, D, F, device="meta", ffn_offset=F)
    assert calls[5][1]["hoff"] == 3 * H and calls[6][1]["foff"] == F
    with pytest.raises(ValueError, match="uint32"):
        DB._dump_into([torch.empty(4, dtype=torch.int32, device="meta")], SEED, 1, 1, 0, 1)
    with pytest.raises(ValueError, match="contiguous"):
        DB._dump_into([torch.empty(4, 4, dtype=torch.uint32, device="meta").T], SEED, 1, 1, 0, 4)


# sha256 of the words of dropout_bits(20, 3, 4, 37, key_len=41) and then
# tail_dropout_bits(20, 3, 37, 40, 72), both at batch_offset 5, taken from
# the stream before the model offsets existed: at offset 0 no word moved.
OFFSET_ZERO_SHA256 = "368ad1344c66d3000c9055d69b2191253b18d8a9ed4ecc4a93115bfb9fa6e2cf"


def test_offset_zero_words_are_the_words_before_the_model_offsets():
    import hashlib

    h = hashlib.sha256()
    for words in (DB.dropout_bits(20, 3, 4, 37, "cpu", key_len=41, batch_offset=5, head_offset=0),
                  *DB.tail_dropout_bits(20, 3, 37, 40, 72, "cpu", batch_offset=5, ffn_offset=0)):
        h.update(words.numpy().tobytes())
    assert h.hexdigest() == OFFSET_ZERO_SHA256


@pytest.mark.parametrize("parts", [2, 4])
@pytest.mark.parametrize("seed", [SEED, 2 ** 31 - 1])
def test_model_offsets_give_each_rank_its_slice_of_the_whole_dump(seed, parts):
    """A tensor-parallel rank holding heads [h0, h0 + H/P) and FFN columns
    [f0, f0 + F/P) draws exactly those heads and columns of the whole
    layer's dumps: #9 at ``head_offset`` (the cross-attention's [S, Sk] rows
    too), #6's site 1 at ``ffn_offset``; its sites 0 and 2 stay whole."""
    Hw, Fw, Sq, Sk, b0 = 8, 24, 7, 9, 3
    whole = DB.dropout_bits(seed, B, Hw, Sq, "cpu", key_len=Sk, batch_offset=b0)
    tail = DB.tail_dropout_bits(seed, B, S, D, Fw, "cpu", batch_offset=b0)
    h, f = Hw // parts, Fw // parts
    for i in range(parts):
        part = DB.dropout_bits(seed, B, h, Sq, "cpu", key_len=Sk, batch_offset=b0,
                               head_offset=i * h)
        assert torch.equal(part, whole[:, i * h:(i + 1) * h])
        mine = DB.tail_dropout_bits(seed, B, S, D, f, "cpu", batch_offset=b0, ffn_offset=i * f)
        assert torch.equal(mine[0], tail[0]) and torch.equal(mine[2], tail[2])
        assert torch.equal(mine[1], tail[1][..., i * f:(i + 1) * f])
        # the plain stream at the column offset, word for word
        assert torch.equal(mine[1].to(torch.int64), DB.philox_bits(
            seed, torch.arange(B), 1, S, f, batch_offset=b0, col_offset=i * f))
    assert torch.equal(DB.philox_bits(seed, 0, 1, 2, 3, col_offset=2 ** 32),
                       DB.philox_bits(seed, 0, 1, 2, 3))  # the column word wraps at 2^32
