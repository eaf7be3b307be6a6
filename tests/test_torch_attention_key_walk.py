"""The attention core's key walk stops at each batch element's last live key
(csrc/attention.cuh::live_extent). On the card: the six tile kernels (bf16
and f32 forward, dq, dk/dv) bitwise equal to the full walk, which a bias of
-9.9e8 in place of -1e9 forces, and the score tiles they count
(``mdm_tpu_torch/scripts/key_walk_check.py``). On the CPU: the premise of
that comparison in the plain softmax, and the wrapper's counter argument.

    python -m pytest --noconftest tests/test_torch_attention_key_walk.py -m card   # on the card
"""
import math

import pytest
import torch

from mdm_tpu_torch.ops import _chain
from mdm_tpu_torch.ops.attention import attention_probs
from mdm_tpu_torch.scripts import key_walk_check as KW


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the tile kernels run on the card only")
    return "cuda"


@pytest.mark.card
def test_the_shortened_walk_is_bitwise_the_full_walk(card):
    got = KW.check(card)
    assert got["cases"] == 16 and 0.0 < got["walked_share"] < 1.0


def test_the_rows_extents():
    """Each prefix row ends at its live count; the live-dead-live row at its
    second live run; the row with no live key walks everything. Only -1e9
    and below (with -inf) is dead: -9.9e8 and NaN are live."""
    rows = KW.key_rows("cpu")
    assert KW.extents(rows) == [*KW.LIVE, 160, KW.S]
    forced = KW.full_walk(rows)
    assert KW.extents(forced) == [KW.S] * rows.shape[0]
    assert torch.equal(forced[-1], rows[-1])  # no live key: walks in full as it is
    odd = torch.full((1, KW.S), -1e9)
    odd[0, 7] = float("nan")
    odd[0, 30] = -math.inf
    assert KW.extents(odd) == [8]


@pytest.mark.parametrize("dh", [128, 192])
def test_the_full_walks_bias_gives_the_same_softmax(dh):
    """The plain softmax of the masked rows and of the same rows at -9.9e8 is
    bitwise one and the same: a dead key's exp is 0 either way where a row
    has a live key, and a row with no live key (kept as it is) is uniform.
    So the card's full-walk comparison holds the kernels to their own
    result."""
    q, k, _, _ = KW._operands(torch.float32, dh, 9, "cpu")
    rows = KW.key_rows("cpu")
    p = attention_probs(q, k, rows[:, None, None, :])
    assert torch.equal(p, attention_probs(q, k, KW.full_walk(rows)[:, None, None, :]))
    dead = (rows <= -1e9)[:-1, None, None, :].expand_as(p[:-1])
    assert torch.all(p[:-1].masked_select(dead) == 0)
    assert torch.equal(p[-1], torch.full_like(p[-1], 1.0 / KW.S))


def test_the_counts_the_extents_give():
    """Rows that leave every tile live walk what a full walk does; MDM's
    lengths of 40-196 walk about 58% of the bf16 key tiles (2.32 of 4) and
    60% of the f32 ones (4.20 of 7)."""
    for dtype in (torch.bfloat16, torch.float32):
        for backward in (False, True):
            walked, full = KW.expected_tiles([KW.S] * 3, dtype, 128, backward)
            assert walked == full > 0
    ext = [L + 1 for L in range(40, 197)]
    walked, full = KW.expected_tiles(ext, torch.bfloat16, 128, False)
    assert walked / full == pytest.approx(364 / 157 / 4)
    walked, full = KW.expected_tiles(ext, torch.float32, 128, False)
    assert walked / full == pytest.approx(659 / 157 / 7)


@pytest.mark.parametrize("backward", [False, True])
def test_the_counter_is_passed_only_while_a_profiler_records(backward, monkeypatch):
    """Untraced launches pass a null counter, so the kernels execute no
    atomic; while a profiler records they pass the card's counter, and
    ``attention_key_tiles`` reads it once and forgets it. A stand-in
    library records the launch."""
    calls = []

    class Lib:
        def __getattr__(self, name):
            return lambda *args: calls.append(args) or 0

    monkeypatch.setattr(_chain._build, "load_library", lambda: Lib())
    monkeypatch.setattr(_chain, "stream", lambda t: 0)
    monkeypatch.setattr(_chain, "_KEY_TILES", {})
    S, dh = 37, 32
    q = torch.zeros(1, S, dh)
    view = _chain.bsd_view(S, dh, dh)

    def launch():
        if backward:
            _chain.attention_bwd(q, q, q, view, q, view, q, q, q, 1, S, 1, dh)
        else:
            _chain.attention_fwd(q, q, q, view, q, view, 1, S, 1, dh)
        return calls[-1][-7]  # the counter, just before B, S, H, Dh, dtype, stream

    assert launch() is None
    counter = torch.tensor([5, 8])  # stands for the card's int64 [2]
    _chain._KEY_TILES[q.device] = counter
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        assert launch() == counter.data_ptr()
    assert launch() is None
    assert _chain.attention_key_tiles() == (5, 8)
    assert _chain.attention_key_tiles() == (0, 0)
