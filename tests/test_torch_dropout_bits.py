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
