"""mdm_tpu_torch.ops._chain.attention_f32_plan: the f32 attention core's
instance, tiles and shared memory for each head dim (csrc/attention_f32.cu
up to 256, the row kernels of csrc/attention.cu above), at every head dim
chip_smoke.py holds the core to on the card (EDGE_DH), and the decoding of
the kernels' own report (attention_f32_plan_on_card), which chip_smoke.py
holds equal to this plan on the card. No card needed.
"""
import pytest

torch = pytest.importorskip("torch")

from chip_smoke import EDGE_DH  # noqa: E402
from mdm_tpu_torch.ops import _build, _chain  # noqa: E402


@pytest.mark.parametrize("head_dim", EDGE_DH)
def test_every_f32_instance_fits_a_block(head_dim):
    """Each kernel of the instance a head dim runs in asks for at most the
    227 KB of shared memory an H100 block may take; up to 256 the tile
    kernels run (the head dim padded into the least of HEAD_DIMS that holds
    it, two ring stages where they fit, the dk/dv columns in two chunks
    above 128), above 256 the row kernels."""
    plan = _chain.attention_f32_plan(head_dim)
    assert max(plan["bytes"].values()) <= _chain.MAX_SMEM == 232448
    if head_dim > 256:
        assert plan["instance"] == "wide" and plan["padded_head_dim"] is None
        return
    dh = plan["padded_head_dim"]
    assert plan["instance"] == "tiled" and dh >= head_dim and dh in _chain.HEAD_DIMS
    assert dh == min(d for d in _chain.HEAD_DIMS if d >= head_dim)
    assert (plan["rows"], plan["cols"], plan["threads"]) == (64, 32, 128)
    assert plan["kv_chunks"] == (1 if dh <= 128 else 2)
    assert set(plan["stages"].values()) <= {1, 2}
    # two stages, unless one puts more blocks on an SM or two do not fit
    ld = 4 * (dh + 4)
    per_stage = dict(fwd=2 * 32 * ld, dq=2 * 32 * ld, dkv=2 * 32 * ld + 4 * 3 * 32)
    blocks = _chain.f32_blocks_per_sm
    for kernel, stages in plan["stages"].items():
        one = plan["bytes"][kernel] - (stages - 1) * per_stage[kernel]
        two = one + per_stage[kernel]
        assert blocks(plan["bytes"][kernel]) >= 1
        if stages == 1:
            assert two > _chain.MAX_SMEM or blocks(one) > blocks(two)
        else:
            assert blocks(two) >= blocks(one)
    # two blocks of 4 warps an SM (228 KB, 1 KB reserved a block) for every
    # kernel up to Dh 96, and at the flagship's 128 for the forward and dq
    # (dq by its one stage; dk/dv holds one at either depth)
    for kernel, nbytes in plan["bytes"].items():
        if dh <= 96 or (dh == 128 and kernel != "dkv"):
            assert 2 * (nbytes + 1024) <= 228 * 1024, kernel
    if dh == 128:
        assert plan["stages"] == dict(fwd=2, dq=1, dkv=2)
    assert "attention_f32.cu" in _build.SOURCES


def test_the_card_plan_reads_the_kernels_report(monkeypatch):
    """attention_f32_plan_on_card decodes mdm_attention_f32_plan's eleven
    ints (padded head dim; stages, bytes of the forward, dq and dk/dv;
    dk/dv's chunks; blocks per SM), and a 0 head dim as the row kernels."""
    import ctypes

    class Lib:
        def mdm_attention_f32_plan(self, head_dim, address):
            plan = (ctypes.c_int * 11).from_address(address)
            if head_dim > 256:
                plan[0] = 0
                return 0
            plan[:] = [128, 2, 1, 2, 111616, 111616, 156416, 1, 2, 2, 1]
            return 0

    monkeypatch.setattr(_chain._build, "load_library", lambda: Lib())
    got = _chain.attention_f32_plan_on_card(128)
    want = _chain.attention_f32_plan(128)
    for key in ("padded_head_dim", "stages", "bytes", "kv_chunks"):
        assert got[key] == want[key], key
    assert got["blocks_per_sm"] == dict(fwd=2, dq=2, dkv=1)
    assert _chain.attention_f32_plan_on_card(512) == dict(instance="wide")
