"""The control, the plain reference put in the program's place a step below
the configuration's precision (fp8 products for bfloat16, TF32 for
float32), comes out not correct, and the program's sound run correct.

On the CPU at a tiny size for the bfloat16 cells (TF32 exists only on the
card); on the card (``-m card``) at each cell's own size, on three seeds."""
import pytest

import benchmark.control as control
from benchmark.harness.registry import Registry

BF16 = ["mdm_humanml.generate_b128", "dip_humanml.generate_ar_b512", "mdm_humanml.train_bf16_b512"]
CELLS = BF16 + ["mdm_humanml.train_f32_b64"]


@pytest.mark.parametrize("name", BF16)
def test_control_fails_at_a_tiny_size(tiny, name):
    out = control.readings(tiny, name, 2 ** 31 + 5, ["control"], 1, "cpu")
    assert not out["control"].correct()


@pytest.mark.card
@pytest.mark.parametrize("name", CELLS)
def test_control_fails_at_the_cells_size(card, name):
    reg = Registry()
    for seed in (7001, 7002, 7003):
        out = control.readings(reg, name, seed, ["program", "control"], 1, card)
        assert out["program"].correct() and not out["control"].correct(), (seed, {
            m: c.values for m, c in out.items()})
