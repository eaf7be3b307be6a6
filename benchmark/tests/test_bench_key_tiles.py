"""The two ``key_tiles_walked`` readers on fake counts: the share of score
tiles walked, None where nothing was counted or the window is of the other
phase, and the program's counter reset by each read."""
import pytest
import torch

from benchmark.harness import key_tiles
from benchmark.harness.registry import Registry
from benchmark.harness.trace import Observed

PHASES = {"key_tiles_walked.generate": "generate", "key_tiles_walked.train": "train"}


def _window(phase, units=2):
    return Observed((0, 1000), [("attn_fwd_bf16", 0, 500, True)], [],
                    {"phase": phase, "units": units})


@pytest.fixture
def counter(monkeypatch):
    """The program's per-card counters, faked on the CPU: set(walked, full)."""
    from mdm_tpu_torch.ops import _chain

    monkeypatch.setattr(_chain, "_KEY_TILES", {})
    return lambda walked, full: _chain._KEY_TILES.__setitem__(
        torch.device("cpu"), torch.tensor([walked, full], dtype=torch.int64))


@pytest.mark.parametrize("name", sorted(PHASES))
def test_the_share_walked_then_reset(counter, name):
    reader, phase = Registry().reader(name), PHASES[name]
    counter(58, 100)
    assert reader.read(_window(phase)) == pytest.approx(58.0)
    assert reader.read(_window(phase)) is None  # the read reset it: nothing counted since


@pytest.mark.parametrize("name", sorted(PHASES))
def test_none_with_nothing_counted(counter, name):
    reader, phase = Registry().reader(name), PHASES[name]
    assert reader.read(_window(phase)) is None
    counter(0, 0)
    assert reader.read(_window(phase)) is None


@pytest.mark.parametrize("name", sorted(PHASES))
def test_none_in_the_other_phase_or_an_empty_window(counter, name):
    reader, phase = Registry().reader(name), PHASES[name]
    other = "train" if phase == "generate" else "generate"
    counter(3, 4)
    assert reader.read(_window(other)) is None
    assert reader.read(_window(phase, units=0)) is None


def test_a_program_without_the_counter_gives_none(monkeypatch):
    """Over a parent checkout, whose ops have no counter, the reader returns
    None and raises nothing."""
    import mdm_tpu_torch.ops as ops

    monkeypatch.delattr(ops, "attention_key_tiles")
    assert key_tiles.program_counts() == (0, 0)
    assert Registry().reader("key_tiles_walked.generate").read(_window("generate")) is None


def test_the_counts_sum_over_cards(counter):
    from mdm_tpu_torch.ops import _chain

    counter(10, 40)
    _chain._KEY_TILES["another card"] = torch.tensor([30, 40])
    assert key_tiles.walked_share(_window("train"), "train") == pytest.approx(50.0)
    assert _chain._KEY_TILES == {}
