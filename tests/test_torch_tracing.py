"""mdm_tpu_torch.utils.tracing: spans cost one shared no-op while no
profiler records; under torch.profiler they are ranges that nest on a
thread, make each generation one ``sample.request``, split a train step in
order, and hold the operations run inside them (small CPU models, no card)."""
import pytest

torch = pytest.importorskip("torch")

from mdm_tpu_torch.diffusion import Schedule  # noqa: E402
from mdm_tpu_torch.models import MDM, Conditioning, MDMConfig  # noqa: E402
from mdm_tpu_torch.sampling import GenerationConfig, MotionGenerator  # noqa: E402
from mdm_tpu_torch.utils import tracing  # noqa: E402

TRAIN_PARTS = ["train.draws", "train.forward", "train.backward", "train.reduce", "train.update"]


def _mdm(**kw):
    model = MDM(MDMConfig(latent_dim=32, ff_size=64, num_layers=2, num_heads=2, **kw))
    return model.init_weights(torch.Generator().manual_seed(0))


def _profile():
    return torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU])


def _ranges(prof, keep=lambda name: "." in name and not name.startswith("aten::")):
    """(name, start, end, thread) of the profiler's host events, by start."""
    return sorted(((e.name(), e.start_ns(), e.start_ns() + e.duration_ns(), e.start_thread_id())
                   for e in prof.profiler.kineto_results.events() if keep(e.name())),
                  key=lambda r: (r[1], -r[2]))


def _inside(inner, outer):
    return outer[3] == inner[3] and outer[1] <= inner[1] and inner[2] <= outer[2]


def _parent(r, ranges):
    """The innermost other range on ``r``'s thread that holds it."""
    holders = [o for o in ranges if o is not r and _inside(r, o)]
    return min(holders, key=lambda o: o[2] - o[1], default=None)


def test_off_records_nothing_and_shares_one_context():
    """Outside a profiler every span is one shared no-op; ``traced`` keeps
    the function's name, doc and signature."""
    a, b = tracing.span("x"), tracing.span("y")
    assert a is b is tracing._NOOP
    with a, b:
        pass

    @tracing.traced("t.fn")
    def fn(x, *, y=1):
        """doc"""
        return x + y

    assert fn(1, y=2) == 3 and fn.__name__ == "fn" and fn.__doc__ == "doc"
    assert MDM.forward.__name__ == "forward" and hasattr(MDM.forward, "__wrapped__")
    with _profile():
        assert tracing.span("x") is not tracing._NOOP
    assert tracing.span("x") is tracing._NOOP


def test_nesting_under_the_profiler():
    @tracing.traced("t.leaf")
    def leaf():
        return torch.ones(2).sum()

    with _profile() as prof:
        with tracing.span("t.outer"):
            with tracing.span("t.inner"):
                leaf()
            leaf()
        leaf()
    ranges = _ranges(prof, lambda n: n.startswith("t."))
    assert [r[0] for r in ranges] == ["t.outer", "t.inner", "t.leaf", "t.leaf", "t.leaf"]
    outer, inner, leaf1, leaf2, leaf3 = ranges
    assert _parent(outer, ranges) is None and _parent(inner, ranges) is outer
    assert _parent(leaf1, ranges) is inner and _parent(leaf2, ranges) is outer
    assert _parent(leaf3, ranges) is None and inner[2] <= leaf2[1]


@pytest.mark.parametrize("dip", [False, True])
def test_a_generation_is_one_request(dip):
    if dip:
        model = _mdm(arch="trans_dec", text_dim=48, text_tokens=True, context_len=2, pred_len=4)
        cond = Conditioning(text_embed=torch.zeros(1, 3, 48), prefix=torch.zeros(1, 2, 263))
        config = GenerationConfig(sampler="ddim", autoregressive=True)
    else:
        model, cond, config = _mdm(), Conditioning(text_embed=torch.zeros(1, 512)), \
            GenerationConfig()
    gen = MotionGenerator(model, Schedule.create("cosine", 100, "2"), config)
    with _profile() as prof:
        gen.generate(cond, 1, 6, torch.Generator().manual_seed(0))
        gen.generate(cond, 1, 6, torch.Generator().manual_seed(0))
    ranges = _ranges(prof)
    requests = [r for r in ranges if r[0] == "sample.request"]
    assert len(requests) == 2 and requests[0][2] <= requests[1][1]
    first = [r for r in ranges if _inside(r, requests[0]) and r is not requests[0]]
    names = [r[0] for r in first]
    chunks = 2 if dip else 1  # 6 frames in chunks of 4
    assert names.count("sample.step") == 2 * chunks
    assert names.count("denoiser.forward") == 2 * chunks
    assert names.count("denoiser.layer") == 2 * 2 * chunks
    assert names.count("sample.chunk") == (chunks if dip else 0)
    assert names.count("sample.decode") == 1
    parts = ["denoiser.self_attn", "denoiser.cross_attn", "denoiser.tail"]
    assert all(names.count(p) == (4 * chunks if dip else 0) for p in parts)
    assert sorted(r[0] for r in ranges) == sorted(names * 2 + ["sample.request"] * 2)
    for r in first:
        parent = _parent(r, ranges)[0]
        if r[0] == "denoiser.forward":
            assert parent == "sample.step"
        if r[0] in parts:
            assert parent == "denoiser.layer"
        if r[0] == "sample.step":
            assert parent == ("sample.chunk" if dip else "sample.request")


def test_a_train_step_in_order():
    from mdm_tpu_torch.train import OptimConfig, TrainStepConfig, create_train_state, \
        make_train_step

    state = create_train_state(_mdm(), OptimConfig())
    batch = {"x": torch.randn(2, 6, 263), "mask": torch.ones(2, 6, dtype=torch.bool),
             "cond": Conditioning(text_embed=torch.zeros(2, 512))}
    step = make_train_step(Schedule.create("cosine", 100), TrainStepConfig())
    with _profile() as prof:
        step(state, batch, 0)
    ranges = _ranges(prof)
    top = [r for r in ranges if r[0] == "train.step"]
    assert len(top) == 1
    parts = [r for r in ranges if _parent(r, ranges) is top[0]]
    assert [r[0] for r in parts] == TRAIN_PARTS
    assert all(a[2] <= b[1] for a, b in zip(parts, parts[1:]))
    assert _parent([r for r in ranges if r[0] == "denoiser.forward"][0], ranges)[0] \
        == "train.forward"


def test_spans_sit_on_the_profilers_clock():
    """The operations a span runs lie inside its range in the profiler's
    events, and those run between spans lie outside every range: the
    benchmark puts device work down to spans by those times."""
    model = _mdm()
    x, t = torch.randn(1, 6, 263), torch.zeros(1, dtype=torch.long)
    cond = Conditioning(text_embed=torch.zeros(1, 512))
    with _profile() as prof:
        for _ in range(3):
            model(x, t, cond)
            torch.full((3,), 7.0).max()  # between the spans
    spans = _ranges(prof, lambda n: n == "denoiser.forward")
    linears = _ranges(prof, lambda n: n == "aten::linear")
    outside = _ranges(prof, lambda n: n == "aten::max")
    assert len(spans) == 3 and len(outside) == 3 and len(linears) >= 3 * 4
    assert all(any(_inside(op, s) for s in spans) for op in linears)
    assert not any(_inside(op, s) for op in outside for s in spans)
