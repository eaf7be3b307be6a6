"""mdm_tpu_torch's DiT denoiser (``MDMConfig(arch="dit")``) against the plain
float32 DiT of tests/plain_dit.py, at a small size on the CPU, where the
port runs the plain versions of its kernels (ops/adaln.py, the rate-0
attention block). The kernels themselves are compared with those plain
versions on the card by chip_smoke.py.

The size keeps DiT-XL's odd head dim: 2 blocks of width 144 in 2 heads of
72, FFN 576, 20 frames of which the last of some motions are padded.
"""
import os
import sys

import numpy as np
import pytest
import torch

import plain_dit
from mdm_tpu_torch.models.mdm import MDM, Conditioning, MDMConfig, cfg_denoiser
from mdm_tpu_torch.ops import adaln

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

CFG = dict(latent_dim=144, ff_size=576, num_layers=2, num_heads=2, njoints=263, nfeats=1,
           text_dim=32, mask_frames=True)
B, S = 3, 20
LENGTHS = (20, 13, 7)


def _config(dtype="float32", **kw):
    keys = ("latent_dim", "ff_size", "num_layers", "num_heads", "njoints", "nfeats", "text_dim",
            "mask_frames")
    return MDMConfig(arch="dit", compute_dtype=dtype, **{k: CFG[k] for k in keys}, **kw)


def _model(dtype="float32", seed=0):
    """Seeded random weights everywhere (DiT's own init zeroes the
    modulation and the output, which would hide them)."""
    m = MDM(_config(dtype))
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for p in m.parameters():
            fan = p.shape[-1] if p.dim() > 1 else 50.0
            p.copy_(torch.randn(p.shape, generator=g) / fan ** 0.5)
    return m.eval()


def _inputs(seed=1):
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(B, S, 263, generator=g)
    t = torch.tensor([0, 17, 49])
    text = torch.randn(B, CFG["text_dim"], generator=g)
    mask = torch.arange(S)[None, :] < torch.tensor(LENGTHS)[:, None]
    return x, t, text, mask


def _params(m):
    return {k: v.detach().float() for k, v in m.state_dict().items()}


@pytest.mark.parametrize("dtype, tol", [("float32", 2e-5), ("bfloat16", 0.02)])
def test_forward_matches_the_plain_dit(dtype, tol):
    """float32: the same function to rounding; bfloat16: the kernels'
    rounding points (q/k/v, p, ctx, the residual stream, h) cost a few
    bf16 ulps a value: 0.5% of the output's norm per motion here, four times
    under the bar."""
    m = _model(dtype)
    x, t, text, mask = _inputs()
    drop = torch.tensor([False, True, False])
    cond = Conditioning(text_embed=text, frames_mask=mask, cond_drop=drop)
    with torch.no_grad():
        got = m(x, t, cond)
        want = plain_dit.dit_forward(_params(m), CFG, x, t, text, mask, drop)
    assert got.dtype == torch.float32 and got.shape == (B, S, 263)
    rel = ((got - want).flatten(1).norm(dim=1) / want.flatten(1).norm(dim=1)).max()
    assert rel < tol, rel


def test_padded_frames_do_not_reach_the_valid_ones():
    m = _model()
    x, t, text, mask = _inputs()
    y = x.clone()
    y[~mask] = 100.0
    cond = Conditioning(text_embed=text, frames_mask=mask)
    with torch.no_grad():
        a, b = m(x, t, cond), m(y, t, cond)
    torch.testing.assert_close(a[mask], b[mask], rtol=1e-5, atol=1e-5)


def test_guided_sampling_matches_the_plain_dit():
    """Three guided DDPM steps through MotionGenerator, p_sample_loop and
    cfg_denoiser, with the noise injected, against the same chain on the
    plain DiT (benchmark/reference/diffusion.py's posterior)."""
    from benchmark.reference import diffusion as ref
    from mdm_tpu_torch.diffusion.schedule import Schedule
    from mdm_tpu_torch.sampling.pipeline import GenerationConfig, MotionGenerator

    m = _model()
    x, _, text, mask = _inputs()
    g = torch.Generator().manual_seed(5)
    noise = torch.randn(B, S, 263, generator=g)
    steps = torch.randn(3, B, S, 263, generator=g)
    gen = MotionGenerator(m, Schedule.create("cosine", 3), GenerationConfig(guidance_scale=2.5))
    got = gen.sample_features(Conditioning(text_embed=text, frames_mask=mask), B, S, noise=noise,
                              step_noise=steps)
    P, sched = _params(m), ref.Schedule(3, "cpu")

    def guided(xt, t):
        f = lambda drop: plain_dit.dit_forward(P, CFG, xt, t, text, mask,
                                               torch.full((B,), drop))
        return f(True) + 2.5 * (f(False) - f(True))

    want = noise
    with torch.no_grad():
        for k, i in enumerate(range(2, -1, -1)):
            x0 = guided(want, torch.full((B,), i))
            want = (sched.coef1[i] * x0 + sched.coef2[i] * want
                    + float(i != 0) * torch.exp(0.5 * sched.log_var[i]) * steps[k])
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)


def test_cfg_denoiser_is_the_guided_mix():
    m = _model()
    x, t, text, mask = _inputs()
    with torch.no_grad():
        got = cfg_denoiser(m, 2.5)(x, t, Conditioning(text_embed=text, frames_mask=mask))
        f = lambda drop: m(x, t, Conditioning(text_embed=text, frames_mask=mask,
                                              cond_drop=torch.full((B,), drop)))
        want = f(True) + 2.5 * (f(False) - f(True))
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("residual", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_adaln_plain_version_is_the_expression(residual, dtype):
    """The plain adaptive LayerNorm on column blocks of one modulation
    tensor: x' = x + g y, h = LN(x') (1 + scale) + shift (no affine, eps
    1e-6), the LayerNorm of the f32 sum, x' and h rounded to the dtype."""
    g = torch.Generator().manual_seed(3)
    D = 144
    x, y = (torch.randn(B, S, D, generator=g).to(dtype) for _ in range(2))
    mod = torch.randn(B, 6 * D, generator=g)
    gate, shift, scale = mod[:, 2 * D:3 * D], mod[:, 3 * D:4 * D], mod[:, 4 * D:5 * D]
    got_x, got_h = adaln.adaln_modulate(x, y if residual else None, gate, shift, scale)
    s = x.double() + (gate.double()[:, None] * y.double() if residual else 0.0)
    mu = s.mean(-1, keepdim=True)
    var = ((s - mu) ** 2).mean(-1, keepdim=True)
    want_h = (s - mu) / torch.sqrt(var + 1e-6) * (1 + scale.double()[:, None]) + shift.double()[:, None]
    tol = dict(rtol=1e-5, atol=1e-5) if dtype == torch.float32 else dict(rtol=2 ** -7, atol=2 ** -6)
    assert got_h.dtype == dtype
    torch.testing.assert_close(got_h.double(), want_h, **tol)
    if residual:
        assert got_x.dtype == dtype
        torch.testing.assert_close(got_x.double(), s, **tol)
    else:
        assert got_x is None


def test_the_tanh_gelu_form_is_the_x_wt_forms_alone():
    """gemm's gelu="tanh" selects the wgmma and f32 kernels' tanh-GELU
    instance (code 2), which exists for x . W^T only, as the exact one."""
    from mdm_tpu_torch.ops import _chain

    assert _chain.GELU_FORMS == {False: 0, True: 1, "tanh": 2}
    a, w = torch.zeros(16, 16, dtype=torch.bfloat16), torch.zeros(16, 16, dtype=torch.bfloat16)
    assert _chain.gemm_kernel(a, w, gelu="tanh") == "wgmma"
    assert _chain.gemm_kernel(a.float(), w.float(), gelu="tanh") == "tf32x3"
    with pytest.raises(ValueError, match="GELU on the x . W"):
        _chain.gemm_kernel(a, w, a_km=True, b_kn=True, gelu="tanh")


def test_adaln_zero_init_gives_identity_blocks_and_a_zero_output():
    m = MDM(_config()).init_weights(torch.Generator().manual_seed(0)).eval()
    x, t, text, mask = _inputs()
    cond = Conditioning(text_embed=text, frames_mask=mask)
    with torch.no_grad():
        assert torch.count_nonzero(m(x, t, cond)) == 0
        h = torch.randn(B, S, CFG["latent_dim"])
        zero = torch.zeros(B, CFG["latent_dim"])
        mod = torch.zeros(B, 6 * CFG["latent_dim"])
        for block in m.blocks:
            assert all(torch.count_nonzero(p) == 0 for p in block.adaLN_modulation.parameters())
            x2, h2 = block(h, h, mod, zero, zero)
            assert torch.equal(x2, h)  # gates 0: the residual stream passes unchanged
            torch.testing.assert_close(h2, torch.nn.functional.layer_norm(h, (144,), eps=1e-6))
    assert m.blocks[0].attn.qkv.weight.abs().max() <= (6 / (144 + 432)) ** 0.5


def test_the_benchmarks_reference_is_the_tests_plain_dit():
    """benchmark/reference/dit.py computes the same thing, bitwise, with its
    parameter list in the program's names."""
    from benchmark.reference import dit as bench_dit
    from benchmark.reference.precision import Precision

    m = _model()
    P = _params(m)
    cfg = dict(CFG, nfeats=1)
    assert [(n, s) for n, s, _ in bench_dit.dit_params(cfg)] == [
        (n, tuple(p.shape)) for n, p in m.state_dict().items()]
    x, t, text, mask = _inputs()
    drop = torch.tensor([True, False, False])
    with torch.no_grad():
        a = plain_dit.dit_forward(P, CFG, x, t, text, mask, drop)
        b = bench_dit.dit_forward(P, cfg, x, t, text, prec=Precision("f32"), frames_mask=mask,
                                  cond_drop=drop)
    assert torch.equal(a, b)


def test_neither_reference_loads_the_program():
    import subprocess

    code = ("import sys; sys.path.insert(0, 'tests'); import plain_dit, benchmark.reference.dit\n"
            "print(' '.join(m for m in sys.modules if m.split('.')[0] in "
            "('mdm_tpu_torch', 'mdm_tpu', 'jax')))")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip() == ""


def test_forward_only():
    m = _model()
    x, t, text, mask = _inputs()
    with pytest.raises(ValueError, match="forward only"):
        m(x, t, Conditioning(text_embed=text, frames_mask=mask))
    with torch.no_grad(), pytest.raises(ValueError, match="forward only"):
        m(x, t, Conditioning(text_embed=text), deterministic=False)
    with pytest.raises(ValueError, match="pooled text"):
        MDM(_config(text_tokens=True))


def test_arch_dit_parses_and_train_refuses(tmp_path):
    from mdm_tpu_torch.cli import train
    from mdm_tpu_torch.utils import factory, parser

    argv = ["--save_dir", str(tmp_path / "run"), "--arch", "dit", "--layers", "2",
            "--latent_dim", "144", "--ff_size", "576", "--num_heads", "2", "--device", "cpu"]
    args = parser.train_args(argv)
    assert args.arch == "dit"
    config = factory.get_model_config(args)
    assert (config.arch, config.num_heads, config.latent_dim // config.num_heads) == ("dit", 2, 72)
    with pytest.raises(SystemExit, match="generation only"):
        train.main(argv)
    assert not (tmp_path / "run").exists()


def test_cli_generate_runs_dit(tmp_path):
    from mdm_tpu_torch.cli import generate

    out = tmp_path / "out"
    generate.main(["--model_path", str(tmp_path / "none"), "--arch", "dit", "--layers", "2",
                   "--latent_dim", "144", "--ff_size", "576", "--num_heads", "2",
                   "--text_encoder_type", "hash", "--text_prompt", "a person walks",
                   "--num_samples", "2", "--num_repetitions", "1", "--diffusion_steps", "3",
                   "--motion_length", "1", "--device", "cpu", "--output_dir", str(out)])
    res = np.load(out / "results.npy", allow_pickle=True).item()
    assert res["motion"].shape == (2, 20, 22, 3) and np.isfinite(res["motion"]).all()
