#!/usr/bin/env python3
"""Smoke test of mdm_tpu_torch on one NVIDIA GPU.

Builds the hand-written CUDA kernels from mdm_tpu_torch/csrc, holds the
encoder-layer kernel chain against its plain PyTorch version at the shapes
the sampling path gives it, then drives that path through its entry points
at the flagship width (latent 512, 8 layers, 4 heads, ff 1024, bf16):
MotionGenerator.generate at B=32 x T=196 with 50 respaced cosine DDPM steps
and CFG 2.5, and the serving Predictor answering three prompts at batch 1.
Weights are random, drawn from a seed. It checks that every encoder layer
of every step went through the kernel chain.

Run from the repository root, with one CUDA device:  python3 chip_smoke.py
The last line of its output is {"ok": true, "device": {...}}; the line
before it lists each kernel with its launches, error and times. With no
CUDA device it exits nonzero and prints no result.
"""
import json
import os
import re
import subprocess
import sys
import time

import numpy as np

FLAGSHIP = dict(latent_dim=512, ff_size=1024, num_layers=8, num_heads=4)
BF16_TOL = dict(atol=2 ** -4, rtol=2 ** -6)  # one or two bf16 ulps: see test_torch_layer_inference.py
F32_TOL = dict(atol=1e-4, rtol=1e-4)  # f32 sums in another order; TF32 off on both sides
KERNEL_SOURCE = "mdm_tpu_torch/csrc/layer_inference.cu"
REPLACES = "mdm_tpu/ops/layer_inference.py:107"


def _layer_inputs(torch, B, S, D, F, dtype, mask, seed=0):
    g = torch.Generator().manual_seed(seed)
    r = lambda *s, sc=1.0: torch.randn(*s, generator=g) * sc
    x = r(B, S, D)
    ws = [r(3 * D, D, sc=D ** -0.5), r(3 * D, sc=0.1), r(D, D, sc=D ** -0.5), r(D, sc=0.1),
          1 + r(D, sc=0.1), r(D, sc=0.1), r(F, D, sc=D ** -0.5), r(F, sc=0.1),
          r(D, F, sc=F ** -0.5), r(D, sc=0.1), 1 + r(D, sc=0.1), r(D, sc=0.1)]
    kpm = None
    if mask == "bool":
        kpm = torch.zeros(B, S, dtype=torch.bool)
        kpm[0, S // 2:] = True
        kpm[-1, S - 7:] = True
    elif mask == "float":
        kpm = r(B, S)
    to = lambda t: t.cuda().to(dtype)
    return to(x), [to(w) for w in ws], None if kpm is None else kpm.cuda()


def _time_ms(torch, fn, iters=20):
    for _ in range(3):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def compare_layer(torch, li, B, S, D, F, H, dtype, mask):
    """Kernel chain vs plain version on the card: max abs error and the
    times of both, measured in turns (plain, kernel, kernel, plain)."""
    x, ws, kpm = _layer_inputs(torch, B, S, D, F, dtype, mask)
    out = li.fused_layer_inference(x, *ws, H, key_padding_mask=kpm)
    torch.cuda.synchronize()
    ref = li.layer_inference_reference(x, *ws, H, key_padding_mask=kpm)
    if not torch.isfinite(out).all():
        raise AssertionError(f"kernel output not finite at B={B} S={S} D={D} {dtype}")
    err = (out.float() - ref.float()).abs().max().item()
    tol = BF16_TOL if dtype == torch.bfloat16 else F32_TOL
    if not torch.allclose(out.float(), ref.float(), **tol):
        raise AssertionError(f"kernel disagrees with plain version: max abs err {err} "
                             f"(tolerance {tol}) at B={B} S={S} D={D} {dtype} mask={mask}")
    kernel = lambda: li.fused_layer_inference(x, *ws, H, key_padding_mask=kpm)
    plain = lambda: li.layer_inference_reference(x, *ws, H, key_padding_mask=kpm)
    p1, k1, k2, p2 = (_time_ms(torch, f) for f in (plain, kernel, kernel, plain))
    row = dict(B=B, S=S, D=D, F=F, H=H, dtype=str(dtype).split(".")[-1], mask=mask,
               max_abs_err=err, tol=tol, ms=(k1 + k2) / 2, plain_ms=(p1 + p2) / 2)
    print("layer", json.dumps(row))
    return row


def main():
    import torch

    if not torch.cuda.is_available():
        sys.exit("chip_smoke: no CUDA device is visible; nothing was run")
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from mdm_tpu_torch.diffusion import Schedule
    from mdm_tpu_torch.models import MDM, Conditioning, MDMConfig
    from mdm_tpu_torch.ops import _build
    from mdm_tpu_torch.ops import layer_inference as li
    from mdm_tpu_torch.sampling import GenerationConfig, HashTextEmbedder, MotionGenerator
    from mdm_tpu_torch.serving import Predictor, PredictorConfig

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")

    # Phase 0: the card and the software.
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(smi.splitlines()[0])
    print(f"torch {torch.__version__} cuda {torch.version.cuda} python {sys.version.split()[0]}")

    # Phase 1: build the kernels from the sources in this checkout.
    t0 = time.perf_counter()
    so = _build.build()
    _build.load_library()
    print(f"build: {time.perf_counter() - t0:.1f} s -> {os.path.relpath(so)}")
    log = so.with_suffix(".log").read_text()
    regs = [int(n) for n in re.findall(r"Used (\d+) registers", log)]
    spills = [ln for ln in log.splitlines()
              if "spill" in ln and "0 bytes spill stores, 0 bytes spill loads" not in ln]
    print(f"ptxas: {len(regs)} kernels, at most {max(regs)} registers, {len(spills)} spilling")

    # Phase 2: kernel chain vs plain version at the main path's layer shapes
    # (CFG batch 64 = 2 x 32, S = 1 + 196 frames; serving batch 2 = 2 x 1)
    # and at a small f32 shape with a float additive row.
    D, F, H = FLAGSHIP["latent_dim"], FLAGSHIP["ff_size"], FLAGSHIP["num_heads"]
    flagship = [compare_layer(torch, li, 64, 197, D, F, H, torch.bfloat16, m) for m in (None, "bool")]
    compare_layer(torch, li, 2, 197, D, F, H, torch.bfloat16, None)
    compare_layer(torch, li, 64, 197, D, F, H, torch.float32, None)
    compare_layer(torch, li, 3, 37, 128, 256, 4, torch.float32, "float")

    # Phase 2b: the whole slice on the card (kernels) against the CPU (plain
    # versions) at a small f32 width, with identical weights and noise.
    small = MDMConfig(latent_dim=128, ff_size=256, num_layers=2, num_heads=4)
    model_cpu = MDM(small).init_weights(torch.Generator().manual_seed(1))
    model_gpu = MDM(small).init_weights(torch.Generator().manual_seed(1)).to(dev)
    rng = np.random.default_rng(0)
    noise = torch.from_numpy(rng.normal(size=(2, 32, 263)).astype(np.float32))
    step_noise = torch.from_numpy(rng.normal(size=(5, 2, 32, 263)).astype(np.float32))
    cond = Conditioning(text_embed=torch.from_numpy(HashTextEmbedder()(
        ["a person walks forward", "a person jumps"])["text_embed"]))
    sched5 = Schedule.create("cosine", 1000, "5")
    outs = [MotionGenerator(m, sched5).generate(cond, 2, 32, noise=noise, step_noise=step_noise)
            for m in (model_cpu, model_gpu)]
    for key, tol in (("features", 1e-4), ("joints", 1e-3)):
        err = (outs[0][key] - outs[1][key].cpu()).abs().max().item()
        print(f"slice f32 card vs cpu: {key} max abs err {err:.3g} (tolerance {tol})")
        if not err <= tol:
            raise AssertionError(f"slice on the card disagrees with the CPU: {key} {err}")

    # Phase 3: the main path, MotionGenerator.generate at bench.py's shape.
    B, T, steps = 32, 196, 50
    cfg = MDMConfig(njoints=263, nfeats=1, compute_dtype="bfloat16", **FLAGSHIP)
    model = MDM(cfg).init_weights(torch.Generator().manual_seed(0)).to(dev)
    gen = MotionGenerator(model, Schedule.create("cosine", 1000, str(steps)),
                          GenerationConfig(guidance_scale=2.5))
    with open(os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           "assets", "example_text_prompts.txt")) as f:
        prompts = [p.strip() for p in f if p.strip()]
    prompts = (prompts * B)[:B]
    cond = Conditioning(frames_mask=torch.ones(B, T, dtype=torch.bool, device=dev),
                        text_embed=torch.from_numpy(HashTextEmbedder()(prompts)["text_embed"]).to(dev))
    per_forward = cfg.num_layers

    li.LAUNCHES = 0  # counts from here on are the main path's
    out1 = gen.generate(cond, B, T, torch.Generator(dev).manual_seed(0))
    torch.cuda.synchronize()
    if li.LAUNCHES != per_forward * steps:
        raise AssertionError(f"generate launched the layer kernels {li.LAUNCHES} times, "
                             f"expected {per_forward} layers x {steps} steps")
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    out2 = gen.generate(cond, B, T, torch.Generator(dev).manual_seed(0))
    end.record()
    torch.cuda.synchronize()
    gen_ms = start.elapsed_time(end)
    joints = out2["joints"]
    if tuple(joints.shape) != (B, T, 22, 3) or not torch.isfinite(joints).all():
        raise AssertionError(f"bad joints: shape {tuple(joints.shape)}")
    if not (torch.equal(out1["features"], out2["features"])
            and torch.equal(out1["joints"], joints)):
        raise AssertionError("same generator seed gave different samples")
    print(f"generate B={B} T={T} steps={steps} cfg=2.5 bf16: {gen_ms:.1f} ms/batch, "
          f"{gen_ms / 1000 / B:.6f} s/sample (CUDA events, after one warm call)")

    # Phase 4: the serving entry point, three requests at batch 1.
    pred = Predictor(PredictorConfig(text_encoder_type="hash", batch_size=1))
    t0 = time.perf_counter()
    pred.setup()
    print(f"predictor setup (incl. one warm request): {time.perf_counter() - t0:.3f} s")
    for prompt in ("a person walks forward", "a person jumps twice", "a person waves"):
        t0 = time.perf_counter()
        res = pred.predict(prompt)
        dt = time.perf_counter() - t0
        j = np.asarray(res["joints"][0])
        if j.shape != (1, 120, 22, 3) or not np.isfinite(j).all():
            raise AssertionError(f"bad predictor output {j.shape} for {prompt!r}")
        print(f"predict {prompt!r}: {dt * 1000:.1f} ms (host clock, result on the host)")
    launches = li.LAUNCHES
    expected = per_forward * steps * (2 + 1 + 3)  # 2 generate + warm + 3 requests
    if launches != expected:
        raise AssertionError(f"main path launched the layer kernels {launches} times, "
                             f"expected {expected}")

    kernels = [dict(name="fused_layer_inference", route="cuda", source=KERNEL_SOURCE,
                    replaces=REPLACES, launches=launches,
                    max_abs_err=max(r["max_abs_err"] for r in flagship),
                    ms=flagship[0]["ms"], plain_ms=flagship[0]["plain_ms"])]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
