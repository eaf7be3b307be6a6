#!/usr/bin/env python3
"""Smoke test of mdm_tpu_torch on one NVIDIA GPU.

Builds the hand-written CUDA kernels from mdm_tpu_torch/csrc and drives the
port's two paths at the flagship width (latent 512, 8 layers, 4 heads, ff
1024, bf16) with random weights drawn from a seed:

- sampling (phases 2-4): the wgmma product kernel (csrc/gemm_sm90.cu,
  every bf16 x . W^T product of the chains) against the plain product at
  the edges of its tiling, and the encoder-layer kernel chain against its
  plain PyTorch version; MotionGenerator.generate at B=32 x T=196 with 50
  respaced cosine DDPM steps and CFG 2.5, every product of it on the wgmma
  kernel; and the serving Predictor answering three prompts at batch 1;
- training (phases 5-8): the train attention block and the encoder tail,
  forward and backward, against their plain versions at the flagship
  training layer shape; the in-kernel Philox dropout against the injected
  bits of the dump kernel, and the dump itself against the Philox stream
  at the edges of its plan (row widths, rows, heads, batch, sites, seeds,
  the tail's ragged widths, one output past 2^31 words), each case written
  over all zero and all one bits; three train steps on the card against the
  CPU; 30 flagship train steps (B=128, T=196, dropout 0.1) through
  make_train_step, timed; and a TrainLoop resume that must be bit exact;
- head dims off 128 (phases 2 and 5): the layer chain, and the train
  block and tail forward and backward, at 4 heads of 96 and of 256, 32
  heads of 4 (d_model 128: rows of 2-byte copies) and 2 heads of 512
  (d_model 1024: the wide kernels);
- the tail's edges (phase 5): d_model on both sides of the 1024 a warp
  holds in registers and off the 32-bit mask words, ff sizes 136 to 4096,
  bf16 and f32, every dropout mode at rates 0.1 and 0.5; its packed keep
  masks against keep_mask_bits of the bits (phases 5 and 6); and the f32
  attention path at head dims 6144 and 8192 and S = 13000 (phase 9);
- the opt-in attention routes (phases 9-11): kernels #7/#8, #10, #11 and
  #12 against their plain versions, #7/#8's in-kernel Philox against
  dumped bits; the attention forward and backward cores at the edges of
  their tiling (S = 1, 64, 65, 256, 257; every instance's head dim and
  padded ones, input or output dtype, bias form and dropout mode) with
  their occupancy; #10 and #12 called as direct entry points; the sampling
  shootout's ``pallas`` variant (v2 attention + fused tail) through
  MotionGenerator.generate at B=32 x 50 steps, and its ``block``/``tail``
  variants; the training shootout's ``drop`` variant (dropout attention
  kernel + the plain tail, its masks from the tail dump), 30 flagship
  steps, timed, and one f32 step of it on the card against the CPU; and 3
  steps of its ``xla`` variant, whose attention masks come from the
  attention dump;
- DiP (phase 13): the trans_dec decoder layer's kernel route (the rate-0
  attention block #2 and the rate-0 fused tail #4) against its plain
  route at S = 60 and 61, CFG batch 64 and 2, bf16 and f32, and the two
  rate-0 entries alone against their plain versions, timed;
  MotionGenerator.generate on the DiP config (DistilBERT-shaped token
  memory, 20-frame prefix, 40-frame chunks, 10 steps, CFG 7.5, 196
  frames) at B=1 and 32, every decoder layer call on both rate-0 entries;
  and one generate each with the ddim, plms and dpmpp_2m samplers and with
  cached CFG on the flagship trans_enc at B=32, every layer call on the
  whole-layer kernel. Phase 12 profiles the DiP runs for their busy share;
- training every denoiser (phase 14): DiP training at B=64 (bf16, dropout
  0.1, 30 steps, the loss falls; per step and decoder layer the train
  block #2/#3 and the tail #4/#5 once each, the cross-attention's
  rectangular [64, 4, 60, 64] dump #9 once, the attn-out sequence dump
  once), timed, and one f32 DiP step card against CPU under AUTO and
  under the xla pin; the flagship trans_enc with and without remat
  (bitwise equal after a step at B=128; ms/step and peak memory at B=128
  and 512); HumanAct12's action-to-motion shape on trans_enc (25 steps,
  timed) and on the GRU (f32, 3 timed steps), an f32 step of each card
  against CPU and a 50-step CFG sample at B=32; one f32 goal-conditioned
  DiP step card against CPU;
- the command-line path (phase 15): on a synthetic HumanML3D tree (512
  clips of 40-196 frames, from a seed), mdm_tpu_torch.cli.train at the
  flagship width (B=128, bf16, 50 diffusion steps, AdamW + EMA, 30 steps,
  checkpoints at 15 and 30; the loss falls; #2-#5 240 launches each, the
  sequence dump 30), its ms/step by CUDA events beside phase 8's bare
  step and the loader's own ms/batch; a second cli.train resuming from
  step 15 whose step-30 checkpoint equals the first run's bitwise;
  cli.generate at B=32 (50 steps, CFG 2.5, 196 frames: #1's chain 400
  launches, results.npy with mdm_tpu's keys and shapes), its s/sample
  beside phase 3's; and cli.edit (in-between, B=32, 400 launches);
- the t2m evaluation protocol (phase 16), on phase 15's tree with a GloVe
  vocabulary of its captions: cli.train_evaluators decomp (100 steps) and
  match (150 steps) at the protocol's widths (movement 512, text hidden
  512, motion hidden 1024, co-embedding 512), ms/step, and the trained
  evaluator's embeddings of one batch on the card against the CPU;
  cli.eval_humanml (debug, 2 replications, B=32) on phase 15's flagship
  checkpoint: #1's chain 8 x 50 x batches x 2 launches, the ground truth's
  metrics against a CPU run of the same pass, s per replication split into
  generation and evaluator time (phase 12 profiles one replication for its
  busy share); then a 10-step DiP cli.train and its --autoregressive eval
  (one replication) at dip_probe's geometry (context 20, pred 40, 10 steps, CFG 7.5), the
  rate-0 block (#2) and tail (#4) 8 per denoise step of every chunk;
- the action-to-motion path (phase 17): a synthetic SMPL model at the
  published sizes (6890 vertices, 24 joints, 10 betas, 207 pose-blend
  rows, 9 extra regressors, from a seed) through SMPLModel.load, rot2xyz
  of [64, 60, 25, 6] rot6d for every joint set on the card against the
  CPU, the smpl set's ms and its peak memory against the vertices'; 25
  steps of the HumanAct12 recipe at the flagship width (B=64, T=60, bf16,
  rate 0.1, no condition dropout, the rcxyz, velocity and foot-contact
  losses through SMPL; launches exact, the loss falls) beside phase 14c's
  bare step, and one f32 step of it on the card against the CPU; the GRU
  (72 -> 128 x 2 -> 12) and the UESTC (6 -> 40) and modi-15 (3 -> 12)
  STGCNs on the card against the CPU; on a synthetic HumanAct12 tree of
  192 clips, cli.train_evaluators --stage a2m_classifier and
  unconstrained_stgcn (ms/step), cli.train with the recipe and
  --eval_during_training, cli.eval_a2m (debug, 2 seeds, self-trained
  classifier: #1 exactly 8 x 50 x 2, s/seed and its generation / SMPL /
  classifier split; phase 12 profiles a seed) and cli.eval_unconstrained;
- the published-weights path (phase 18): the CLIP (512 wide, 12 layers, 8
  heads, context 77, vocabulary 49408) and DistilBERT (768, 6 layers, 12
  heads, FFN 3072, vocabulary 30522) towers with random weights, written
  through cli.convert_text_encoders from OpenAI- and HF-layout state dicts,
  32 prompts embedded on the card against the CPU, #2's rate-0 entry
  exactly 6 per BERT batch and 0 per CLIP batch, and alone at [32, 64,
  768], 12 heads, f32, a ragged padding row, against its plain version and
  nn.MultiheadAttention; a synthetic reference checkpoint ({'model',
  'model_avg'}, clip_model.* and pe buffers) at the flagship shape through
  cli.convert_checkpoint and cli.generate --text_encoder_type clip (#1
  exactly 400), and a DiP one through cli.generate --autoregressive on
  bert (#2 400 + 6, #4 400); Predictor's json, hik and animation formats;
  cli.render_mesh (150 iterations) on the generated results.npy with SMPL
  at its published sizes (s per clip, the loss falls); and the classifier
  stages a2m_classifier and unconstrained_stgcn rerun at phase 17's seed,
  their weights bitwise equal to phase 17's.

Each path checks that every layer call went through its kernels, and the
sampling and training paths that every product, forward and backward,
went through the wgmma kernel. Each kernel's line carries its
bound: the larger of its bytes (each input read
once, each output written once) over 3.35 TB/s and its FLOPs over 989
TFLOP/s, the H100 SXM's HBM rate and dense bf16 peak; for the dumps, the
larger of the bytes and the draws (the Philox instructions a word needs at
the card's issue and integer rates and its highest SM clock). The training
kernels are timed drawing their dropout bits in-kernel, as every route
runs them; their comparisons with the plain versions inject the bits.

Run from the repository root, with one CUDA device:  python3 chip_smoke.py
The last line of its output is {"ok": true, "device": {...}}; the line
before it lists each kernel with its launches, error and times, and an
earlier "gemm products" line each main-path product's time, bound, share
of peak and torch.matmul's time. With no
CUDA device it exits nonzero and prints no result.
"""
import contextlib
import itertools
import json
import os
import re
import subprocess
import sys
import tempfile
import time

import numpy as np

FLAGSHIP = dict(latent_dim=512, ff_size=1024, num_layers=8, num_heads=4)
BF16_TOL = dict(atol=2 ** -4, rtol=2 ** -6)  # one or two bf16 ulps: see test_torch_layer_inference.py
F32_TOL = dict(atol=1e-4, rtol=1e-4)  # f32 sums in another order; TF32 off on both sides
KERNEL_SOURCE = "mdm_tpu_torch/csrc/layer_inference.cu"
REPLACES = "mdm_tpu/ops/layer_inference.py:107"
# Training chains, kernel vs plain: max |kernel - plain| <= REL * max |plain|
# per output. bf16: both round at the same points, but a value near a bf16
# rounding boundary may round either way after another summation order,
# and the flip carries into later products (a few ulps at 2^-8 each).
# f32: summation order alone.
TRAIN_REL = {"bfloat16": 2 ** -5, "float32": 1e-5}
ZERO_IN_EXACT = ("dbk",)  # gradients that are zero in exact arithmetic (see _split_qkv)
TRAIN_SHAPE = dict(B=128, S=197, D=512, H=4, F=1024)  # S = 1 condition token + 196 frames
RATE = 0.1
ATTENTION_SOURCE = "mdm_tpu_torch/csrc/attention.cu"
TRAIN_KERNELS = {  # name -> (source, TPU kernel it replaces)
    "fused_train_attention_block.forward": (ATTENTION_SOURCE,
                                            "mdm_tpu/ops/attention_train_block.py:286"),
    "fused_train_attention_block.backward": (ATTENTION_SOURCE,
                                             "mdm_tpu/ops/attention_train_block.py:334"),
    "fused_encoder_tail.forward": ("mdm_tpu_torch/csrc/encoder_tail.cu",
                                   "mdm_tpu/ops/encoder_tail.py:309"),
    "fused_encoder_tail.backward": ("mdm_tpu_torch/csrc/encoder_tail.cu",
                                    "mdm_tpu/ops/encoder_tail.py:358"),
    "dropout_bits": ("mdm_tpu_torch/csrc/dropout_bits.cu", "mdm_tpu/ops/attention_dropout.py:237"),
    "tail_dropout_bits": ("mdm_tpu_torch/csrc/dropout_bits.cu", "mdm_tpu/ops/encoder_tail.py:463"),
}
ATTN_SHAPE = dict(B=64, S=197, D=512, H=4)  # sampling attention: CFG batch 2 x 32, 1 + 196 tokens
# Both sides of the attention forward's 64-row tile and of its resident row
# of 256 logits (csrc/attention.cu FW_RES): S = 1, 64 | 65, 256 | 257.
EDGE_S = (1, 64, 65, 256, 257)
# Every instance of the attention core (csrc/attention.cuh padded_head_dim:
# 32, 64, 96, 128, 192, 256), head dims padded into one (16, 48, 160), ones
# that are no multiple of 8 (4, 12: 2-byte copies) and ones past 256 (264,
# 512, 1024: the wide kernels of csrc/attention_wide.cu).
EDGE_DH = (4, 12, 16, 32, 48, 64, 96, 128, 160, 192, 256, 264, 512, 1024)
BWD_REL = {"bfloat16": 2 ** -5, "float32": 1e-4}  # the backward edges, of max |plain|
# The tail's edges (csrc/encoder_tail.cu): d_model below, at and past the
# 1024 a warp holds in registers (8, 520, 1024 | 1032, 1536: the block-wide
# rows) and widths that are no multiple of the 32-bit mask words (8, 520,
# 1032, 136, 1000); ff sizes 136, 1000 and 4096; (mode, rate): no dropout,
# injected bits and in-kernel Philox at 0.1 and 0.5.
TAIL_EDGE_D = (8, 520, 1024, 1032, 1536)
TAIL_EDGE_F = (136, 1000, 4096)
TAIL_EDGE_MODES = ((0, 0.0), (1, 0.1), (1, 0.5), (2, 0.1), (2, 0.5))
TAIL_GRADS = ["dx", "dattn", "dg1", "dbl1", "dW1", "db1", "dW2", "db2", "dg2", "dbl2"]
# The f32 attention path past the 48 KB of shared memory it once held a row
# in: (S, Dh) at B = H = 1.
F32_LONG_ROWS = ((197, 6144), (197, 8192), (13000, 8))
TAIL_KERNELS = ("tail_ln_fwd", "tail_gelu_dropout", "tail_ln_bwd", "tail_gelu_bwd")
# The dumps' edges (csrc/dropout_bits.cu: four 16-byte groups of a row a
# thread): row widths of one word, below, at and past one group, the
# sampling shape's 197 and ragged ones (1, 3, 4, 197, 1000, 1025); odd and
# even row counts; 1, 3 and 32 heads; batch 1 and 5; the head as the site
# (-1) and a fixed one; seeds 0, -1 and 2^31 - 1. The tail's three sites
# at ragged d_model and ff. One output past 2^31 words (8.9 GB), checked
# on its first and last (b, h) slices.
DUMP_EDGE_C = (1, 3, 4, 197, 1000, 1025)
DUMP_EDGE_R = (1, 8, 37)
DUMP_EDGE_H = (1, 3, 32)
DUMP_EDGE_B = (1, 5)
DUMP_EDGE_SITES = (-1, 2)
DUMP_EDGE_SEEDS = (0, -1, 2 ** 31 - 1)
TAIL_DUMP_D = (8, 136)
TAIL_DUMP_F = (12, 4096)
BIG_DUMP = dict(B=64, H=32, S=1040)  # 2,214,707,200 words
# DiP (phase 13): mdm_tpu_torch/scripts/dip_probe.py's configuration, the
# trans_dec denoiser at the flagship width on DistilBERT-shaped token memory.
DIP_SOURCES = {  # the rate-0 entries on the decoder's path -> (source, TPU kernel it replaces)
    "fused_block_attention_inference": (ATTENTION_SOURCE,
                                        "mdm_tpu/ops/attention_train_block.py:286"),
    "fused_encoder_tail_inference": ("mdm_tpu_torch/csrc/encoder_tail.cu",
                                     "mdm_tpu/ops/encoder_tail.py:309"),
}
HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3 bandwidth
BF16_FLOPS_PER_S = 989e12  # dense bf16 tensor-core peak
F32_FLOPS_PER_S = 67e12  # float32 outside the tensor cores (csrc/gemm.cu's FMA products)
# The dumps' draws, counted from Philox4x32-10 itself: a word is word 0 at
# counter (column, row, site, b), ten rounds of two 32x32->64 products and
# two three-way xors. Along a row only the column varies, so round 1's
# product of the site and its c0 xor, and round 2's product of round 1's
# c0, are the row's, made once; word 0 needs neither round 10's product of
# c0 and its c2 xor nor round 9's c0 xor. A word needs 17 products (one
# IMAD.WIDE.U32 each), 17 xors (one LOP3.LUT each) and a quarter of a
# 16-byte store.
PHILOX_PRODUCTS, PHILOX_XORS, STORES = 17, 17, 0.25  # a word
SMS = 132  # H100 SXM
# Per SM and clock: four schedulers issue one warp instruction each (128
# lanes); 64 lanes of 32-bit integer multiply-add and 64 of 32-bit bitwise
# operations (CUDA C++ Programming Guide, arithmetic instruction
# throughput, compute capability 9.0).
ISSUE_LANES, IMAD_LANES, LOGIC_LANES = 128, 64, 64


def bound(flops, nbytes, peak=BF16_FLOPS_PER_S):
    """(least ms, what bounds it): bytes over the HBM rate or FLOPs over the
    peak (bf16's unless given), whichever is larger."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / peak
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


def draw_bound_ms(words, sm_clock_hz):
    """The least ms the Philox draws of `words` dump words take at the
    card's highest SM clock: the largest of their instructions over the
    issue lanes, the products over the multiply lanes and the xors over
    the bitwise lanes."""
    clocks = max((PHILOX_PRODUCTS + PHILOX_XORS + STORES) / ISSUE_LANES,
                 PHILOX_PRODUCTS / IMAD_LANES, PHILOX_XORS / LOGIC_LANES)
    return words * clocks / (SMS * sm_clock_hz) * 1e3


def nbytes(*tensors):
    return sum(t.numel() * t.element_size() for t in tensors if t is not None)


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
    times of both, measured in turns (plain, kernel, kernel, plain); and the
    chain's time on the card alone (device_ms: CUDA graph replay), which the
    back-to-back time exceeds where the host issues slower than it runs."""
    from mdm_tpu_torch.scripts.gemm_probe import device_ms

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
               max_abs_err=err, tol=tol, ms=(k1 + k2) / 2, plain_ms=(p1 + p2) / 2,
               device_ms=device_ms(kernel))
    print("layer", json.dumps(row))
    return row


def _randn(torch, g, *shape, sc=1.0):
    return torch.randn(*shape, generator=g) * sc


def _rel_check(torch, name, got, ref, rel, scale_ref=None):
    """max |got - ref| and its ratio to max |scale_ref| (default ref);
    raises past rel."""
    err = (got.float() - ref.float()).abs().max().item()
    scale = (ref if scale_ref is None else scale_ref).float().abs().max().item()
    if not torch.isfinite(got).all() or err > rel * scale:
        raise AssertionError(f"{name}: kernel disagrees with plain version: max abs err {err} "
                             f"vs {rel} x max |plain| {scale}")
    return err, err / max(scale, 1e-30)


def _block_operands(torch, B, S, D, H, dtype, mask, seed=0):
    g = torch.Generator().manual_seed(seed)
    r = lambda *s, sc=1.0: _randn(torch, g, *s, sc=sc)
    ops = [r(B, S, D), r(3 * D, D, sc=D ** -0.5), r(3 * D, sc=0.1), r(D, D, sc=D ** -0.5),
           r(D, sc=0.1)]
    dout = r(B, S, D)
    bits = torch.randint(0, 2 ** 32, (B, H, S, S), generator=g, dtype=torch.int64)
    kpm = None
    if isinstance(mask, torch.Tensor):  # a path's own key-padding row [B, S]
        kpm = mask.cpu()
    elif mask == "bool":  # ragged lengths on some rows
        kpm = torch.zeros(B, S, dtype=torch.bool)
        for b in range(0, B, 3):
            kpm[b, S - 1 - (7 * b) % (S // 2):] = True
    elif mask == "float":
        kpm = r(B, S)
    to = lambda t: t.cuda().to(dtype)
    return ([to(t) for t in ops], to(dout), bits.to(torch.uint32).cuda(),
            None if kpm is None else kpm.cuda())


def _tail_operands(torch, B, S, D, F, dtype, seed=0):
    g = torch.Generator().manual_seed(seed)
    r = lambda *s, sc=1.0: _randn(torch, g, *s, sc=sc)
    ops = [r(B, S, D), r(B, S, D), 1 + r(D, sc=0.1), r(D, sc=0.1), r(F, D, sc=D ** -0.5),
           r(F, sc=0.1), r(D, F, sc=F ** -0.5), r(D, sc=0.1), 1 + r(D, sc=0.1), r(D, sc=0.1)]
    dz = r(B, S, D)
    bits = [torch.randint(0, 2 ** 32, (B, S, n), generator=g, dtype=torch.int64)
            .to(torch.uint32).cuda() for n in (D, F, D)]
    to = lambda t: t.cuda().to(dtype)
    return [to(t) for t in ops], to(dz), bits


def _fwd_bwd(torch, fn, ops, dout):
    """Kernel forward and the kernel backward's gradients of every operand."""
    leaves = [t.clone().requires_grad_() for t in ops]
    out = fn(*leaves)
    grads = torch.autograd.grad(out, leaves, dout)
    return out.detach(), grads


def _split_qkv(grads):
    """(dx, dWqkv, dbqkv, dWo, dbo) -> the TPU kernel's nine gradients, each
    beside the tensor whose largest value sets its scale: its own, except
    dbk's. dbk is zero in exact arithmetic (adding one vector to every key
    adds a per-row constant to the logits, which the softmax ignores), so
    both sides of it hold only the rounding noise of the dk column sums:
    it is held against zero, on the scale of the packed dbqkv (see
    compare_train_chain)."""
    dx, dwqkv, dbqkv, dwo, dbo = grads
    dbq, dbk, dbv = dbqkv.chunk(3)
    return ([(dx, dx)] + [(g, g) for g in dwqkv.chunk(3)]
            + [(dbq, dbq), (dbk, dbqkv), (dbv, dbv), (dwo, dwo), (dbo, dbo)])


def _own_scale(grads):
    return [(g, g) for g in grads]


def compare_train_chain(torch, name, fn, plain_fwd, plain_bwd, ops, dout, dtype, names,
                        timed=True, split=_own_scale, drawn=None):
    """A training chain (forward and backward) against its plain versions on
    the same inputs; times both in turns (plain, kernel, kernel, plain).
    fn takes injected bits, as the plain versions do. drawn, when given, is
    the chain drawing its bits in-kernel, as every model route runs it: it
    is the kernel that is timed, the plain versions being given the bits."""
    out, grads = _fwd_bwd(torch, fn, ops, dout)
    torch.cuda.synchronize()
    rel = TRAIN_REL[str(dtype).split(".")[-1]]
    errs = {"out": _rel_check(torch, f"{name} out", out, plain_fwd(), rel)}
    grads, pgrads = split(grads), split(plain_bwd())
    if len(grads) != len(names):
        raise AssertionError(f"{name}: {len(grads)} gradients, expected {len(names)}")
    for n, (g, _), (p, scale) in zip(names, grads, pgrads):
        if n in ZERO_IN_EXACT:  # both sides against zero, on the scale of their tensor
            errs[n] = max(_rel_check(torch, f"{name} {n} ({side})", t, torch.zeros_like(t), rel,
                                     scale) for side, t in (("kernel", g), ("plain", p)))
        else:
            errs[n] = _rel_check(torch, f"{name} {n}", g, p.to(g.dtype), rel, scale)
    row = dict(chain=name, dtype=str(dtype).split(".")[-1], shape=list(ops[0].shape),
               max_abs_err_fwd=errs["out"][0],
               max_abs_err_bwd=max(e[0] for k, e in errs.items() if k != "out"),
               max_rel_err=max(e[1] for e in errs.values()), rel_tol=rel,
               rel_err={k: e[1] for k, e in errs.items()})
    if timed:
        from mdm_tpu_torch.scripts.gemm_probe import device_ms

        kernel = fn if drawn is None else drawn
        leaves = [t.clone().requires_grad_() for t in ops]
        graph_out = kernel(*leaves)
        kf = lambda: kernel(*ops)
        kb = lambda: torch.autograd.grad(graph_out, leaves, dout, retain_graph=True)
        with torch.no_grad():
            p1, k1, k2, p2 = (_time_ms(torch, f) for f in (plain_fwd, kf, kf, plain_fwd))
            fwd_device = device_ms(kf)
        q1, j1, j2, q2 = (_time_ms(torch, f) for f in (plain_bwd, kb, kb, plain_bwd))
        row.update(fwd_ms=(k1 + k2) / 2, fwd_device_ms=fwd_device, fwd_plain_ms=(p1 + p2) / 2,
                   bwd_ms=(j1 + j2) / 2, bwd_plain_ms=(q1 + q2) / 2)
    print("train chain", json.dumps(row))
    return row


def phase_train_kernels(torch, TB, ET, shape, dtype, mask, timed=True):
    """Phase 5: block and tail, forward and all gradients, kernel vs plain;
    when timed, also nn.MultiheadAttention's training forward on the
    block's inputs (#2's library yardstick). mask: None, "bool" (ragged
    rows), "float" (an additive row) or a path's own [B, S] key-padding row."""
    B, S, D, H, F = (shape[k] for k in ("B", "S", "D", "H", "F"))
    (x, wqkv, bqkv, wo, bo), dout, bits, kpm = _block_operands(torch, B, S, D, H, dtype, mask)
    block = compare_train_chain(
        torch, "attention block",
        lambda *o: TB.fused_train_attention_block(*o, H, RATE, 0, kpm, bits),
        lambda: TB.train_attention_block_reference(x, wqkv, bqkv, wo, bo, H, RATE, bits, kpm),
        lambda: TB.train_attention_block_bwd_reference(x, wqkv, bqkv, wo, H, dout, RATE, bits,
                                                       kpm),
        [x, wqkv, bqkv, wo, bo], dout, dtype,
        ["dx", "dWq", "dWk", "dWv", "dbq", "dbk", "dbv", "dWo", "dbo"], timed, _split_qkv,
        lambda *o: TB.fused_train_attention_block(*o, H, RATE, 0, kpm))
    if timed:
        mha = _torch_mha(torch, wqkv, bqkv, wo, bo, H, RATE).train()
        block["library_fwd_ms"] = _no_grad_ms(
            torch, lambda: mha(x, x, x, key_padding_mask=kpm, need_weights=False))
        xl = x.clone().requires_grad_()
        leaves = [xl, *mha.parameters()]
        out = mha(xl, xl, xl, key_padding_mask=kpm, need_weights=False)[0]
        block["library_bwd_ms"] = _time_ms(
            torch, lambda: torch.autograd.grad(out, leaves, dout, retain_graph=True))
    ops, dz, tbits = _tail_operands(torch, B, S, D, F, dtype)
    tail = compare_train_chain(
        torch, "encoder tail",
        lambda *o: ET.fused_encoder_tail(*o, RATE, 0, tbits),
        lambda: ET.encoder_tail_reference(*ops, RATE, tbits),
        lambda: ET.encoder_tail_bwd_reference(*ops, dz, RATE, tbits),
        ops, dz, dtype, TAIL_GRADS, timed, drawn=lambda *o: ET.fused_encoder_tail(*o, RATE, 0))
    return block, tail


def tail_masks(torch, ET, ops, rate, seed, bits=None):
    """The three packed keep masks the tail's forward chain stores."""
    with torch.no_grad():
        return ET._fwd_cuda(ops[0], ops[1], tuple(ops[2:]), rate, seed, bits)[1][-1]


def mask_sites_differing(torch, DB, masks, bits, rate):
    """The sites whose packed mask is not bitwise keep_mask_bits of bits."""
    want = lambda b: DB.keep_mask_bits(b.reshape(-1, b.shape[-1]), rate).view(torch.int32)
    return [site for site, (m, b) in enumerate(zip(masks, bits))
            if not torch.equal(m.view(torch.int32), want(b))]


def phase_tail_edges(torch, ET, DB, dev):
    """Phase 5, tail edges: the encoder tail forward and its ten gradients
    against the plain versions at B=3, S=37 (ragged rows) for every d_model
    of TAIL_EDGE_D and ff size of TAIL_EDGE_F, bf16 and f32, in each (mode,
    rate) of TAIL_EDGE_MODES, within TRAIN_REL of max |plain|; two runs
    bitwise equal; the packed masks bitwise equal to keep_mask_bits of the
    bits; in-kernel Philox bitwise equal to the same stream injected. These
    launches are comparisons, counted on no path."""
    B, S, seed = 3, 37, 97531
    worst, cases, failed = {}, 0, []
    for dtype in (torch.bfloat16, torch.float32):
        dname = str(dtype).split(".")[-1]
        rel = TRAIN_REL[dname]
        for D in TAIL_EDGE_D:
            for F in TAIL_EDGE_F:
                ops, dz, injected = _tail_operands(torch, B, S, D, F, dtype, seed=D + F)
                dumped = DB.tail_dropout_bits(seed, B, S, D, F, device=dev)
                for mode, rate in TAIL_EDGE_MODES:
                    bits = injected if mode == 1 else None
                    plain_bits = (None, injected, dumped)[mode]
                    run = lambda b=bits, r=rate: _fwd_bwd(
                        torch, lambda *o: ET.fused_encoder_tail(*o, r, seed, b), ops, dz)
                    what = f"tail D={D} F={F} {dname} mode={mode} rate={rate}"
                    try:
                        out, grads = run()
                        e = _rel_check(torch, f"{what} out", out,
                                       ET.encoder_tail_reference(*ops, rate, plain_bits), rel)[1]
                        for n, g, p in zip(TAIL_GRADS, grads, ET.encoder_tail_bwd_reference(
                                *ops, dz, rate, plain_bits)):
                            e = max(e, _rel_check(torch, f"{what} {n}", g, p.to(g.dtype), rel,
                                                  p)[1])
                        worst[dname] = max(worst.get(dname, 0.0), e)
                        out2, grads2 = run()
                        if not (torch.equal(out, out2) and all(map(torch.equal, grads, grads2))):
                            raise AssertionError(f"{what}: two runs differ")
                        bad = mode and mask_sites_differing(
                            torch, DB, tail_masks(torch, ET, ops, rate, seed, bits), plain_bits,
                            rate)
                        if bad:
                            raise AssertionError(f"{what}: masks of sites {bad} differ from "
                                                 f"keep_mask_bits of the bits")
                        if mode == 2:
                            out3, grads3 = run(dumped)
                            if not (torch.equal(out, out3) and all(map(torch.equal, grads, grads3))):
                                raise AssertionError(f"{what}: in-kernel Philox differs from the "
                                                     f"injected dump")
                    except AssertionError as err:
                        failed.append(str(err))
                    cases += 1
    if failed:
        raise AssertionError(f"{len(failed)} of {cases} tail edge cases failed:\n"
                             + "\n".join(failed[:30]))
    print(f"encoder tail at B={B} S={S}, D={list(TAIL_EDGE_D)}, F={list(TAIL_EDGE_F)}, "
          f"(mode, rate)={list(TAIL_EDGE_MODES)}: {cases} cases (bf16/f32; out and 10 grads) vs "
          f"plain, worst {json.dumps(worst)} of max |plain| (bounds {json.dumps(TRAIN_REL)}); "
          f"two runs, packed masks vs keep_mask_bits and Philox vs injected dump bitwise equal")
    return worst


def _torch_mha(torch, wqkv, bqkv, wo, bo, H, dropout):
    """nn.MultiheadAttention holding torch-layout block weights: the one
    PyTorch call that computes an attention block (library time only)."""
    D = wo.shape[0]
    mha = torch.nn.MultiheadAttention(D, H, dropout=dropout, batch_first=True,
                                      device=wo.device, dtype=wo.dtype)
    with torch.no_grad():
        for p, w in ((mha.in_proj_weight, wqkv), (mha.in_proj_bias, bqkv),
                     (mha.out_proj.weight, wo), (mha.out_proj.bias, bo)):
            p.copy_(w)
    return mha


def _no_grad_ms(torch, fn):
    with torch.no_grad():
        return _time_ms(torch, fn)


def _dump_matches(torch, DB, outs, want, seed, B, H, site, R):
    """Run the dump kernel into outs twice, over all zero and over all one
    bits, so that a word it leaves unwritten shows; True when every output
    equals its want (int64 [..., C]) both times."""
    for fill in (0, -1):
        for o in outs:
            o.view(torch.int32).fill_(fill)
        DB._dump_into(outs, seed, B, H, site, R)
        if not all(torch.equal(o.to(torch.int64), w) for o, w in zip(outs, want)):
            return False
    return True


def phase_dump_edges(torch, DB, dev):
    """Phase 6a: the dump kernel at the edges of its plan, every case
    bitwise equal to philox_bits."""
    ar = lambda n: torch.arange(n, device=dev)
    empty = lambda *shape: torch.empty(shape, dtype=torch.uint32, device=dev)
    cases = 0
    for B, H, R, C, site, seed in itertools.product(DUMP_EDGE_B, DUMP_EDGE_H, DUMP_EDGE_R,
                                                   DUMP_EDGE_C, DUMP_EDGE_SITES,
                                                   DUMP_EDGE_SEEDS):
        if site < 0:
            want = DB.philox_bits(seed, ar(B)[:, None], ar(H)[None, :], R, C, device=dev)
        else:
            want = DB.philox_bits(seed, ar(B), site, R, C, device=dev)[:, None].expand(B, H, R, C)
        if not _dump_matches(torch, DB, [empty(B, H, R, C)], [want], seed, B, H, site, R):
            raise AssertionError(f"dump differs from philox_bits at B={B} H={H} R={R} C={C} "
                                 f"site={site} seed={seed}")
        cases += 1
    for B, R, D, F, seed in itertools.product(DUMP_EDGE_B, DUMP_EDGE_R, TAIL_DUMP_D, TAIL_DUMP_F,
                                              DUMP_EDGE_SEEDS):
        widths = (D, F, D)
        want = [DB.philox_bits(seed, ar(B), site, R, n, device=dev)
                for site, n in enumerate(widths)]
        if not _dump_matches(torch, DB, [empty(B, R, n) for n in widths], want, seed, B, 1, 0, R):
            raise AssertionError(f"tail dump differs from philox_bits at B={B} R={R} D={D} "
                                 f"F={F} seed={seed}")
        cases += 1
    B, H, S = (BIG_DUMP[k] for k in ("B", "H", "S"))
    seed = 2 ** 31 - 1
    big = empty(B, H, S, S)
    for fill in (0, -1):
        big.view(torch.int32).fill_(fill)
        DB._dump_into([big], seed, B, H, -1, S)
        for b, h in ((0, 0), (B - 1, H - 1)):
            if not torch.equal(big[b, h].to(torch.int64),
                               DB.philox_bits(seed, b, h, S, S, device=dev)):
                raise AssertionError(f"the dump of {big.numel()} words differs from philox_bits "
                                     f"at (b, h) = ({b}, {h})")
    cases += 1
    del big
    torch.cuda.empty_cache()
    print(f"dump edges: {cases} cases bitwise equal to philox_bits, each written over all zero "
          f"and all one bits (C {DUMP_EDGE_C} x R {DUMP_EDGE_R} x H {DUMP_EDGE_H} x B "
          f"{DUMP_EDGE_B} x site {DUMP_EDGE_SITES} x seeds {DUMP_EDGE_SEEDS}; the tail's three "
          f"sites at D {TAIL_DUMP_D} x F {TAIL_DUMP_F}; [{B}, {H}, {S}, {S}] = {B * H * S * S} "
          f"words, its first and last (b, h) slices)")


def phase_random_stream(torch, TB, ET, DB, shape, dev):
    """Phase 6: dump kernels == the Philox stream computed with torch ops,
    at the flagship and (phase_dump_edges) at the edges of the kernel's
    plan; in-kernel Philox == injected dumped bits, bitwise, forward and
    every gradient; keep fraction; two backward runs bitwise equal."""
    phase_dump_edges(torch, DB, dev)
    B, S, D, H, F = (shape[k] for k in ("B", "S", "D", "H", "F"))
    seed = 20240601
    rows = {}
    bits = DB.dropout_bits(seed, B, H, S, device=dev)
    ar = lambda n: torch.arange(n, device=dev)
    plain_bits = lambda: DB.philox_bits(seed, ar(B)[:, None], ar(H)[None, :], S, S, device=dev)
    if not torch.equal(bits.to(torch.int64), plain_bits()):
        raise AssertionError("dropout_bits dump differs from the Philox stream")
    tbits = DB.tail_dropout_bits(seed, B, S, D, F, device=dev)
    plain_tail = lambda: [DB.philox_bits(seed, ar(B), site, S, n, device=dev)
                          for site, n in enumerate((D, F, D))]
    if not all(torch.equal(a.to(torch.int64), b) for a, b in zip(tbits, plain_tail())):
        raise AssertionError("tail_dropout_bits dump differs from the Philox stream")
    thr = DB.keep_threshold(RATE)
    for name, t in [("attention", bits)] + [(f"tail site {i}", b) for i, b in enumerate(tbits)]:
        kept = (t.to(torch.int64) < thr).double().mean().item()
        print(f"keep fraction {name}: {kept:.6f} (rate {RATE})")
        if abs(kept - (1 - RATE)) > 0.005:
            raise AssertionError(f"keep fraction {kept} of {name} is not within 0.5% of 0.9")
    seq = DB.sequence_dropout_bits(seed, B, S, D, device=dev)
    plain_seq = lambda: DB.philox_bits(seed, ar(B), 0, S, D, device=dev)
    if not torch.equal(seq.to(torch.int64), plain_seq()):
        raise AssertionError("sequence_dropout_bits dump differs from the Philox stream")
    with torch.no_grad():
        for name, fn, plain in (
                ("dropout_bits", lambda: DB.dropout_bits(seed, B, H, S, device=dev), plain_bits),
                ("tail_dropout_bits", lambda: DB.tail_dropout_bits(seed, B, S, D, F, device=dev),
                 plain_tail),
                ("sequence_dropout_bits",
                 lambda: DB.sequence_dropout_bits(seed, B, S, D, device=dev), plain_seq)):
            p1, k1, k2, p2 = (_time_ms(torch, f) for f in (plain, fn, fn, plain))
            rows[name] = dict(ms=(k1 + k2) / 2, plain_ms=(p1 + p2) / 2, max_abs_err=0.0)
    print(f"dumps at B={B} S={S} H={H} D={D} F={F}, kernel / plain ms: "
          + ", ".join(f"{k} {r['ms']:.4f} / {r['plain_ms']:.4f}" for k, r in rows.items()))

    dtype = torch.bfloat16
    (x, wqkv, bqkv, wo, bo), dout, _, kpm = _block_operands(torch, B, S, D, H, dtype, "bool")
    cases = [("attention block", [x, wqkv, bqkv, wo, bo], dout,
              lambda b: lambda *o: TB.fused_train_attention_block(*o, H, RATE, seed, kpm, b),
              bits)]
    ops, dz, _ = _tail_operands(torch, B, S, D, F, dtype)
    cases.append(("encoder tail", ops, dz,
                  lambda b: lambda *o: ET.fused_encoder_tail(*o, RATE, seed, b), tbits))
    for mode, given in ((2, None), (1, tbits)):
        bad = mask_sites_differing(torch, DB, tail_masks(torch, ET, ops, RATE, seed, given), tbits,
                                   RATE)
        if bad:
            raise AssertionError(f"encoder tail: mode {mode} masks of sites {bad} differ from "
                                 f"keep_mask_bits of the dumped bits")
    print("encoder tail: packed keep masks == keep_mask_bits(tail_dropout_bits), bitwise, "
          "drawn in-kernel and injected")
    for name, ops_, d, make, injected in cases:
        out_p, grads_p = _fwd_bwd(torch, make(None), ops_, d)
        out_i, grads_i = _fwd_bwd(torch, make(injected), ops_, d)
        _, grads_p2 = _fwd_bwd(torch, make(None), ops_, d)
        if not (torch.equal(out_p, out_i) and all(map(torch.equal, grads_p, grads_i))):
            raise AssertionError(f"{name}: in-kernel Philox differs from the injected dump")
        if not all(map(torch.equal, grads_p, grads_p2)):
            raise AssertionError(f"{name}: two backward runs differ")
        print(f"{name}: Philox == injected bits, bitwise, forward and {len(grads_p)} grads; "
              f"two backward runs bitwise equal")
    return rows


def _zero(counts):
    for k in counts:
        counts[k] = 0


def _train_batch(torch, rng, B, T, dev, njoints=263):
    from mdm_tpu_torch.models import Conditioning

    x = torch.from_numpy(rng.normal(size=(B, T, njoints)).astype(np.float32)).to(dev)
    return {"x": x, "mask": torch.ones(B, T, dtype=torch.bool, device=dev),
            "cond": Conditioning(text_embed=torch.from_numpy(
                rng.normal(size=(B, 512)).astype(np.float32)).to(dev))}


# Phase 7's tolerances (tests/test_torch_train.py holds the CPU step to JAX
# with the same ones). Relative to the largest value of each tensor: AdamW's
# moments, and each parameter's and EMA's update (p_after - p_before) plus
# two f32 ulps of the parameter's largest value. A step that starts from the
# same parameters on both sides holds to STEP_REL; a later step starts from
# parameters that differ where an earlier update was ill-conditioned, and
# holds to LATER_REL. Updates are compared where the first moment stood
# above HELD x its tensor's largest at every step so far: elsewhere the
# gradient is at rounding level, and Adam, which divides it by its own size,
# may move it either way on the two sides (dbk is zero in exact arithmetic).
STEP_REL = dict(moments=2e-5, updates=2e-5)
LATER_REL = dict(moments=1e-4, updates=1e-3)
HELD = 2e-3


def _snapshot(torch, state):
    return ({n: p.detach().cpu().clone() for n, p in state.params().items()},
            {n: t.cpu().clone() for n, t in state.ema_params.items()})


def _check_step_update(torch, cpu, card, before, held, tol):
    """AdamW's count and moments, and every parameter's and EMA's update,
    card against CPU after one step. Returns the worst relative errors."""
    worst = dict(moments=0.0, updates=0.0)
    n_held = n_all = 0
    (p0, e0), (q0, f0) = before
    cpu_params, card_params = cpu.params(), card.params()
    for name, p in cpu_params.items():
        q = card_params[name]
        sp, sq = cpu.optimizer.state[p], card.optimizer.state[q]
        if int(sp["step"]) != int(sq["step"]):
            raise AssertionError(f"AdamW count of {name}: cpu {sp['step']} vs card {sq['step']}")
        for k in ("exp_avg", "exp_avg_sq"):
            want, got = sp[k], sq[k].cpu()
            rel = ((got - want).abs().max() / want.abs().max().clamp_min(1e-30)).item()
            worst["moments"] = max(worst["moments"], rel)
            if not rel <= tol["moments"]:
                raise AssertionError(f"{k} of {name}: card vs cpu {rel:.3g} of its largest value "
                                     f"(tolerance {tol['moments']})")
        keep = held.setdefault(name, torch.ones(p.shape, dtype=torch.bool))
        keep &= sp["exp_avg"].abs() > HELD * sp["exp_avg"].abs().max()
        n_held, n_all = n_held + int(keep.sum()), n_all + keep.numel()
        ulps = 2 * 2.0 ** -23 * max(p.detach().abs().max().item(), q.detach().abs().max().item())
        for what, want, got in (
                ("update", p.detach() - p0[name], q.detach().cpu() - q0[name]),
                ("EMA update", cpu.ema_params[name] - e0[name],
                 card.ema_params[name].cpu() - f0[name])):
            scale = want.abs().max().item()
            err = ((got - want).abs() * keep).max().item()
            if scale:  # a parameter no gradient reaches (an unrequested goal row) stays put
                worst["updates"] = max(worst["updates"], max(0.0, err - ulps) / scale)
            if not err <= tol["updates"] * scale + ulps:
                raise AssertionError(f"{what} of {name}: card vs cpu max abs err {err:.3g}, "
                                     f"largest update {scale:.3g}")
    if n_held < 0.8 * n_all:
        raise AssertionError(f"only {n_held} of {n_all} coordinates compared")
    worst["held"] = n_held / n_all
    return worst


def _text_case(torch, rng, B, T):
    """Phase 7's batch (normal features, a pooled text) and its draws."""
    batch = _train_batch(torch, rng, B, T, "cpu")
    draws = {"t": torch.from_numpy(rng.integers(0, 1000, B)),
             "noise": torch.from_numpy(rng.normal(size=(B, T, 263)).astype(np.float32)),
             "cond_drop": torch.from_numpy(rng.random(B) < 0.1)}
    return batch, draws


def phase_step_card_vs_cpu(torch, dev, steps=3, dropout=0.0, route="AUTO route", model_kw=None,
                           case=_text_case, loss=None, step_kw=None):
    """Phase 7 (three steps, rate 0), phase 11 (one step of the drop route,
    rate 0.1) and phase 14 (one step each of DiP, a2m, the GRU and goal
    conditioning at rate 0.1): train steps at a small f32 width with
    identical weights, draws and step keys, card against CPU, each step's
    update checked. At rate > 0 both sides drop the same elements: every
    dropout mask is Philox keyed on a seed drawn from the step's key.
    ``model_kw``: MDMConfig fields over the small trans_enc; ``case(torch,
    rng, B, T)``: a CPU batch and its draws; ``loss``: LossConfig fields;
    ``step_kw``: make_train_step keywords."""
    from mdm_tpu_torch.diffusion import LossConfig, Schedule
    from mdm_tpu_torch.models import MDM, MDMConfig
    from mdm_tpu_torch.train import OptimConfig, TrainStepConfig, create_train_state, make_train_step

    small = MDMConfig(**{**dict(latent_dim=128, ff_size=256, num_layers=2, num_heads=4,
                                dropout=dropout), **(model_kw or {})})
    B, T = 4, 32
    # Weight decay, LR anneal and EMA decay each move the updates far past
    # the tolerances, so a wrong one shows.
    config = TrainStepConfig(loss=LossConfig(**(loss or {})),
                             optim=OptimConfig(lr=1e-3, weight_decay=0.5, lr_anneal_steps=4,
                                               ema_decay=0.9))
    sides = []
    for device in ("cpu", dev):
        model = MDM(small).init_weights(torch.Generator().manual_seed(3)).to(device)
        sides.append((create_train_state(model, config.optim), device,
                      make_train_step(Schedule.create("cosine", 1000).to(device), config,
                                      **(step_kw or {}))))
    rng = np.random.default_rng(5)
    held, report = {}, []
    for i in range(steps):
        batch, draws = case(torch, rng, B, T)
        before = [_snapshot(torch, state) for state, _, _ in sides]
        metrics = []
        for state, device, step in sides:
            b = {k: v.to(device) for k, v in batch.items()}
            _, m = step(state, b, i, draws={k: v.to(device) for k, v in draws.items()})
            metrics.append({k: v.item() for k, v in m.items()})
        for k, a in metrics[0].items():
            if abs(a - metrics[1][k]) > 1e-4 * max(abs(a), 1e-3):
                raise AssertionError(f"step {i} metric {k}: cpu {a} vs card {metrics[1][k]}")
        report.append(_check_step_update(torch, sides[0][0], sides[1][0], before, held,
                                         STEP_REL if i == 0 else LATER_REL))
        report[-1]["loss"] = (metrics[0]["loss"], metrics[1]["loss"])
    print(f"train step f32 card vs cpu, {route}, rate {dropout}, {steps} steps, each update "
          f"checked (tolerances {STEP_REL} then {LATER_REL}; metrics 1e-4 relative): "
          f"{json.dumps(report)}")


class _StepData:
    """Synthetic batches with the iter_from contract (a pure function of the step)."""

    def __init__(self, torch, dev, B, T):
        self.torch, self.dev, self.B, self.T = torch, dev, B, T

    def __iter__(self):
        return self.iter_from(0)

    def iter_from(self, start):
        i = start
        while True:
            yield _train_batch(self.torch, np.random.default_rng(100 + i), self.B, self.T, "cpu")
            i += 1


def phase_flagship_train(torch, TB, ET, DB, dev):
    """Phase 8: the training path at the flagship (main path of this slice),
    timed; then a small TrainLoop resume that must be bitwise exact."""
    from mdm_tpu_torch.diffusion import Schedule
    from mdm_tpu_torch.models import MDM, MDMConfig
    from mdm_tpu_torch.ops import _chain
    from mdm_tpu_torch.train import (LoopConfig, OptimConfig, TrainLoop, TrainStepConfig,
                                     create_train_state, make_train_step, step_key)

    B, T = 128, 196
    cfg = MDMConfig(njoints=263, compute_dtype="bfloat16", dropout=RATE, **FLAGSHIP)
    model = MDM(cfg).init_weights(torch.Generator().manual_seed(0)).to(dev)
    sched = Schedule.create("cosine", 1000).to(dev)
    batch = {"x": torch.from_numpy(np.random.default_rng(0).normal(size=(B, T, 263))
                                   .astype(np.float32)).to(dev),
             "mask": torch.ones(B, T, dtype=torch.bool, device=dev)}
    from mdm_tpu_torch.models import Conditioning
    batch["cond"] = Conditioning(text_embed=torch.zeros(B, 512, device=dev))
    fit = make_train_step(sched, TrainStepConfig(optim=OptimConfig(lr=1e-3)))
    state = create_train_state(model, OptimConfig(lr=1e-3))

    steps = 30
    for counts in (TB.LAUNCHES, ET.LAUNCHES, _chain.GEMM_LAUNCHES):  # the main path's from here
        _zero(counts)
    DB.LAUNCHES["sequence_dropout_bits"] = 0
    losses = []
    for i in range(steps):
        state, m = fit(state, batch, step_key(0, i))
        losses.append(m["loss"])
    losses = torch.stack(losses).cpu().numpy()
    launches = {f"{n}.{d}": c[d] for n, c in (("fused_train_attention_block", TB.LAUNCHES),
                                               ("fused_encoder_tail", ET.LAUNCHES))
                for d in ("fwd", "bwd")}
    expected = cfg.num_layers * steps
    if any(v != expected for v in launches.values()):
        raise AssertionError(f"training launched {launches}, expected {expected} each "
                             f"({cfg.num_layers} layers x {steps} steps)")
    # Per layer and step: the block's q/k/v and out projection and the
    # tail's linear1 and linear2 forward, and the backward's four dY . W and
    # dY^T . X products each for block and tail, all on wgmma.
    products = dict(_chain.GEMM_LAUNCHES)
    want = {"wgmma": 12 * expected, "fma": 0}
    if products != want:
        raise AssertionError(f"training's products launched {products}, expected {want}")
    seq_bits = DB.LAUNCHES["sequence_dropout_bits"]
    if seq_bits != steps:
        raise AssertionError(f"the sequence dropout's dump ran {seq_bits} times in {steps} steps")
    if not np.isfinite(losses).all():
        raise AssertionError(f"non-finite training loss: {losses}")
    first, last = losses[:10].mean(), losses[-10:].mean()
    print(f"flagship train B={B} T={T} bf16 dropout {RATE}, lr 1e-3: loss first 10 "
          f"{first:.5f}, last 10 {last:.5f}; launches {launches}, sequence dropout "
          f"dump {seq_bits}, products {products}")
    if not last < first:
        raise AssertionError("the training loss did not descend")

    step = make_train_step(sched, TrainStepConfig(optim=OptimConfig(lr=1e-4)))
    for i in range(5):
        state, _ = step(state, batch, step_key(1, i))
    torch.cuda.reset_peak_memory_stats()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for i in range(20):
        state, m = step(state, batch, step_key(1, 5 + i))
    end.record()
    torch.cuda.synchronize()
    step_ms = start.elapsed_time(end) / 20
    print(f"train_step_ms_b128_bf16: {step_ms:.3f} ms/step (CUDA events, 20 steps after 5 warm; "
          f"peak {torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB)")

    # TrainLoop: 6 steps straight == 3 steps + checkpoint + resume + 3 steps, bitwise.
    small = MDMConfig(latent_dim=128, ff_size=256, num_layers=2, num_heads=4,
                      compute_dtype="bfloat16", dropout=RATE)
    optim = OptimConfig(lr=1e-3)
    loop_step = make_train_step(sched, TrainStepConfig(optim=optim))

    def run(save_dir, n):
        model = MDM(small).init_weights(torch.Generator().manual_seed(1)).to(dev)
        loop = TrainLoop(loop_step, create_train_state(model, optim), _StepData(torch, dev, 8, 32),
                         LoopConfig(save_dir=save_dir, num_steps=n, log_interval=100,
                                    save_interval=3), rng_seed=11)
        loop.run()
        return loop.state

    with tempfile.TemporaryDirectory() as tmp:
        straight = run(os.path.join(tmp, "a"), 6)
        run(os.path.join(tmp, "b"), 3)
        resumed = run(os.path.join(tmp, "b"), 6)
    same = lambda a, b: all(torch.equal(a[k], b[k]) for k in a)
    exp_avg = lambda s: {str(i): s.optimizer.state[p]["exp_avg"]
                         for i, p in enumerate(s.model.parameters())}
    if not (resumed.step == straight.step == 6 and same(straight.params(), resumed.params())
            and same(straight.ema_params, resumed.ema_params)
            and same(exp_avg(straight), exp_avg(resumed))):
        raise AssertionError("TrainLoop resume is not bit exact")
    print("TrainLoop: 6 steps == 3 steps + checkpoint + resume + 3 steps, bitwise "
          "(params, EMA, AdamW moments)")
    return dict(launches, sequence_dropout_bits=seq_bits), step_ms


def compare_forward(torch, name, kernel, plain, rel, timed=False):
    """A forward-only kernel against its plain version on the same inputs;
    times both in turns (plain, kernel, kernel, plain) when asked, and the
    kernel on the card alone (CUDA graph replay)."""
    from mdm_tpu_torch.scripts.gemm_probe import device_ms

    with torch.no_grad():
        out = kernel()
        torch.cuda.synchronize()
        err, rel_err = _rel_check(torch, name, out, plain(), rel)
        row = dict(max_abs_err=err, rel_err=rel_err, rel_tol=rel)
        if timed:
            p1, k1, k2, p2 = (_time_ms(torch, f) for f in (plain, kernel, kernel, plain))
            row.update(ms=(k1 + k2) / 2, plain_ms=(p1 + p2) / 2, device_ms=device_ms(kernel))
    print("attention kernel", name, json.dumps(row))
    return row


def _heads(t, H):
    """[B, S, D] -> a [B, H, S, Dh] view."""
    B, S, D = t.shape
    return t.view(B, S, H, D // H).transpose(1, 2)


def _ragged_mask(torch, B, S):
    kpm = torch.zeros(B, S, dtype=torch.bool)
    for b in range(0, B, 3):
        kpm[b, S - 1 - (7 * b) % (S // 2):] = True
    return kpm


def phase_attention_kernels(torch, dev):
    """Phase 9: kernels #11, #10, #12 and #7/#8 against their plain versions
    at the shapes of their paths (bf16) and at a small f32 shape; #7/#8's
    in-kernel Philox against dumped bits, bitwise. Returns each kernel's
    row of the kernels line but its launches."""
    import torch.nn.functional as F
    from mdm_tpu_torch.ops import attention as A
    from mdm_tpu_torch.ops import attention_block as AB
    from mdm_tpu_torch.ops import attention_dropout as AD
    from mdm_tpu_torch.ops import attention_v2 as V2
    from mdm_tpu_torch.ops import dropout_bits as DB
    from mdm_tpu_torch.ops._chain import attention_fwd, bsd_view, dev as aligned, row_bias_strides
    from mdm_tpu_torch.ops._mask import row_bias_contrib

    rows = {}
    bf, f32 = torch.bfloat16, torch.float32
    rel_bf, rel_f32 = TRAIN_REL["bfloat16"], TRAIN_REL["float32"]
    g = torch.Generator().manual_seed(0)
    r = lambda *shape, sc=1.0, dt=bf: (_randn(torch, g, *shape, sc=sc)).to(dt).to(dev)
    bias_of = lambda kpm, dt: torch.where(kpm, -1e9, 0.0).to(dt)[:, None, None, :]

    lib_ms = lambda fn: _no_grad_ms(torch, fn)

    # #11 at the sampling attention shape, no mask and the ragged bool mask.
    B, S, D, H = (ATTN_SHAPE[k] for k in ("B", "S", "D", "H"))
    q, k, v = r(B, S, D), r(B, S, D), r(B, S, D)
    kpm = _ragged_mask(torch, B, S).to(dev)
    errs = []
    for mask in (None, kpm):
        row = compare_forward(torch, f"fused_attention_v2 mask={mask is not None}",
                              lambda: V2.fused_attention_v2(q, k, v, H, mask),
                              lambda: V2.attention_v2_reference(q, k, v, H, mask), rel_bf,
                              timed=mask is not None)
        errs.append(row["max_abs_err"])
    qs, ks, vs = r(3, 37, 128, dt=f32), r(3, 37, 128, dt=f32), r(3, 37, 128, dt=f32)
    frow = r(3, 37, dt=f32)
    compare_forward(torch, "fused_attention_v2 f32 float row",
                    lambda: V2.fused_attention_v2(qs, ks, vs, 4, frow),
                    lambda: V2.attention_v2_reference(qs, ks, vs, 4, frow), rel_f32)
    out_bytes = B * S * D * 4
    rows["fused_attention_v2"] = dict(
        row, max_abs_err=max(errs),
        library_ms=lib_ms(lambda: F.scaled_dot_product_attention(
            _heads(q, H), _heads(k, H), _heads(v, H), attn_mask=bias_of(kpm, bf))),
        **dict(zip(("bound_ms", "bound_by"),
                   bound(4 * B * S * S * D, nbytes(q, k, v, kpm) + out_bytes))))
    # What the JAX signature's f32 output costs the pallas route, whose
    # layer casts it to bf16 at once: that route against the same core
    # storing bf16 (bitwise the same values).
    out16 = torch.empty_like(q)
    view, mrow = bsd_view(S, D, D // H), aligned(row_bias_contrib(kpm))
    store16 = lambda: attention_fwd(q, k, v, view, out16, view, B, S, H, D // H, mrow,
                                    row_bias_strides(S))
    route = lambda: V2.fused_attention_v2(q, k, v, H, kpm).to(bf)
    store16()
    if not torch.equal(out16, route()):
        raise AssertionError("the bf16 store differs from the f32 output cast to bf16")
    r1, s1, s2, r2 = (lib_ms(f) for f in (route, store16, store16, route))
    rows["fused_attention_v2"].update(route_ms=(r1 + r2) / 2, bf16_store_ms=(s1 + s2) / 2)
    print(f"fused_attention_v2: f32 output + the layer's cast {(r1 + r2) / 2:.4f} ms, "
          f"bf16 store {(s1 + s2) / 2:.4f} ms")

    # #10 on [B, H, S, Dh]: no bias, the ragged mask's row, a full per-head bias.
    qh, kh, vh = (_heads(t, H).contiguous() for t in (q, k, v))
    full = r(B, H, S, S, dt=f32)
    errs = []
    for name, bias in (("none", None), ("row", bias_of(kpm, f32)), ("per-head", full)):
        row = compare_forward(torch, f"fused_attention bias={name}",
                              lambda: A.fused_attention(qh, kh, vh, bias),
                              lambda: A.xla_attention(qh, kh, vh, bias), rel_bf,
                              timed=name == "per-head")
        errs.append(row["max_abs_err"])
    qs4, ks4, vs4 = (_heads(t, 4).contiguous() for t in (qs, ks, vs))
    fs = r(3, 1, 37, 37, dt=f32)
    compare_forward(torch, "fused_attention f32 shared full bias",
                    lambda: A.fused_attention(qs4, ks4, vs4, fs),
                    lambda: A.xla_attention(qs4, ks4, vs4, fs), rel_f32)
    full_bf = full.to(bf)
    rows["fused_attention"] = dict(
        row, max_abs_err=max(errs),
        library_ms=lib_ms(lambda: F.scaled_dot_product_attention(qh, kh, vh, attn_mask=full_bf)),
        **dict(zip(("bound_ms", "bound_by"),
                   bound(4 * B * S * S * D, nbytes(qh, kh, vh, full) + out_bytes))))

    # #12 at the sampling shape, bool mask; and small f32.
    x = r(B, S, D)
    ws = [t for _ in range(4) for t in (r(D, D, sc=D ** -0.5), r(D, sc=0.1))]
    row = compare_forward(torch, "fused_attention_block",
                          lambda: AB.fused_attention_block(x, *ws, H, kpm),
                          lambda: AB.attention_block_reference(x, *ws, H, kpm), rel_bf,
                          timed=True)
    xs = r(3, 37, 128, dt=f32)
    wss = [t for _ in range(4) for t in (r(128, 128, sc=128 ** -0.5, dt=f32),
                                         r(128, sc=0.1, dt=f32))]
    kpm_s = _ragged_mask(torch, 3, 37).to(dev)
    compare_forward(torch, "fused_attention_block f32",
                    lambda: AB.fused_attention_block(xs, *wss, 4, kpm_s),
                    lambda: AB.attention_block_reference(xs, *wss, 4, kpm_s), rel_f32)
    M = B * S
    mha = _torch_mha(torch, *AB._packed(*ws[:7]), ws[7], H, 0.0).eval()
    library = lambda: mha(x, x, x, key_padding_mask=kpm, need_weights=False)[0]
    with torch.no_grad():
        lib_err = (library().float() - AB.attention_block_reference(x, *ws, H, kpm).float()
                   ).abs().max().item()
    print(f"fused_attention_block: nn.MultiheadAttention (eval) vs plain max abs err {lib_err}")
    rows["fused_attention_block"] = dict(
        row, library_ms=lib_ms(library),
        **dict(zip(("bound_ms", "bound_by"),
                   bound(8 * M * D * D + 4 * B * S * S * D, nbytes(x, *ws, kpm, x)))))

    # #7/#8 at the flagship training shape, injected bits (timed drawing
    # them in-kernel, as the drop route runs); small f32.
    B, S, D, H = (TRAIN_SHAPE[k] for k in ("B", "S", "D", "H"))
    _, dout, bits, kpm = _block_operands(torch, B, S, D, H, bf, "bool")
    q, k, v = r(B, S, D), r(B, S, D), r(B, S, D)
    dout = dout.float()
    chain = compare_train_chain(
        torch, "dropout attention",
        lambda *o: AD.fused_dropout_attention(*o, H, RATE, 0, kpm, bits),
        lambda: AD.dropout_attention_reference(q, k, v, H, RATE, bits, kpm),
        lambda: AD.dropout_attention_bwd_reference(q, k, v, H, dout, RATE, bits, kpm),
        [q, k, v], dout, bf, ["dq", "dk", "dv"],
        drawn=lambda *o: AD.fused_dropout_attention(*o, H, RATE, 0, kpm))
    _, dos, bits_s, frow = _block_operands(torch, 3, 37, 128, 4, f32, "float")
    qs, ks, vs = r(3, 37, 128, dt=f32), r(3, 37, 128, dt=f32), r(3, 37, 128, dt=f32)
    compare_train_chain(
        torch, "dropout attention f32",
        lambda *o: AD.fused_dropout_attention(*o, 4, RATE, 0, frow, bits_s),
        lambda: AD.dropout_attention_reference(qs, ks, vs, 4, RATE, bits_s, frow),
        lambda: AD.dropout_attention_bwd_reference(qs, ks, vs, 4, dos, RATE, bits_s, frow),
        [qs, ks, vs], dos, f32, ["dq", "dk", "dv"], timed=False)
    grads_bytes = 3 * B * S * D * 2  # in q's dtype
    sdpa_drop = lambda q, k, v: F.scaled_dot_product_attention(
        _heads(q, H), _heads(k, H), _heads(v, H), attn_mask=bias_of(kpm, bf), dropout_p=RATE)
    # The library backward: SDPA's with dropout 0.1 on the same bf16
    # operands (another random stream), its graph kept across calls.
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    sdpa_out = sdpa_drop(*leaves)
    dout_h = _heads(dout.to(bf), H)
    sdpa_bwd = _time_ms(torch, lambda: torch.autograd.grad(sdpa_out, leaves, dout_h,
                                                            retain_graph=True))
    for key, name, flops, moved, lib in (
            ("fwd", "fused_dropout_attention.forward", 4 * B * S * S * D,
             nbytes(q, k, v, kpm) + B * S * D * 4, lib_ms(lambda: sdpa_drop(q, k, v))),
            ("bwd", "fused_dropout_attention.backward", 8 * B * S * S * D,
             nbytes(q, k, v, kpm, dout) + grads_bytes, sdpa_bwd)):
        rows[name] = dict(max_abs_err=chain[f"max_abs_err_{key}"], ms=chain[f"{key}_ms"],
                          device_ms=chain.get(f"{key}_device_ms"),
                          plain_ms=chain[f"{key}_plain_ms"], library_ms=lib,
                          **dict(zip(("bound_ms", "bound_by"), bound(flops, moved))))

    # The in-kernel Philox stream against the dumped bits, bitwise.
    seed = 20240601
    dumped = DB.dropout_bits(seed, B, H, S, device=dev)
    make = lambda b: lambda *o: AD.fused_dropout_attention(*o, H, RATE, seed, kpm, b)
    out_p, grads_p = _fwd_bwd(torch, make(None), [q, k, v], dout)
    out_i, grads_i = _fwd_bwd(torch, make(dumped), [q, k, v], dout)
    _, grads_p2 = _fwd_bwd(torch, make(None), [q, k, v], dout)
    if not (torch.equal(out_p, out_i) and all(map(torch.equal, grads_p, grads_i))):
        raise AssertionError("dropout attention: in-kernel Philox differs from the injected dump")
    if not all(map(torch.equal, grads_p, grads_p2)):
        raise AssertionError("dropout attention: two backward runs differ")
    print("dropout attention: Philox == injected bits, bitwise, forward and 3 grads; "
          "two backward runs bitwise equal")
    return rows


def phase_forward_edges(torch, dev):
    """Phase 9, edges: the bf16 attention forward core (csrc/attention.cu)
    against its plain version on [B=2, H=4, S, Dh] operands at S on both
    sides of its tile and resident-row limits (EDGE_S), every instance's
    head dim and padded ones (EDGE_DH), bf16
    and f32 output, no bias, a key-padding row and a full per-head bias,
    dropout modes 0 (none), 1 (injected bits) and 2 (in-kernel Philox);
    two runs bitwise equal, and in-kernel Philox bitwise equal to the same
    stream injected; and the kernel's occupancy. These launches are
    comparisons, counted on no path."""
    from mdm_tpu_torch.ops import _chain as C
    from mdm_tpu_torch.ops import dropout_bits as DB
    from mdm_tpu_torch.ops.attention import attention_probs

    bf, f32 = torch.bfloat16, torch.float32
    name = lambda dt: str(dt).split(".")[-1]
    occupancy = {f"Dh={dh} out={name(od)} bias={form} {kind}":
                 C.attention_fwd_occupancy(dh, od, form, kind == "resident")
                 for dh in C.HEAD_DIMS for od in (f32, bf) for form in (0, 1, 2)
                 for kind in ("resident", "two-pass")}
    print(f"attention forward occupancy, blocks per SM (bias 0 none, 1 row, 2 full; resident "
          f"row S <= 256 up to Dh 128, two passes above): {json.dumps(occupancy)}")
    B, H, seed = 2, 4, 1357
    rel = TRAIN_REL["bfloat16"]
    g = torch.Generator().manual_seed(11)
    r = lambda *shape: _randn(torch, g, *shape).to(dev)
    ar = lambda n: torch.arange(n, device=dev)
    worst, cases = 0.0, 0
    for Dh in EDGE_DH:
        for S in EDGE_S:
            q, k, v = (r(B, H, S, Dh).to(bf) for _ in range(3))
            view = C.bhsd_view(H, S, Dh)
            injected = torch.randint(0, 2 ** 32, (B, H, S, S), generator=g, dtype=torch.int64)
            injected = injected.to(torch.uint32).to(dev)
            dumped = DB.dropout_bits(seed, B, H, S, device=dev)
            stream = DB.philox_bits(seed, ar(B)[:, None], ar(H)[None, :], S, S, device=dev)
            for bname, bias, strides in (("none", None, (0, 0, 0)),
                                         ("row", r(B, 1, 1, S), (S, 0, 0)),
                                         ("full", r(B, H, S, S), (H * S * S, S * S, S))):
                p = attention_probs(q, k, bias)
                for mode, bits, keep_bits in ((0, None, None), (1, injected, injected),
                                              (2, None, stream)):
                    rate = RATE if mode else 0.0
                    w = p if keep_bits is None else p * DB.keep_factors(keep_bits, RATE)
                    ref = w.to(bf).float() @ v.float()
                    for od in (bf, f32):
                        def run(bits=bits):
                            out = torch.full((B, H, S, Dh), float("nan"), dtype=od, device=dev)
                            C.attention_fwd(q, k, v, view, out, view, B, S, H, Dh, bias, strides,
                                            C.dropout_args(bits, seed, rate))
                            return out
                        out = run()
                        what = f"forward S={S} Dh={Dh} bias={bname} mode={mode} out={name(od)}"
                        worst = max(worst, _rel_check(torch, what, out, ref, rel)[1])
                        if not torch.equal(out, run()):
                            raise AssertionError(f"{what}: two runs differ")
                        if mode == 2 and not torch.equal(out, run(dumped)):
                            raise AssertionError(f"{what}: in-kernel Philox differs from the "
                                                 f"injected dump")
                        cases += 1
    print(f"attention forward at S={list(EDGE_S)}, Dh={list(EDGE_DH)}, B={B} H={H}: "
          f"{cases} cases (bf16/f32 out x 3 bias forms x 3 dropout modes) vs plain, worst "
          f"{worst:.3g} of max |plain| (bound {rel}); two runs and Philox vs injected "
          f"dump bitwise equal")
    return occupancy


def attention_bwd_plain(torch, q, k, v, dout, bias, keep_bits):
    """The attention core's backward on [B, H, S, Dh] operands at its
    rounding points (ops/attention_dropout.py's plain backward, with any
    bias): (dq, dk, dv, the forward's out recomputed), f32."""
    from mdm_tpu_torch.ops import dropout_bits as DB
    from mdm_tpu_torch.ops.attention import attention_probs, attention_scale

    dt = q.dtype
    p = attention_probs(q, k, bias)
    keep = None if keep_bits is None else DB.keep_factors(keep_bits, RATE)
    w = (p if keep is None else p * keep).to(dt).float()
    do = dout.float()
    dp = do @ v.float().transpose(-1, -2)
    if keep is not None:
        dp = keep * dp
    dlog = (p * (dp - (dp * p).sum(dim=-1, keepdim=True)) * attention_scale(q.shape[-1])
            ).to(dt).float()
    return dlog @ k.float(), dlog.transpose(-1, -2) @ q.float(), w.transpose(-1, -2) @ do, \
        (w @ v.float()).to(dt)


def phase_backward_edges(torch, dev):
    """Phase 9, backward edges: the attention core's backward (csrc/
    attention_bwd.cu in bf16, the f32 path in f32) against its plain version
    on [B=2, H=4, S, Dh] operands at S on both sides of its tiles
    (EDGE_S), every instance's head dim and padded ones (EDGE_DH), bf16 and
    f32 inputs, no bias, a key-padding row and a full per-head bias, dropout
    modes 0, 1 and 2: dq, dk, dv, and the recomputed out (ctx) where it is
    asked for (no bias, full bias), within BWD_REL of max |plain|; two runs
    bitwise equal, and in-kernel Philox bitwise equal to the same stream
    injected. These launches are comparisons, counted on no path."""
    from mdm_tpu_torch.ops import _chain as C
    from mdm_tpu_torch.ops import dropout_bits as DB

    bf, f32 = torch.bfloat16, torch.float32
    B, H, seed = 2, 4, 2468
    g = torch.Generator().manual_seed(12)
    r = lambda *shape: _randn(torch, g, *shape).to(dev)
    ar = lambda n: torch.arange(n, device=dev)
    worst, cases, failed = {"bfloat16": 0.0, "float32": 0.0}, 0, []
    for Dh in EDGE_DH:
        for S in EDGE_S:
            view = C.bhsd_view(H, S, Dh)
            injected = torch.randint(0, 2 ** 32, (B, H, S, S), generator=g, dtype=torch.int64)
            injected = injected.to(torch.uint32).to(dev)
            dumped = DB.dropout_bits(seed, B, H, S, device=dev)
            stream = DB.philox_bits(seed, ar(B)[:, None], ar(H)[None, :], S, S, device=dev)
            operands = [r(B, H, S, Dh) for _ in range(4)]
            biases = (("none", None, (0, 0, 0)), ("row", r(B, 1, 1, S), (S, 0, 0)),
                      ("full", r(B, H, S, S), (H * S * S, S * S, S)))
            for dt in (bf, f32):
                q, k, v, do = (t.to(dt) for t in operands)
                dname = str(dt).split(".")[-1]
                for bname, bias, strides in biases:
                    with_ctx = bname != "row"
                    for mode, bits, keep_bits in ((0, None, None), (1, injected, injected),
                                                  (2, None, stream)):
                        rate = RATE if mode else 0.0
                        ref = attention_bwd_plain(torch, q, k, v, do, bias, keep_bits)

                        def run(bits=bits):
                            out = [torch.full_like(q, float("nan")) for _ in range(4)]
                            C.attention_bwd(q, k, v, view, do, view, *out[:3], B, S, H, Dh, bias,
                                            strides, C.dropout_args(bits, seed, rate),
                                            out[3] if with_ctx else None)
                            return out if with_ctx else out[:3]
                        got = run()
                        what = f"backward S={S} Dh={Dh} {dname} bias={bname} mode={mode}"
                        try:
                            for name, a, b in zip(("dq", "dk", "dv", "ctx"), got, ref):
                                if S == 1 and name in ("dq", "dk"):
                                    # One key: the softmax is constant, so dq and dk are
                                    # zero in exact arithmetic; both sides are held
                                    # against zero on dv's scale (as dbk in phase 5).
                                    err = max(_rel_check(torch, f"{what} {name} ({side})", t,
                                                         torch.zeros_like(t), BWD_REL[dname],
                                                         ref[2])[1] for side, t in
                                              (("kernel", a), ("plain", b)))
                                else:
                                    err = _rel_check(torch, f"{what} {name}", a, b,
                                                     BWD_REL[dname])[1]
                                worst[dname] = max(worst[dname], err)
                            if not all(map(torch.equal, got, run())):
                                raise AssertionError(f"{what}: two runs differ")
                            if mode == 2 and not all(map(torch.equal, got, run(dumped))):
                                raise AssertionError(f"{what}: in-kernel Philox differs from the "
                                                     f"injected dump")
                        except AssertionError as e:
                            failed.append(str(e))
                        cases += 1
    if failed:
        raise AssertionError(f"{len(failed)} of {cases} backward edge cases failed:\n"
                             + "\n".join(failed[:30]))
    print(f"attention backward at S={list(EDGE_S)}, Dh={list(EDGE_DH)}, B={B} H={H}: {cases} "
          f"cases (bf16/f32 x 3 bias forms x 3 dropout modes; dq, dk, dv, and ctx with no or a "
          f"full bias) vs plain, worst {json.dumps(worst)} of max |plain| (bounds "
          f"{json.dumps(BWD_REL)}); two runs and Philox vs injected dump bitwise equal")
    return worst


def phase_f32_long_rows(torch, dev):
    """Phase 9, the f32 attention path past the row it once held in 48 KB
    of shared memory (F32_LONG_ROWS: head dims 6144 and 8192 at S = 197, S
    = 13000 at head dim 8; B = H = 1): forward and backward (dq, dk, dv and
    the recomputed out) against the plain versions within BWD_REL's f32
    bound of max |plain|, with no bias and no dropout, and with a key-padding
    row and in-kernel Philox; two runs bitwise equal. Comparisons, counted on
    no path."""
    from mdm_tpu_torch.ops import _chain as C
    from mdm_tpu_torch.ops import dropout_bits as DB
    from mdm_tpu_torch.ops.attention import attention_probs

    B = H = 1
    seed, rel = 8642, BWD_REL["float32"]
    g = torch.Generator().manual_seed(13)
    r = lambda *shape: _randn(torch, g, *shape).to(dev)
    rows = []
    for S, Dh in F32_LONG_ROWS:
        q, k, v, do = (r(B, H, S, Dh) for _ in range(4))
        view = C.bhsd_view(H, S, Dh)
        for bname, bias, strides, mode in (("none", None, (0, 0, 0), 0),
                                           ("row", r(B, 1, 1, S), (S, 0, 0), 2)):
            rate = RATE if mode else 0.0
            drop = C.dropout_args(None, seed, rate)
            keep_bits = DB.philox_bits(seed, 0, 0, S, S, device=dev) if mode else None
            what = f"f32 attention S={S} Dh={Dh} bias={bname} mode={mode}"

            def fwd():
                out = torch.full_like(q, float("nan"))
                C.attention_fwd(q, k, v, view, out, view, B, S, H, Dh, bias, strides, drop)
                return out

            def bwd():
                got = [torch.full_like(q, float("nan")) for _ in range(4)]
                C.attention_bwd(q, k, v, view, do, view, *got[:3], B, S, H, Dh, bias, strides,
                                drop, got[3])
                return got
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fwd()
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            got = bwd()
            torch.cuda.synchronize()
            t2 = time.perf_counter()
            p = attention_probs(q, k, bias)
            w = p if keep_bits is None else p * DB.keep_factors(keep_bits, RATE)
            errs = [_rel_check(torch, f"{what} forward", out, w @ v, rel)[1]]
            del p, w
            ref = attention_bwd_plain(torch, q, k, v, do, bias, keep_bits)
            errs += [_rel_check(torch, f"{what} {n}", a, b, rel)[1]
                     for n, a, b in zip(("dq", "dk", "dv", "ctx"), got, ref)]
            del ref
            if not (torch.equal(out, fwd()) and all(map(torch.equal, got, bwd()))):
                raise AssertionError(f"{what}: two runs differ")
            rows.append(dict(S=S, Dh=Dh, bias=bname, mode=mode, worst=max(errs),
                             fwd_ms=(t1 - t0) * 1e3, bwd_ms=(t2 - t1) * 1e3))
    print(f"f32 attention past the old row limit: {json.dumps(rows)} (worst of max |plain|, "
          f"bound {rel}; host clock around one synchronised call); two runs bitwise equal")
    return rows


def phase_direct_entries(torch, model, dev):
    """Phase 9b: #12 and #10 as direct entry points (no model route calls
    them): each called once per layer of the flagship model, on one
    activation at the CFG batch with the ragged mask. Returns their
    launches."""
    import torch.nn.functional as F
    from mdm_tpu_torch.ops import _chain
    from mdm_tpu_torch.ops import attention as A
    from mdm_tpu_torch.ops import attention_block as AB

    B, S, D, H = (ATTN_SHAPE[k] for k in ("B", "S", "D", "H"))
    x = _randn(torch, torch.Generator().manual_seed(1), B, S, D).to(torch.bfloat16).to(dev)
    _zero(_chain.GEMM_LAUNCHES)
    kpm = _ragged_mask(torch, B, S).to(dev)
    bias = torch.where(kpm, -1e9, 0.0)[:, None, None, :]
    A.LAUNCHES = AB.LAUNCHES = 0
    with torch.no_grad():
        for layer in model.seqTransEncoder.layers:
            a = layer.self_attn
            w, b = a.in_proj_weight.to(x.dtype), a.in_proj_bias.to(x.dtype)
            jax_layout = [t for i in range(3)
                          for t in (w[i * D:(i + 1) * D].T, b[i * D:(i + 1) * D])]
            out = AB.fused_attention_block(x, *jax_layout, a.out_proj.weight.T, a.out_proj.bias,
                                           H, kpm)
            q, k, v = (_heads(t, H) for t in F.linear(x, w, b).chunk(3, dim=-1))
            ctx = A.fused_attention(q, k, v, bias)
            if not (torch.isfinite(out).all() and torch.isfinite(ctx).all()):
                raise AssertionError("a direct entry point gave non-finite values")
    launches = {"fused_attention_block": AB.LAUNCHES, "fused_attention": A.LAUNCHES}
    n = len(model.seqTransEncoder.layers)
    if any(c != n for c in launches.values()):
        raise AssertionError(f"direct entries launched {launches}, expected {n} each")
    if _chain.GEMM_LAUNCHES != {"wgmma": 2 * n, "fma": 0}:  # #12's two projections
        raise AssertionError(f"#12's products launched {_chain.GEMM_LAUNCHES}, expected "
                             f"{2 * n} on the wgmma kernel")
    print(f"direct entries, one call per layer of the flagship model: {launches}")
    return launches


def _generate_launches(torch, gen, cond, B, T, dev):
    """Zero every layer-kernel counter, run one generate, read them."""
    from mdm_tpu_torch.ops import attention_train_block as TB
    from mdm_tpu_torch.ops import attention_v2 as V2
    from mdm_tpu_torch.ops import encoder_tail as ET
    from mdm_tpu_torch.ops import layer_inference as li

    V2.LAUNCHES = li.LAUNCHES = 0
    TB.LAUNCHES["fwd"] = ET.LAUNCHES["fwd"] = 0
    out = gen.generate(cond, B, T, torch.Generator(dev).manual_seed(0))
    torch.cuda.synchronize()
    joints = out["joints"]
    if tuple(joints.shape) != (B, T, 22, 3) or not torch.isfinite(joints).all():
        raise AssertionError(f"bad joints: shape {tuple(joints.shape)}")
    return {"fused_attention_v2": V2.LAUNCHES,
            "fused_block_attention_inference": TB.LAUNCHES["fwd"],
            "fused_encoder_tail_inference": ET.LAUNCHES["fwd"],
            "fused_layer_inference": li.LAUNCHES}


def phase_sampling_variants(torch, dev, layer_s_per_sample):
    """Phase 10: the sampling shootout's pallas variant (v2 attention, #11,
    and the rate-0 fused tail) through MotionGenerator.generate at B=32 x 50
    steps, timed; the block and tail variants at 5 steps; the pallas route
    on the card against the CPU at a small f32 width."""
    from mdm_tpu_torch import ops
    from mdm_tpu_torch.diffusion import Schedule
    from mdm_tpu_torch.models import MDM, Conditioning, MDMConfig
    from mdm_tpu_torch.ops import attention_v2 as V2
    from mdm_tpu_torch.sampling import HashTextEmbedder, MotionGenerator
    from mdm_tpu_torch.scripts import bench_sample_kernels as BS

    B, T, steps = 32, 196, 50
    layers = BS.FLAGSHIP.num_layers
    with ops.pinned(**BS.VARIANTS["pallas"]):
        gen, cond = BS.make_generator(B, steps, device=dev)
        launches = _generate_launches(torch, gen, cond, B, T, dev)
        want = {"fused_attention_v2": layers * steps, "fused_block_attention_inference": 0,
                "fused_encoder_tail_inference": layers * steps, "fused_layer_inference": 0}
        if launches != want:
            raise AssertionError(f"pallas generate launched {launches}, expected {want}")
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        gen.generate(cond, B, T, torch.Generator(dev).manual_seed(1))
        end.record()
        torch.cuda.synchronize()
        s_per_sample = start.elapsed_time(end) / 1000 / B
    print(f"generate pallas variant B={B} T={T} steps={steps} cfg=2.5 bf16: "
          f"{s_per_sample:.6f} s/sample beside the layer kernel's {layer_s_per_sample:.6f} "
          f"(phase 3); launches {launches}")

    few = 5
    for variant, tail in (("block", 0), ("tail", layers * few)):
        with ops.pinned(**BS.VARIANTS[variant]):
            gen, cond = BS.make_generator(B, few, device=dev)
            got = _generate_launches(torch, gen, cond, B, T, dev)
        want = {"fused_attention_v2": 0, "fused_block_attention_inference": layers * few,
                "fused_encoder_tail_inference": tail, "fused_layer_inference": 0}
        if got != want:
            raise AssertionError(f"{variant} generate launched {got}, expected {want}")
        print(f"generate {variant} variant, {few} steps: launches {got}")

    small = MDMConfig(latent_dim=128, ff_size=256, num_layers=2, num_heads=4)
    rng = np.random.default_rng(0)
    noise = torch.from_numpy(rng.normal(size=(2, 32, 263)).astype(np.float32))
    step_noise = torch.from_numpy(rng.normal(size=(5, 2, 32, 263)).astype(np.float32))
    cond = Conditioning(text_embed=torch.from_numpy(HashTextEmbedder()(
        ["a person walks forward", "a person jumps"])["text_embed"]))
    V2.LAUNCHES = 0
    with ops.pinned(**BS.VARIANTS["pallas"]):
        outs = [MotionGenerator(MDM(small).init_weights(torch.Generator().manual_seed(1)).to(d),
                                Schedule.create("cosine", 1000, "5"))
                .generate(cond, 2, 32, noise=noise, step_noise=step_noise)
                for d in ("cpu", dev)]
    if V2.LAUNCHES != small.num_layers * 5:  # the card's side only
        raise AssertionError(f"the small pallas generate launched #11 {V2.LAUNCHES} times")
    for key, tol in (("features", 1e-4), ("joints", 1e-3)):
        err = (outs[0][key] - outs[1][key].cpu()).abs().max().item()
        print(f"pallas route f32 card vs cpu: {key} max abs err {err:.3g} (tolerance {tol})")
        if not err <= tol:
            raise AssertionError(f"pallas route on the card disagrees with the CPU: {key} {err}")
    return launches["fused_attention_v2"], s_per_sample


def phase_train_drop(torch, dev, tail_step_ms):
    """Phase 11: the training shootout's drop variant (the dropout attention
    kernel #7/#8 between the projections, the plain tail with its masks from
    the tail dump #6) at the flagship: 30 steps, the loss falls, timed;
    then one whole train step of the route on the card against the CPU at a
    small f32 width; then 3 steps of the xla variant, whose attention takes
    its masks from the attention dump #9."""
    from mdm_tpu_torch import ops
    from mdm_tpu_torch.ops import attention_dropout as AD
    from mdm_tpu_torch.ops import attention_train_block as TB
    from mdm_tpu_torch.ops import dropout_bits as DB
    from mdm_tpu_torch.ops import encoder_tail as ET
    from mdm_tpu_torch.scripts import bench_train_kernels as BT
    from mdm_tpu_torch.train import step_key

    B, steps = 128, 30
    layers = BT.FLAGSHIP.num_layers
    with ops.pinned(**BT.VARIANTS["drop"]):
        state, step, batch = BT.make_trainer(B, dev, lr=1e-3)
        AD.LAUNCHES.update(fwd=0, bwd=0)
        DB.LAUNCHES.update(dropout_bits=0, tail_dropout_bits=0)
        for counts in (TB.LAUNCHES, ET.LAUNCHES):
            counts["fwd"] = counts["bwd"] = 0
        losses = []
        for i in range(steps):
            _, m = step(state, batch, step_key(0, i))
            losses.append(m["loss"])
        losses = torch.stack(losses).cpu().numpy()
        # The plain tail takes its three masks from one tail_dropout_bits
        # launch a layer (#6); the dropout attention kernel draws its own.
        launches = {f"fused_dropout_attention.{d}": AD.LAUNCHES[d] for d in ("fwd", "bwd")}
        launches["tail_dropout_bits"] = DB.LAUNCHES["tail_dropout_bits"]
        others = [TB.LAUNCHES[d] + ET.LAUNCHES[d] for d in ("fwd", "bwd")]
        others.append(DB.LAUNCHES["dropout_bits"])
        if any(c != layers * steps for c in launches.values()) or any(others):
            raise AssertionError(f"drop training launched {launches}, block+tail and "
                                 f"dropout_bits {others}; expected {layers * steps} each and none")
        first, last = losses[:10].mean(), losses[-10:].mean()
        print(f"flagship train drop variant B={B} bf16 dropout {RATE}, lr 1e-3: loss first 10 "
              f"{first:.5f}, last 10 {last:.5f}; launches {launches}")
        if not (np.isfinite(losses).all() and last < first):
            raise AssertionError(f"the drop variant's loss did not descend: {losses}")
        for i in range(5):
            step(state, batch, step_key(1, i))
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for i in range(20):
            step(state, batch, step_key(1, 5 + i))
        end.record()
        torch.cuda.synchronize()
        step_ms = start.elapsed_time(end) / 20
    print(f"train_step_ms_b128_bf16 drop variant: {step_ms:.3f} ms/step beside the AUTO "
          f"route's {tail_step_ms:.3f} (phase 8; CUDA events, 20 steps after 5 warm)")

    # One whole f32 step of the drop route, card against CPU.
    AD.LAUNCHES.update(fwd=0, bwd=0)
    with ops.pinned(**BT.VARIANTS["drop"]):
        phase_step_card_vs_cpu(torch, dev, steps=1, dropout=RATE, route="drop route")
    if AD.LAUNCHES != {"fwd": 2, "bwd": 2}:  # two layers, the card's side only
        raise AssertionError(f"the small drop step launched #7/#8 {AD.LAUNCHES}")

    # The xla variant (einsum attention, the plain tail) for a few steps:
    # its attention takes its mask from one dropout_bits launch a layer (#9).
    few = 3
    with ops.pinned(**BT.VARIANTS["xla"]):
        state, step, batch = BT.make_trainer(B, dev, lr=1e-3)
        DB.LAUNCHES.update(dropout_bits=0, tail_dropout_bits=0)
        for i in range(few):
            _, m = step(state, batch, step_key(0, i))
        loss = m["loss"].item()
    xla = {k: DB.LAUNCHES[k] for k in ("dropout_bits", "tail_dropout_bits")}
    if any(c != layers * few for c in xla.values()) or not np.isfinite(loss):
        raise AssertionError(f"xla training launched the dumps {xla} (expected {layers * few} "
                             f"each), loss {loss}")
    print(f"flagship train xla variant B={B}, {few} steps: dump launches {xla}, loss {loss:.5f}")
    launches["dropout_bits"] = xla["dropout_bits"]
    return launches, step_ms


def _decoder_operands(torch, B, S, dtype, dev, seed=0):
    """A DiP decoder layer's inputs: frames [B, S, D], a 64-token memory, a
    ragged frame padding and a ragged token padding (True = ignore)."""
    from mdm_tpu_torch.scripts import dip_probe as DP

    D = FLAGSHIP["latent_dim"]
    g = torch.Generator().manual_seed(seed)
    tgt, memory = (_randn(torch, g, B, n, D).to(dev, dtype) for n in (S, DP.TOKENS))
    tokens = 1 + (13 * torch.arange(B)) % DP.TOKENS
    token_pad = torch.arange(DP.TOKENS)[None] >= tokens[:, None]
    return tgt, memory, _ragged_mask(torch, B, S).to(dev), token_pad.to(dev)


def phase_decoder_layer(torch, dev):
    """Phase 13a: one DiP decoder layer, its kernel route (AUTO: the rate-0
    block #2 for the self-attention, the rate-0 tail #4 for the
    cross-attention -> FFN half) against its plain route (the einsum
    attention and the plain tail, all products cuBLAS), at CFG batch 64 and
    2 and S = 60 (prefix + chunk) and 61 (with emb_trans_dec's token),
    bf16, and one f32 case; then the two rate-0 entries alone at the main
    shape against their plain versions, timed, for the kernels line."""
    from mdm_tpu_torch import ops
    from mdm_tpu_torch.models import layers as tl
    from mdm_tpu_torch.ops import attention_train_block as TB
    from mdm_tpu_torch.ops import encoder_tail as ET
    from mdm_tpu_torch.scripts import dip_probe as DP

    D, F, H = FLAGSHIP["latent_dim"], FLAGSHIP["ff_size"], FLAGSHIP["num_heads"]
    S = DP.DIP.context_len + DP.DIP.pred_len
    layers = {}
    for dtype in (torch.bfloat16, torch.float32):
        layer = tl.TransformerDecoderLayer(D, H, F, dtype)
        tl.init_weights_(layer, torch.Generator().manual_seed(0))
        layers[dtype] = layer.to(dev).eval()
    rows = []
    for B, s, dtype in ((64, S, torch.bfloat16), (64, S + 1, torch.bfloat16),
                        (2, S, torch.bfloat16), (2, S + 1, torch.bfloat16),
                        (2, S + 1, torch.float32)):
        layer = layers[dtype]
        tgt, memory, pad, token_pad = _decoder_operands(torch, B, s, dtype, dev)
        args = (tgt, memory, tl.key_padding_bias(pad), tl.key_padding_bias(token_pad))
        kernel = lambda: layer(*args)

        def plain():
            with ops.pinned(sample_block=False, encoder_tail=False):
                return layer(*args)

        with torch.no_grad():
            before = (TB.LAUNCHES["fwd"], ET.LAUNCHES["fwd"])
            out = kernel()
            if (TB.LAUNCHES["fwd"] - before[0], ET.LAUNCHES["fwd"] - before[1]) != (1, 1):
                raise AssertionError("the decoder layer's kernel route missed the rate-0 block "
                                     "or tail")
            torch.cuda.synchronize()
            ref = plain()
            err = (out.float() - ref.float()).abs().max().item()
            tol = BF16_TOL if dtype == torch.bfloat16 else F32_TOL
            if not torch.isfinite(out).all() or not torch.allclose(out.float(), ref.float(), **tol):
                raise AssertionError(f"decoder layer kernel route disagrees with its plain route: "
                                     f"max abs err {err} (tolerance {tol}) at B={B} S={s} {dtype}")
            row = dict(B=B, S=s, dtype=str(dtype).split(".")[-1], max_abs_err=err, tol=tol)
            if B == 64 and s == S:
                p1, k1, k2, p2 = (_time_ms(torch, f) for f in (plain, kernel, kernel, plain))
                row.update(ms=(k1 + k2) / 2, plain_ms=(p1 + p2) / 2)
        rows.append(row)
        print("decoder layer", json.dumps(row))

    # The rate-0 entries alone at the main shape: CFG batch 64, S = 60, bf16,
    # the key-padding row as the decoder's self-attention passes it.
    layer, B = layers[torch.bfloat16], 64
    tgt, memory, pad, token_pad = _decoder_operands(torch, B, S, torch.bfloat16, dev, seed=1)
    a = layer.self_attn
    block_w = [w.detach().to(torch.bfloat16) for w in (a.in_proj_weight, a.in_proj_bias,
                                                       a.out_proj.weight, a.out_proj.bias)]
    kpm = tl._row_bias(tl.key_padding_bias(pad), S)
    entries = {}
    row = compare_forward(
        torch, "fused_block_attention_inference",
        lambda: TB.fused_block_attention_inference(tgt, *block_w, H, key_padding_mask=kpm),
        lambda: TB.train_attention_block_reference(tgt, *block_w, H, key_padding_mask=kpm),
        TRAIN_REL["bfloat16"], timed=True)
    mha = _torch_mha(torch, *block_w, H, 0.0).eval()
    M = B * S
    entries["fused_block_attention_inference"] = dict(
        row, library_ms=_no_grad_ms(torch, lambda: mha(tgt, tgt, tgt, key_padding_mask=pad,
                                                       need_weights=False)[0]),
        **dict(zip(("bound_ms", "bound_by"),
                   bound(8 * M * D * D + 4 * B * S * S * D, nbytes(tgt, *block_w, kpm, tgt)))))
    tail_w = [p.detach().to(torch.bfloat16) for p in (
        layer.norm2.weight, layer.norm2.bias, layer.linear1.weight, layer.linear1.bias,
        layer.linear2.weight, layer.linear2.bias, layer.norm3.weight, layer.norm3.bias)]
    cross = _decoder_operands(torch, B, S, torch.bfloat16, dev, seed=2)[0]  # the cross-attention
    row = compare_forward(
        torch, "fused_encoder_tail_inference",
        lambda: ET.fused_encoder_tail_inference(tgt, cross, *tail_w),
        lambda: ET.encoder_tail_reference(tgt, cross, *tail_w), TRAIN_REL["bfloat16"],
        timed=True)
    entries["fused_encoder_tail_inference"] = dict(
        row, library_ms=None,
        **dict(zip(("bound_ms", "bound_by"),
                   bound(4 * M * D * F, nbytes(tgt, cross, *tail_w, tgt)))))
    return rows, entries


def phase_dip_generate(torch, dev):
    """Phase 13b: MotionGenerator.generate on the DiP config
    (scripts/dip_probe.py: flagship width, bf16, random weights from a seed,
    ddpm), autoregressive over 5 chunks, at B = 1 and 32. Each decoder layer
    call must launch the rate-0 block and the rate-0 tail once (5 chunks x
    10 steps x 8 layers = 400 each a generate), every product of theirs on
    the wgmma kernel. Then each batch once more, timed with CUDA events.
    Returns the generator, the conditionings, the launches of the counted
    runs and the times."""
    from mdm_tpu_torch.ops import _chain
    from mdm_tpu_torch.ops import attention_train_block as TB
    from mdm_tpu_torch.ops import encoder_tail as ET
    from mdm_tpu_torch.ops import layer_inference as li
    from mdm_tpu_torch.scripts import dip_probe as DP

    gen = DP.make_generator(dev)
    model, frames = gen.model, DP.FRAMES
    chunks = -(-frames // DP.DIP.pred_len)
    per_run = chunks * DP.STEPS * DP.DIP.num_layers
    calls = [0]
    hooks = [layer.register_forward_hook(lambda *_: calls.__setitem__(0, calls[0] + 1))
             for layer in model.seqTransDecoder.layers]
    conds = {B: DP.make_cond(B, dev, seed=B) for B in (1, 32)}
    TB.LAUNCHES["fwd"] = ET.LAUNCHES["fwd"] = li.LAUNCHES = 0  # the DiP path's counts from here
    _zero(_chain.GEMM_LAUNCHES)
    for n, (B, cond) in enumerate(conds.items(), 1):
        out = gen.generate(cond, B, frames, torch.Generator(dev).manual_seed(0))
        torch.cuda.synchronize()
        got = (TB.LAUNCHES["fwd"], ET.LAUNCHES["fwd"], calls[0])
        if got != (n * per_run,) * 3 or li.LAUNCHES:
            raise AssertionError(f"DiP generate B={B}: (rate-0 block, rate-0 tail, decoder layer "
                                 f"calls) = {got}, whole-layer kernel {li.LAUNCHES}; expected "
                                 f"{n * per_run} each and none of the whole-layer kernel")
        if _chain.GEMM_LAUNCHES != {"wgmma": 4 * n * per_run, "fma": 0}:
            raise AssertionError(f"DiP generate's block and tail products launched "
                                 f"{_chain.GEMM_LAUNCHES}, expected {4 * n * per_run} on wgmma")
        joints = out["joints"]
        if (tuple(out["features"].shape) != (B, frames, 263)
                or tuple(joints.shape) != (B, frames, 22, 3)
                or not torch.isfinite(joints).all()):
            raise AssertionError(f"DiP generate B={B}: features {tuple(out['features'].shape)}, "
                                 f"joints {tuple(joints.shape)}, finite "
                                 f"{bool(torch.isfinite(joints).all())}")
    for hook in hooks:
        hook.remove()
    launches = {"fused_block_attention_inference": TB.LAUNCHES["fwd"],
                "fused_encoder_tail_inference": ET.LAUNCHES["fwd"]}
    times = {}
    for B, cond in conds.items():
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        gen.generate(cond, B, frames, torch.Generator(dev).manual_seed(1))
        end.record()
        torch.cuda.synchronize()
        times[B] = start.elapsed_time(end)
        print(f"DiP generate B={B} {frames} frames ({chunks} chunks x {DP.STEPS} ddpm steps, "
              f"CFG {DP.GUIDANCE}, bf16): {times[B]:.1f} ms/batch, "
              f"{times[B] / 1000 / B:.6f} s/sample (CUDA events, after one counted call)")
    print(f"DiP generate launches over B=1 and B=32: {launches}, decoder layer calls {calls[0]}, "
          f"products on wgmma {_chain.GEMM_LAUNCHES['wgmma']}")
    return gen, conds, launches, times


def phase_samplers(torch, gen50, cond, dev):
    """Phase 13c: one generate each with sampler ddim, plms and dpmpp_2m at
    10 steps, and one with cached CFG at interval 2 (ddpm, 10 steps), on
    the flagship trans_enc at B = 32: finite joints, and every layer call on
    the whole-layer kernel (8 launches per model forward, counted by a
    hook on the model; exact CFG is one double-batched forward)."""
    from mdm_tpu_torch.diffusion import Schedule
    from mdm_tpu_torch.ops import layer_inference as li
    from mdm_tpu_torch.sampling import GenerationConfig, MotionGenerator

    model, steps = gen50.model, 10
    B, T = cond.text_embed.shape[0], cond.frames_mask.shape[1]
    forwards = [0]
    hook = model.register_forward_hook(lambda *_: forwards.__setitem__(0, forwards[0] + 1))
    cases = {  # name -> (GenerationConfig fields, model forwards a generate)
        "ddim": (dict(sampler="ddim"), steps),
        "plms": (dict(sampler="plms"), steps + 1),  # the first step evaluates twice
        "dpmpp_2m": (dict(sampler="dpmpp_2m"), steps),
        "cached CFG k=2 (ddpm)": (dict(cfg_cache_interval=2), steps + steps // 2),
    }
    rows = {}
    for name, (fields, want) in cases.items():
        gen = MotionGenerator(model, Schedule.create("cosine", 1000, str(steps)),
                              GenerationConfig(guidance_scale=2.5, **fields))
        forwards[0] = li.LAUNCHES = 0
        out = gen.generate(cond, B, T, torch.Generator(dev).manual_seed(0))
        torch.cuda.synchronize()
        if forwards[0] != want or li.LAUNCHES != model.config.num_layers * want:
            hook.remove()
            raise AssertionError(f"{name}: {forwards[0]} model forwards, {li.LAUNCHES} layer "
                                 f"kernel launches; expected {want} and "
                                 f"{model.config.num_layers * want}")
        if not torch.isfinite(out["joints"]).all():
            hook.remove()
            raise AssertionError(f"{name}: joints not finite")
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        gen.generate(cond, B, T, torch.Generator(dev).manual_seed(1))
        end.record()
        torch.cuda.synchronize()
        ms = start.elapsed_time(end)
        rows[name] = dict(forwards=want, layer_launches=model.config.num_layers * want,
                          ms_per_batch=ms, s_per_sample=ms / 1000 / B)
        print(f"generate {name}, B={B} T={T}, {steps} steps, CFG 2.5, bf16: {ms:.1f} ms/batch, "
              f"{ms / 1000 / B:.6f} s/sample (CUDA events, after one counted call); {want} "
              f"forwards, {model.config.num_layers * want} layer kernel launches")
    hook.remove()
    return rows


# Phase 14: training every denoiser the JAX package trains. DiP at
# scripts/dip_probe.py's config, dropout 0.1, B = 64 (the parser's default
# batch); the flagship trans_enc with and without remat; HumanAct12's
# action-to-motion shape (25 joints x 6 rot6d features, 12 actions, 60
# frames) on trans_enc and on the GRU. The small f32 cases (card against
# CPU) take phase 7's width: DiP with a 10-frame prefix and 16 text tokens
# (Sq = 42 against Sk = 16), a2m at 25 x 6 features.
DIP_TRAIN_B = 64
A2M = dict(njoints=25, nfeats=6, data_rep="rot6d", cond_mode="action", num_actions=12)
A2M_B, A2M_T = 64, 60
SMALL_DIP = dict(arch="trans_dec", text_dim=768, text_tokens=True, mask_frames=True,
                 context_len=10, pred_len=32)
SMALL_TOKENS = 16


def _step_draws(torch, rng, B, T, feats):
    return {"t": torch.from_numpy(rng.integers(0, 1000, B)),
            "noise": torch.from_numpy(rng.normal(size=(B, T, feats)).astype(np.float32)),
            "cond_drop": torch.from_numpy(np.arange(B) % 4 == 1)}


def _dip_case(torch, rng, B, T):
    """A small DiP batch: ragged frame and token masks, the prefix in the
    conditioning (as the CLI puts it), and its draws."""
    from mdm_tpu_torch.models import Conditioning

    L, ctx = SMALL_TOKENS, SMALL_DIP["context_len"]
    mask = np.ones((B, T), bool)
    mask[::2, T - 7:] = False
    cond = Conditioning(
        text_embed=torch.from_numpy(rng.normal(size=(B, L, 768)).astype(np.float32)),
        text_tokens_mask=torch.from_numpy(np.arange(L)[None] < (1 + 5 * np.arange(B))[:, None]),
        prefix=torch.from_numpy(rng.normal(size=(B, ctx, 263)).astype(np.float32)))
    batch = {"x": torch.from_numpy(rng.normal(size=(B, T, 263)).astype(np.float32)),
             "mask": torch.from_numpy(mask), "cond": cond}
    return batch, _step_draws(torch, rng, B, T, 263)


def _goal_case(torch, rng, B, T):
    """The DiP batch with sampled goals (validity only: the step extracts
    the targets) and an injected target condition dropout."""
    from mdm_tpu_torch.core.goals import sample_goal

    batch, draws = _dip_case(torch, rng, B, T)
    validity, _ = sample_goal(B, rng)
    batch["cond"] = batch["cond"].replace(target_validity=torch.from_numpy(validity))
    draws["target_uncond"] = torch.from_numpy(np.arange(B) % 4 == 2)
    return batch, draws


def _a2m_case(torch, rng, B, T):
    from mdm_tpu_torch.models import Conditioning

    feats = A2M["njoints"] * A2M["nfeats"]
    batch = {"x": torch.from_numpy(rng.normal(size=(B, T, feats)).astype(np.float32)),
             "mask": torch.ones(B, T, dtype=torch.bool),
             "cond": Conditioning(action=torch.from_numpy(rng.integers(0, 12, B)))}
    return batch, _step_draws(torch, rng, B, T, feats)


def _run_steps(torch, step, state, batch, keys):
    """The steps under ``keys``, timed with CUDA events: (ms per step,
    the losses on the host)."""
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    losses = []
    start.record()
    for key in keys:
        losses.append(step(state, batch, key)[1]["loss"])
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / len(keys), torch.stack(losses).float().cpu().numpy()


def _falls(name, losses):
    first, last = losses[:10].mean(), losses[-10:].mean()
    if not (np.isfinite(losses).all() and last < first):
        raise AssertionError(f"{name}: the training loss did not descend: {losses}")
    return float(first), float(last)


def _train_counts(TB, ET, DB, chain):
    return {**{f"{n}.{d}": c[d] for n, c in (("fused_train_attention_block", TB.LAUNCHES),
                                              ("fused_encoder_tail", ET.LAUNCHES))
               for d in ("fwd", "bwd")},
            **DB.LAUNCHES, **{f"products.{k}": v for k, v in chain.GEMM_LAUNCHES.items()}}


def _dip_train_setup(torch, dev, lr):
    """The main path's model, train state, fixed batch and step: the DiP
    config at B = 64, weights from seed 0."""
    from mdm_tpu_torch.diffusion import Schedule
    from mdm_tpu_torch.models import MDM
    from mdm_tpu_torch.scripts import dip_probe as DP
    from mdm_tpu_torch.train import (OptimConfig, TrainStepConfig, create_train_state,
                                     make_train_step)

    B, cfg = DIP_TRAIN_B, DP.DIP
    model = MDM(cfg).init_weights(torch.Generator().manual_seed(0)).to(dev)
    cond = DP.make_cond(B, dev, seed=5)
    x = np.random.default_rng(1).normal(size=(B, cfg.pred_len, cfg.input_feats))
    batch = {"x": torch.from_numpy(x.astype(np.float32)).to(dev), "mask": cond.frames_mask,
             "cond": cond}
    step = make_train_step(Schedule.create("cosine", 1000).to(dev),
                           TrainStepConfig(optim=OptimConfig(lr=lr)))
    return create_train_state(model, OptimConfig(lr=lr)), batch, step


def _flagship_train_setup(torch, dev, B, remat):
    """The flagship trans_enc (T = 196, bf16, rate 0.1) at batch B, with or
    without remat: train state, batch and step, weights from seed 0."""
    from mdm_tpu_torch.diffusion import Schedule
    from mdm_tpu_torch.models import MDM, Conditioning, MDMConfig
    from mdm_tpu_torch.train import (OptimConfig, TrainStepConfig, create_train_state,
                                     make_train_step)

    T = 196
    x = np.random.default_rng(B).normal(size=(B, T, 263)).astype(np.float32)
    batch = {"x": torch.from_numpy(x).to(dev),
             "mask": torch.ones(B, T, dtype=torch.bool, device=dev),
             "cond": Conditioning(text_embed=torch.zeros(B, 512, device=dev))}
    cfg = MDMConfig(njoints=263, compute_dtype="bfloat16", dropout=RATE, remat=remat, **FLAGSHIP)
    state = create_train_state(MDM(cfg).init_weights(torch.Generator().manual_seed(0)).to(dev),
                               OptimConfig(lr=1e-4))
    step = make_train_step(Schedule.create("cosine", 1000).to(dev),
                           TrainStepConfig(optim=OptimConfig(lr=1e-4)))
    return state, batch, step


def phase_dip_train(torch, dev):
    """Phase 14a, this slice's main path: make_train_step on the DiP config
    at B = 64, bf16, dropout 0.1, AUTO, 30 steps on a fixed batch: the loss
    falls; per step and decoder layer the train block (#2/#3) and the tail
    (#4/#5) once each, the cross-attention's [64, 4, 60, 64] dump (#9) once,
    the attn-out sequence dump once (with MDM's own, 1 + 8 dumps of #6's
    kernel a step), the 12 block and tail products on wgmma. Then the path's
    kernels at its own shapes against their plain versions (not counted):
    the bf16 train block and tail, forward and every gradient, at [64, 60,
    512] with DiP's ragged key-padding row; the attn-out [64, 60, 512] and
    cross-attention [64, 4, 60, 64] dumps bitwise against the Philox
    stream. Then ms/step (CUDA events, 20 steps after 5 warm), and one
    whole f32 step at rate 0.1 card against CPU under AUTO and under the
    xla pin (the einsum attention and the plain tail on the card, the
    rectangular dump too)."""
    from mdm_tpu_torch import ops
    from mdm_tpu_torch.models.layers import key_padding_bias
    from mdm_tpu_torch.ops import _chain
    from mdm_tpu_torch.ops import attention_train_block as TB
    from mdm_tpu_torch.ops import dropout_bits as DB
    from mdm_tpu_torch.ops import encoder_tail as ET
    from mdm_tpu_torch.scripts import bench_train_kernels as BT
    from mdm_tpu_torch.scripts import dip_probe as DP
    from mdm_tpu_torch.train import step_key

    B, steps, cfg = DIP_TRAIN_B, 30, DP.DIP
    if cfg.dropout != RATE:
        raise AssertionError(f"DiP's dropout is {cfg.dropout}, not {RATE}")
    state, batch, fit = _dip_train_setup(torch, dev, 1e-3)
    for counts in (TB.LAUNCHES, ET.LAUNCHES, DB.LAUNCHES, _chain.GEMM_LAUNCHES):  # the path's
        _zero(counts)
    _, losses = _run_steps(torch, fit, state, batch, [step_key(2, i) for i in range(steps)])
    launches = _train_counts(TB, ET, DB, _chain)
    n = cfg.num_layers * steps
    want = {"fused_train_attention_block.fwd": n, "fused_train_attention_block.bwd": n,
            "fused_encoder_tail.fwd": n, "fused_encoder_tail.bwd": n, "dropout_bits": n,
            "tail_dropout_bits": 0, "sequence_dropout_bits": n + steps,
            "products.wgmma": 12 * n, "products.fma": 0}
    if launches != want:
        raise AssertionError(f"DiP training launched {launches}, expected {want}")
    first, last = _falls("DiP training", losses)
    print(f"DiP train B={B} ({cfg.context_len}-frame prefix + {cfg.pred_len} frames, "
          f"{DP.TOKENS} tokens) bf16 dropout {RATE}, lr 1e-3, {steps} steps: loss first 10 "
          f"{first:.5f}, last 10 {last:.5f}; launches {launches} (per step: 8 of each block and "
          f"tail direction, 8 cross-attention dumps [{B}, {cfg.num_heads}, "
          f"{cfg.context_len + cfg.pred_len}, {DP.TOKENS}], 9 sequence dumps, 96 wgmma products)")

    # The path's kernels at its own shapes against their plain versions
    # (not counted): the train block and tail at [64, 60, 512] (S below the
    # 64-row tile), the block under DiP's own ragged key-padding row (the
    # 20 prefix frames always kept, the frame mask's padding dropped), as
    # the decoder's self-attention gets it.
    H, S, L = cfg.num_heads, cfg.context_len + cfg.pred_len, DP.TOKENS
    frames = batch["cond"].frames_mask
    valid = torch.cat([torch.ones(B, cfg.context_len, dtype=torch.bool, device=dev), frames], 1)
    phase_train_kernels(torch, TB, ET, dict(B=B, S=S, D=cfg.latent_dim, H=H, F=cfg.ff_size),
                        torch.bfloat16, key_padding_bias(~valid).reshape(B, S), timed=False)
    # The attn-out and the cross-attention's rectangular dumps at the main
    # path's shapes, bitwise against the Philox stream; the latter timed.
    b = torch.arange(B, device=dev)
    seq = DB.sequence_dropout_bits(76, B, S, cfg.latent_dim, device=dev)
    if not torch.equal(seq.to(torch.int64), DB.philox_bits(76, b, 0, S, cfg.latent_dim,
                                                           device=dev)):
        raise AssertionError(f"the [{B}, {S}, {cfg.latent_dim}] sequence dump differs from the "
                             f"Philox stream")
    dump = lambda: DB.dropout_bits(77, B, H, S, device=dev, key_len=L)
    want = DB.philox_bits(77, b[:, None], torch.arange(H, device=dev)[None, :], S, L, device=dev)
    if not torch.equal(dump().to(torch.int64), want):
        raise AssertionError(f"the [{B}, {H}, {S}, {L}] dump differs from the Philox stream")
    dump_ms = _time_ms(torch, dump)
    print(f"sequence_dropout_bits [{B}, {S}, {cfg.latent_dim}] (DiP's attn-out): == philox_bits, "
          f"bitwise; dropout_bits [{B}, {H}, {S}, {L}] (DiP's cross-attention): == philox_bits, "
          f"bitwise; {dump_ms:.4f} ms, byte bound {bound(0, 4 * B * H * S * L)[0]:.4f}")

    _run_steps(torch, fit, state, batch, [step_key(3, i) for i in range(5)])
    torch.cuda.reset_peak_memory_stats()
    step_ms, _ = _run_steps(torch, fit, state, batch, [step_key(3, 5 + i) for i in range(20)])
    print(f"dip_train_step_ms_b{B}_bf16: {step_ms:.3f} ms/step (CUDA events, 20 steps after 5 "
          f"warm; peak {torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB)")
    del state

    # One whole f32 step, card against CPU: the card's side (2 layers) draws
    # the cross-attention's dump once a layer, and under xla the
    # self-attention's too, and the plain tail's.
    for route, pins, dumps in (("AUTO route", {}, dict(dropout_bits=2, tail_dropout_bits=0)),
                               ("xla route", BT.VARIANTS["xla"],
                                dict(dropout_bits=4, tail_dropout_bits=2))):
        _zero(DB.LAUNCHES)
        with ops.pinned(**pins):
            phase_step_card_vs_cpu(torch, dev, steps=1, dropout=RATE, route=f"DiP {route}",
                                   model_kw=SMALL_DIP, case=_dip_case)
        dumps["sequence_dropout_bits"] = 3  # MDM's and each layer's attn-out
        if DB.LAUNCHES != dumps:
            raise AssertionError(f"the small DiP step ({route}) dumped {DB.LAUNCHES}, "
                                 f"expected {dumps}")
    return launches, step_ms


def phase_remat(torch, dev):
    """Phase 14b: the flagship trans_enc (T = 196, bf16, rate 0.1, AUTO)
    with and without remat. At B = 128 one step of each from the same
    weights, batch and key: the parameters and EMA after it bitwise equal.
    At B = 128 and 512: the train block's forward launched once a layer
    in a step without remat and twice with it (the recompute); ms/step
    (CUDA events, 5 steps after 2 warm) and the peak memory over those
    steps."""
    from mdm_tpu_torch.ops import attention_train_block as TB
    from mdm_tpu_torch.train import step_key

    rows, after = [], {}
    for B in (128, 512):
        for remat in (False, True):
            state, batch, step = _flagship_train_setup(torch, dev, B, remat)
            fwd0 = TB.LAUNCHES["fwd"]
            step(state, batch, step_key(4, 0))
            fwd = TB.LAUNCHES["fwd"] - fwd0
            if fwd != (2 if remat else 1) * FLAGSHIP["num_layers"]:
                raise AssertionError(f"remat={remat} B={B}: the train block's forward ran {fwd} "
                                     f"times in a step of {FLAGSHIP['num_layers']} layers")
            if B == 128:
                after[remat] = ({k: v.detach().clone() for k, v in state.params().items()},
                                {k: v.clone() for k, v in state.ema_params.items()})
            _run_steps(torch, step, state, batch, [step_key(4, 1 + i) for i in range(2)])
            torch.cuda.reset_peak_memory_stats()
            ms, losses = _run_steps(torch, step, state, batch,
                                    [step_key(4, 3 + i) for i in range(5)])
            if not np.isfinite(losses).all():
                raise AssertionError(f"remat={remat} B={B}: non-finite loss {losses}")
            rows.append(dict(B=B, remat=remat, ms_per_step=ms, block_fwd_launches_per_step=fwd,
                             peak_gib=torch.cuda.max_memory_allocated() / 2 ** 30))
            print("remat", json.dumps(rows[-1]))
            del state
            torch.cuda.empty_cache()
        if B == 128:
            same = all(torch.equal(after[False][i][k], after[True][i][k])
                       for i in (0, 1) for k in after[False][0])
            if not same:
                raise AssertionError("a remat step differs from the step without it")
            print("remat step == step without remat at B=128, bitwise (parameters and EMA)")
    return rows


def phase_a2m(torch, dev):
    """Phase 14c: HumanAct12's action-to-motion shape at the flagship width
    (trans_enc, action, rot6d, 60 frames, B = 64, bf16, rate 0.1, AUTO):
    25 steps, the loss falls, the last 20 timed; the train block and tail
    launched per layer and step, MDM's sequence dump once a step. Then the
    GRU (f32, as mdm_tpu runs it) for 3 steps after a warm one, timed; one
    f32 step of each, card against CPU; and a 50-step CFG sample_features
    at B = 32, timed, every layer call on the whole-layer kernel (#1)."""
    from mdm_tpu_torch.diffusion import Schedule
    from mdm_tpu_torch.models import MDM, Conditioning, MDMConfig
    from mdm_tpu_torch.ops import _chain
    from mdm_tpu_torch.ops import attention_train_block as TB
    from mdm_tpu_torch.ops import dropout_bits as DB
    from mdm_tpu_torch.ops import encoder_tail as ET
    from mdm_tpu_torch.ops import layer_inference as li
    from mdm_tpu_torch.sampling import GenerationConfig, MotionGenerator
    from mdm_tpu_torch.train import (OptimConfig, TrainStepConfig, create_train_state,
                                     make_train_step, step_key)

    B, T = A2M_B, A2M_T
    feats = A2M["njoints"] * A2M["nfeats"]
    x = np.random.default_rng(2).normal(size=(B, T, feats)).astype(np.float32)
    batch = {"x": torch.from_numpy(x).to(dev), "mask": torch.ones(B, T, dtype=torch.bool,
                                                                  device=dev),
             "cond": Conditioning(action=(torch.arange(B) % A2M["num_actions"]).to(dev))}
    sched = Schedule.create("cosine", 1000).to(dev)
    rows = {}
    for arch, dtype, steps in (("trans_enc", "bfloat16", 25), ("gru", "float32", 4)):
        cfg = MDMConfig(arch=arch, compute_dtype=dtype, dropout=RATE, **A2M, **FLAGSHIP)
        model = MDM(cfg).init_weights(torch.Generator().manual_seed(0)).to(dev)
        state = create_train_state(model, OptimConfig(lr=1e-3))
        fit = make_train_step(sched, TrainStepConfig(optim=OptimConfig(lr=1e-3)))
        for counts in (TB.LAUNCHES, ET.LAUNCHES, DB.LAUNCHES, _chain.GEMM_LAUNCHES):
            _zero(counts)
        keys = [step_key(5, i) for i in range(steps)]
        if arch == "gru":  # one warm step, three timed
            _run_steps(torch, fit, state, batch, keys[:1])
            ms, losses = _run_steps(torch, fit, state, batch, keys[1:])
            if not np.isfinite(losses).all():
                raise AssertionError(f"a2m GRU training: non-finite loss {losses}")
            rows[arch] = dict(ms_per_step=ms, losses=losses.tolist(),
                              launches=_train_counts(TB, ET, DB, _chain))
        else:
            _run_steps(torch, fit, state, batch, keys[:5])
            ms, losses = _run_steps(torch, fit, state, batch, keys[5:])
            launches = _train_counts(TB, ET, DB, _chain)
            n = cfg.num_layers * steps
            want = {"fused_train_attention_block.fwd": n, "fused_train_attention_block.bwd": n,
                    "fused_encoder_tail.fwd": n, "fused_encoder_tail.bwd": n,
                    "dropout_bits": 0, "tail_dropout_bits": 0, "sequence_dropout_bits": steps,
                    "products.wgmma": 12 * n, "products.fma": 0}
            if launches != want:
                raise AssertionError(f"a2m training launched {launches}, expected {want}")
            first, last = _falls("a2m training", losses)
            rows[arch] = dict(ms_per_step=ms, loss_first_10=first, loss_last_10=last,
                              launches=launches)
            trained = state.model
        print(f"a2m {arch} B={B} T={T} {dtype} dropout {RATE}: {json.dumps(rows[arch])} "
              f"(ms/step: CUDA events over the last {min(steps - 1, 20)} steps)")
        del state

    phase_step_card_vs_cpu(torch, dev, steps=1, dropout=RATE, route="a2m trans_enc",
                           model_kw=A2M, case=_a2m_case,
                           loss=dict(lambda_vel=1.0, vel_drop_last_feats=6))
    phase_step_card_vs_cpu(torch, dev, steps=1, dropout=RATE, route="a2m gru",
                           model_kw=dict(A2M, arch="gru"), case=_a2m_case)

    gen = MotionGenerator(trained.eval(), Schedule.create("cosine", 1000, "50").to(dev),
                          GenerationConfig(guidance_scale=2.5))
    cond = Conditioning(action=torch.arange(32) % A2M["num_actions"])
    gen.sample_features(cond, 32, T, torch.Generator(dev).manual_seed(0))
    li.LAUNCHES = 0
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    out = gen.sample_features(cond, 32, T, torch.Generator(dev).manual_seed(1))
    end.record()
    torch.cuda.synchronize()
    ms = start.elapsed_time(end)
    if tuple(out.shape) != (32, T, feats) or not torch.isfinite(out).all() or li.LAUNCHES != 400:
        raise AssertionError(f"a2m sample_features: shape {tuple(out.shape)}, finite "
                             f"{bool(torch.isfinite(out).all())}, layer kernel {li.LAUNCHES}")
    rows["sample_ms_b32_50step"] = ms
    print(f"a2m sample_features B=32 T={T}, 50 ddpm steps, CFG 2.5, bf16: {ms:.1f} ms "
          f"(CUDA events, after one warm call); whole-layer kernel launches {li.LAUNCHES}")
    return rows


def phase_goal(torch, dev):
    """Phase 14d: one f32 DiP step with goal conditioning (``multi``),
    the targets extracted in the step, the goal loss on, card against CPU."""
    from mdm_tpu_torch.sampling.pipeline import load_norm_stats
    from mdm_tpu_torch.train import make_target_cond_fn, make_target_loss_builder

    mean, std = load_norm_stats("humanml")
    phase_step_card_vs_cpu(
        torch, dev, steps=1, dropout=RATE, route="DiP goal conditioning",
        model_kw=dict(SMALL_DIP, multi_target_cond=True, multi_encoder_type="multi"),
        case=_goal_case, loss=dict(lambda_target_loc=1.0),
        step_kw=dict(target_cond_fn=make_target_cond_fn(mean, std),
                     target_loss_builder=make_target_loss_builder(mean, std)))


@contextlib.contextmanager
def stdout_to(path):
    """The enclosed code's standard output, appended to ``path``."""
    with open(path, "a") as f, contextlib.redirect_stdout(f):
        yield


CLI_CLIPS = 512  # phase 15's synthetic HumanML3D tree: clips of 40-196 frames x 263 f32
CLI_TRAIN = ["--dataset", "humanml", "--batch_size", "128", "--compute_dtype", "bfloat16",
             "--diffusion_steps", "50", "--num_steps", "30", "--save_interval", "15",
             "--log_interval", "5", "--text_encoder_type", "hash", "--use_ema", "true",
             "--device", "0"]


def synthetic_humanml(root, clips=CLI_CLIPS, seed=15):
    """A HumanML3D tree (new_joint_vecs/, texts/, train.txt/test.txt,
    Mean.npy/Std.npy: tests/test_cli.py's layout) from a fixed numpy seed,
    its captions from assets/example_text_prompts.txt."""
    with open(os.path.join(os.path.dirname(os.path.abspath(__file__)), "assets",
                           "example_text_prompts.txt")) as f:
        prompts = [p.strip() for p in f if p.strip()]
    rng = np.random.default_rng(seed)
    os.makedirs(os.path.join(root, "new_joint_vecs"))
    os.makedirs(os.path.join(root, "texts"))
    motions = []
    for i in range(clips):
        motion = rng.normal(size=(int(rng.integers(40, 197)), 263)).astype(np.float32)
        motions.append(motion)
        np.save(os.path.join(root, "new_joint_vecs", f"{i:06d}.npy"), motion)
        caption = prompts[i % len(prompts)]
        tokens = " ".join(f"{w}/OTHER" for w in caption.split())
        with open(os.path.join(root, "texts", f"{i:06d}.txt"), "w") as f:
            f.write(f"{caption}#{tokens}#0.0#0.0\n")
    for split in ("train", "test"):
        with open(os.path.join(root, f"{split}.txt"), "w") as f:
            f.write("\n".join(f"{i:06d}" for i in range(clips)))
    allm = np.concatenate(motions)
    np.save(os.path.join(root, "Mean.npy"), allm.mean(0).astype(np.float32))
    np.save(os.path.join(root, "Std.npy"), allm.std(0).astype(np.float32))


def _cli_counts(TB, ET, DB, li, chain):
    return dict(_train_counts(TB, ET, DB, chain), fused_layer_inference=li.LAUNCHES)


def _zero_cli_counts(TB, ET, DB, li, chain):
    for counts in (TB.LAUNCHES, ET.LAUNCHES, DB.LAUNCHES, chain.GEMM_LAUNCHES):
        _zero(counts)
    li.LAUNCHES = 0


def phase_cli(torch, TB, ET, DB, li, dev, bare_step_ms, generate_s_per_sample, tmp):
    """Phase 15: the command-line entry points a user runs, in this process
    so that the launch counters count, in the directory ``tmp`` (phase 16
    goes on from its tree and checkpoints). On a
    synthetic HumanML3D tree: ``cli.train`` at the flagship width (B = 128,
    bf16, 50 diffusion steps, AdamW + EMA, 30 steps, checkpoints at 15 and
    30), its ms/step by CUDA events between steps; a second ``cli.train``
    resuming from step 15 to 30, whose checkpoint must equal the first run's
    bitwise; ``cli.generate`` at B = 32 (50 steps, CFG 2.5, 196 frames) from
    the checkpoint; and ``cli.edit`` (in-between) from it. Each entry
    point's launches are counted from zero over its own call."""
    from mdm_tpu_torch import train as T
    from mdm_tpu_torch.cli import edit as edit_cli
    from mdm_tpu_torch.cli import generate as gen_cli
    from mdm_tpu_torch.cli import train as train_cli
    from mdm_tpu_torch.ops import _chain
    from mdm_tpu_torch.sampling import MotionGenerator

    counters = (TB, ET, DB, li, _chain)
    layers, steps, B = FLAGSHIP["num_layers"], 30, 32
    cwd = os.getcwd()
    os.environ["MDM_TPU_NO_RENDER"] = "1"
    os.chdir(tmp)  # the dataset's parse cache goes under ./save
    try:
        root = os.path.join(tmp, "HumanML3D")
        # The CLIs' own output (each log window's loss table, the saves)
        # goes to this file; the phase prints its summary.
        quiet = lambda: stdout_to(os.path.join(tmp, "cli.log"))
        t0 = time.perf_counter()
        synthetic_humanml(root)
        print(f"cli: synthetic HumanML3D tree of {CLI_CLIPS} clips in "
              f"{time.perf_counter() - t0:.1f} s")

        # cli.train, with a CUDA event after each step (the step factory
        # wrapped while the CLI builds its step).
        marks = {}
        make = T.make_train_step

        def timed_make(*a, **k):
            inner = make(*a, **k)

            def step(state, batch, key):
                out = inner(state, batch, key)
                marks[out[0].step] = torch.cuda.Event(enable_timing=True)
                marks[out[0].step].record()
                return out
            return step

        run1, run2 = os.path.join(tmp, "run"), os.path.join(tmp, "resumed")
        T.make_train_step = timed_make
        try:
            _zero_cli_counts(*counters)
            t0 = time.perf_counter()
            with quiet():
                loop = train_cli.main(["--save_dir", run1, "--data_dir", root, *CLI_TRAIN])
            torch.cuda.synchronize()
            train_wall = time.perf_counter() - t0
            train_counts = _cli_counts(*counters)
        finally:
            T.make_train_step = make
        want = {"fused_train_attention_block.fwd": layers * steps,
                "fused_train_attention_block.bwd": layers * steps,
                "fused_encoder_tail.fwd": layers * steps,
                "fused_encoder_tail.bwd": layers * steps,
                "sequence_dropout_bits": steps, "products.wgmma": 12 * layers * steps,
                "products.fma": 0, "fused_layer_inference": 0}
        if any(train_counts.get(k) != v for k, v in want.items()):
            raise AssertionError(f"cli.train launched {train_counts}, expected {want}")
        ckpts = sorted(f for f in os.listdir(run1) if f.startswith("ckpt_"))
        if ckpts != ["ckpt_000000015", "ckpt_000000030"] or not os.path.exists(
                os.path.join(run1, "args.json")):
            raise AssertionError(f"cli.train wrote {sorted(os.listdir(run1))}")
        with open(os.path.join(run1, "progress.jsonl")) as f:
            losses = [json.loads(line)["loss"] for line in f if line.strip()]
        if not (np.isfinite(losses).all() and losses[-1] < losses[0]):
            raise AssertionError(f"cli.train's loss (each 5-step window) did not fall: {losses}")
        window_ms = marks[10].elapsed_time(marks[30]) / 20
        no_save_ms = marks[16].elapsed_time(marks[30]) / 14
        print(f"cli.train B=128 bf16 flagship, 30 steps: loss by 5-step window {losses}; "
              f"launches {json.dumps(train_counts)}; {train_wall:.1f} s in all (host clock, "
              f"dataset parse and checkpoints included)")
        print(f"cli.train ms/step (CUDA events): steps 10-30 {window_ms:.3f} (the step-15 "
              f"checkpoint inside), steps 16-30 {no_save_ms:.3f}; phase 8's bare step "
              f"{bare_step_ms:.3f}")

        # The loader alone, as the CLI drives it (hash embedder, pinned
        # batches), without a step: its batches' cost on this host.
        from mdm_tpu_torch.data import get_dataset_loader
        from mdm_tpu_torch.data.loader import pin_batch
        from mdm_tpu_torch.sampling.text import HashTextEmbedder

        data = get_dataset_loader("humanml", 128, data_root=root)
        data.text_embedder, data.host_transform = HashTextEmbedder(), pin_batch
        serial, prefetched = data._gen(0), data.iter_from(0)
        loader_ms = {}
        for name, it in (("serial", serial), ("prefetch thread", prefetched)):
            next(it)
            t0 = time.perf_counter()
            for _ in range(20):
                next(it)
            loader_ms[name] = (time.perf_counter() - t0) / 20 * 1e3
        print(f"cli loader alone, B=128 batches with hash embeddings, pinned: "
              f"{json.dumps(loader_ms)} ms/batch (host clock, 20 batches after one)")

        # Resume from step 15 in a second run: its step 30 equals the first's bitwise.
        _zero_cli_counts(*counters)
        with quiet():
            train_cli.main(["--save_dir", run2, "--data_dir", root, *CLI_TRAIN,
                            "--resume_checkpoint", os.path.join(run1, "ckpt_000000015")])
        torch.cuda.synchronize()
        resume_counts = _cli_counts(*counters)
        load = lambda d: torch.load(os.path.join(d, "ckpt_000000030"), map_location="cpu",
                                    weights_only=True)
        a, b = load(run1), load(run2)
        same = lambda x, y: x.keys() == y.keys() and all(torch.equal(x[k], y[k]) for k in x)
        moments = lambda sd: {f"{i}.{k}": v for i, st in sd["optimizer"]["state"].items()
                              for k, v in st.items() if torch.is_tensor(v)}
        if not (a["step"] == b["step"] == 30 and same(a["model"], b["model"])
                and same(a["ema_params"], b["ema_params"]) and same(moments(a), moments(b))):
            raise AssertionError("cli.train resumed from step 15 differs from the "
                                 "uninterrupted run at step 30")
        print(f"cli.train resume: 15 steps + checkpoint + resume + 15 steps == 30 steps, "
              f"bitwise (params, EMA, AdamW moments); the resumed run's launches "
              f"{json.dumps(resume_counts)}")
        del loop, a, b
        torch.cuda.empty_cache()

        # cli.generate at B = 32 from the step-30 checkpoint, generate() timed.
        ckpt = os.path.join(run1, "ckpt_000000030")
        gen_ms = []
        generate = MotionGenerator.generate

        def timed_generate(self, *a, **k):
            start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            start.record()
            out = generate(self, *a, **k)
            end.record()
            torch.cuda.synchronize()
            gen_ms.append(start.elapsed_time(end))
            return out

        out_g, out_e = os.path.join(tmp, "gen"), os.path.join(tmp, "edit")
        MotionGenerator.generate = timed_generate
        try:
            _zero_cli_counts(*counters)
            t0 = time.perf_counter()
            with quiet():
                gen_cli.main(["--model_path", ckpt, "--text_prompt", "a person walks forward",
                              "--num_samples", str(B), "--num_repetitions", "1",
                              "--motion_length", "9.8", "--output_dir", out_g, "--seed", "0",
                              "--device", "0"])
            gen_wall = time.perf_counter() - t0
            gen_counts = _cli_counts(*counters)
        finally:
            MotionGenerator.generate = generate
        diffusion_steps = 50
        want = {"fused_layer_inference": layers * diffusion_steps,
                "products.wgmma": 4 * layers * diffusion_steps, "products.fma": 0}
        if any(gen_counts.get(k) != v for k, v in want.items()):
            raise AssertionError(f"cli.generate launched {gen_counts}, expected {want}")
        res = np.load(os.path.join(out_g, "results.npy"), allow_pickle=True).item()
        keys = {"motion", "text", "lengths", "num_samples", "num_repetitions"}
        if (set(res) != keys or res["motion"].shape != (B, 196, 22, 3)
                or not np.isfinite(res["motion"]).all()):
            raise AssertionError(f"cli.generate's results.npy: {sorted(res)}, "
                                 f"motion {res['motion'].shape}")
        print(f"cli.generate B={B} T=196 50 steps CFG 2.5 bf16: launches "
              f"{json.dumps(gen_counts)}; generate {gen_ms[0]:.1f} ms (CUDA events), "
              f"{gen_ms[0] / 1000 / B:.6f} s/sample (phase 3: {generate_s_per_sample:.6f}); "
              f"the whole call {gen_wall:.2f} s (host clock: model, checkpoint, embedder, "
              f"sampling, results.npy)")

        # cli.edit: in-between, 32 samples of the test split.
        _zero_cli_counts(*counters)
        t0 = time.perf_counter()
        with quiet():
            edit_cli.main(["--model_path", ckpt, "--data_dir", root, "--num_samples", str(B),
                           "--output_dir", out_e, "--seed", "0", "--device", "0"])
        torch.cuda.synchronize()
        edit_wall = time.perf_counter() - t0
        edit_counts = _cli_counts(*counters)
        if any(edit_counts.get(k) != v for k, v in want.items()):
            raise AssertionError(f"cli.edit launched {edit_counts}, expected {want}")
        res = np.load(os.path.join(out_e, "results.npy"), allow_pickle=True).item()
        if (res["motion"].shape != (B, 196, 22, 3) or not np.isfinite(res["motion"]).all()
                or res["edit_mode"] != "in_between"):
            raise AssertionError(f"cli.edit's results.npy: motion {res['motion'].shape}")
        print(f"cli.edit in_between B={B} T=196 50 steps: launches {json.dumps(edit_counts)}; "
              f"{edit_wall:.2f} s (host clock, the whole call)")
    finally:
        os.chdir(cwd)
    return dict(train=train_counts, resume=resume_counts, generate=gen_counts,
                edit=edit_counts, train_ms=window_ms, train_no_save_ms=no_save_ms,
                generate_ms=gen_ms[0], loader_ms=loader_ms)


# Phase 16: the t2m evaluation protocol. The evaluators train at the
# protocol's widths (movement 512, text hidden 512, motion hidden 1024,
# co-embedding 512) on phase 15's tree with a GloVe vocabulary of its
# captions; the protocol runs at batch 32, debug mode, 2 replications.
EVAL_TRAIN_STEPS = {"decomp": 100, "match": 150}
EVAL_WARM = 20  # steps before ms/step is read
EVAL_REPS = 2
DIP_EVAL_REPS = 1  # DiP's autoregressive protocol: one replication, for the script's time
EMB_REL = 1e-4  # evaluator embeddings, card vs CPU (f32): of the largest |embedding|
DIP_EVAL_TRAIN = ["--dataset", "humanml", "--arch", "trans_dec", "--context_len", "20",
                  "--pred_len", "40", "--mask_frames", "--diffusion_steps", "10",
                  "--batch_size", "64", "--num_steps", "10", "--save_interval", "10",
                  "--log_interval", "5", "--compute_dtype", "bfloat16",
                  "--text_encoder_type", "hash", "--device", "0"]


def _gt_pass(root, glove, fixed_len=0, pred_len=0):
    """The ground-truth batches cli.eval_humanml builds (test split, eval
    mode, the GloVe vectorizer, batch 32, seed 0) and its dataset."""
    from mdm_tpu_torch.data import BatchIterator, WordVectorizer, get_dataset

    ds = get_dataset("humanml", split="test", hml_mode="eval", data_root=root,
                     fixed_len=fixed_len)
    ds.w_vectorizer = WordVectorizer(glove, "our_vab")
    return list(BatchIterator(ds, 32, shuffle=True, seed=0, infinite=False,
                              pred_len=pred_len)), ds


@contextlib.contextmanager
def patched(owner, name, wrap):
    """``owner.name`` replaced by ``wrap(original)`` inside the block."""
    original = getattr(owner, name)
    setattr(owner, name, wrap(original))
    try:
        yield
    finally:
        setattr(owner, name, original)


def _device_timed(torch, fn, times, keep=None):
    """fn, with the device time of each call (CUDA events, read later)
    appended to ``times``; ``keep`` records the call's first argument."""
    def timed(*a, **k):
        if keep is not None:
            keep.append(a[0])
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        out = fn(*a, **k)
        end.record()
        times.append((start, end))
        return out
    return timed


def _eval_run(torch, argv, quiet):
    """cli.eval_humanml.main(argv) with each replication's host time (the
    first matching pass's start to the diversity pass's end), the device
    time of each generation call and of each evaluator embedding, and the
    generator and the evaluator it built."""
    from mdm_tpu_torch.cli import eval_humanml as eval_cli
    from mdm_tpu_torch.eval import EvaluatorWrapper, harness
    from mdm_tpu_torch.sampling import MotionGenerator

    gen_t, emb_t, gens, wrappers, reps, frames = [], [], [], [], [], []

    def rep_start(fn):
        def f(*a, **k):
            reps.append([time.perf_counter()])
            return fn(*a, **k)
        return f

    def rep_end(fn):
        def f(*a, **k):
            out = fn(*a, **k)
            reps[-1].append(time.perf_counter())
            return out
        return f

    def ar_frames(fn):
        def f(self, cond, B, generator=None, required_frames=196, **k):
            frames.append(required_frames)
            return fn(self, cond, B, generator, required_frames, **k)
        return f

    with contextlib.ExitStack() as stack:
        stack.enter_context(patched(harness, "evaluate_matching_score", rep_start))
        stack.enter_context(patched(harness, "evaluate_diversity", rep_end))
        for name in ("sample_features", "sample_autoregressive"):
            stack.enter_context(patched(MotionGenerator, name,
                                        lambda fn: _device_timed(torch, fn, gen_t, gens)))
        stack.enter_context(patched(MotionGenerator, "sample_autoregressive", ar_frames))
        stack.enter_context(patched(EvaluatorWrapper, "get_co_embeddings_device",
                                    lambda fn: _device_timed(torch, fn, emb_t, wrappers)))
        with quiet():
            summary = eval_cli.main(argv)
    torch.cuda.synchronize()
    ms = lambda ts: sum(a.elapsed_time(b) for a, b in ts)
    rep_s = [b - a for a, b in reps]
    return dict(summary=summary, rep_s=rep_s, gen_ms=ms(gen_t) / len(rep_s),
                eval_ms=ms(emb_t) / len(rep_s), gen_calls=len(gen_t), ar_frames=frames,
                gen=gens[0], wrapper=wrappers[0])


def _check_summary(name, summary, loaders=("ground truth", "vald")):
    if summary["comparable"] is not True:
        raise AssertionError(f"{name}: not comparable: {summary.get('degraded_reasons')}")
    for metric in ("Matching Score", "R_precision", "FID", "Diversity"):
        if set(summary[metric]) != set(loaders) or not all(
                np.isfinite(v["mean"]).all() for v in summary[metric].values()):
            raise AssertionError(f"{name}: {metric} {summary[metric]}")


def phase_eval(torch, TB, ET, li, dev, tmp):
    """Phase 16, this slice's main path: the t2m evaluation protocol through
    its entry points, in ``tmp`` on phase 15's tree and checkpoint.
    ``cli.train_evaluators`` decomp then match at the protocol's widths
    (ms/step by CUDA events; the evaluator's embeddings of one batch, card
    against CPU, from the same finest.npy); ``cli.eval_humanml`` (debug, 2
    replications, B = 32) on phase 15's flagship checkpoint: #1's chain 8 x
    50 x batches x 2 launches, its ground-truth rows against a CPU run of
    the same pass, s per replication and its split between generation and
    the evaluator; then a short DiP ``cli.train`` and its
    ``--autoregressive`` eval (one replication) at dip_probe's geometry (context 20, pred 40,
    10 steps, CFG 7.5), the rate-0 block (#2) and tail (#4) counted exactly.
    Returns the launches, the times, and a function that runs one flagship
    replication (phase 12 profiles it)."""
    from mdm_tpu_torch.cli import train as train_cli
    from mdm_tpu_torch.cli import train_evaluators as tev_cli
    from mdm_tpu_torch.eval import EvalConfig, EvaluatorWrapper, GeneratedMotionLoader, evaluation
    from mdm_tpu_torch.eval import train_evaluators as TE
    from mdm_tpu_torch.ops import _chain
    from mdm_tpu_torch.sampling import HashTextEmbedder
    from mdm_tpu_torch.sampling.pipeline import dataset_norm_stats
    from mdm_tpu_torch.scripts.quality_rehearsal import write_glove

    layers = FLAGSHIP["num_layers"]
    cwd, tf32 = os.getcwd(), torch.backends.cudnn.allow_tf32
    os.chdir(tmp)
    # The CLIs run under PyTorch's default, which lets cuDNN take TF32; the
    # evaluators turn it off themselves, and the card-vs-CPU check holds that.
    torch.backends.cudnn.allow_tf32 = True
    try:
        root = os.path.join(tmp, "HumanML3D")
        quiet = lambda: stdout_to(os.path.join(tmp, "cli.log"))
        with open(os.path.join(os.path.dirname(os.path.abspath(__file__)), "assets",
                               "example_text_prompts.txt")) as f:
            words = sorted({w for line in f for w in line.split()})
        glove = write_glove(tmp, words)

        # 16a: the evaluators, trained on the card (batches cached there, as
        # the rehearsal runs them).
        ev_dir = os.path.join(tmp, "t2m", "text_mot_match", "model")
        os.makedirs(ev_dir)
        decomp, finest = os.path.join(tmp, "decomp.npy"), os.path.join(ev_dir, "finest.npy")
        ev_ms, ev_logs = {}, {}
        for stage, save, extra in (("decomp", decomp, []),
                                   ("match", finest, ["--decomp_path", decomp])):
            marks, logs = [], []

            def timed_make(make):
                def f(*a, **k):
                    init, step = make(*a, **k)

                    def timed(*sa):
                        out = step(*sa)
                        marks.append(torch.cuda.Event(enable_timing=True))
                        marks[-1].record()
                        logs.append(out[2]["loss"])
                        return out
                    return init, timed
                return f

            n = EVAL_TRAIN_STEPS[stage]
            with patched(TE, f"make_{stage}_step", timed_make), quiet():
                tev_cli.main(["--stage", stage, "--data_dir", root, "--glove_dir", glove,
                              "--save_path", save, "--num_steps", str(n), "--batch_size", "32",
                              "--cache_batches", str(CLI_CLIPS // 32), "--log_every", "50",
                              "--lr", "3e-4", "--device", "0", *extra])
            torch.cuda.synchronize()
            ev_ms[stage] = marks[EVAL_WARM - 1].elapsed_time(marks[-1]) / (n - EVAL_WARM)
            ev_logs[stage] = [float(logs[i]) for i in (0, n // 2, n - 1)]
            if not np.isfinite(ev_logs[stage]).all():
                raise AssertionError(f"train_evaluators {stage}: loss {ev_logs[stage]}")
        if not ev_logs["decomp"][-1] < ev_logs["decomp"][0]:
            raise AssertionError(f"train_evaluators decomp: loss did not fall {ev_logs['decomp']}")
        print(f"train_evaluators at the protocol widths, B=32, batches cached on the card: "
              f"ms/step (CUDA events, steps {EVAL_WARM}..end) {json.dumps(ev_ms)}; loss at the "
              f"first, middle and last step {json.dumps(ev_logs)}")

        gt, ds = _gt_pass(root, glove)
        card = EvaluatorWrapper("humanml", tmp, device=dev)
        host = EvaluatorWrapper("humanml", tmp, device="cpu")
        b = gt[0]
        args = (b["word_embeddings"], b["pos_one_hots"], b["sent_lens"], b["x"], b["lengths"])
        for name, x, y in zip(("text", "motion"), card.get_co_embeddings(*args),
                              host.get_co_embeddings(*args)):
            err, scale = float(np.abs(x - y).max()), float(np.abs(y).max())
            print(f"evaluator {name} embeddings [32, {y.shape[1]}], card (cuDNN TF32 allowed "
                  f"outside the evaluator) vs CPU on one finest.npy: max abs err {err:.3g} "
                  f"(tolerance {EMB_REL} x max |embedding| {scale:.3g})")
            if not err <= EMB_REL * scale:
                raise AssertionError(f"evaluator {name} embeddings: card and CPU disagree, {err}")

        # 16b: cli.eval_humanml on phase 15's flagship checkpoint.
        for c in (TB.LAUNCHES, ET.LAUNCHES, _chain.GEMM_LAUNCHES):
            _zero(c)
        li.LAUNCHES = 0
        run = _eval_run(torch, ["--model_path", os.path.join(tmp, "run", "ckpt_000000030"),
                                "--data_dir", root, "--eval_mode", "debug", "--replications",
                                str(EVAL_REPS), "--evaluator_dir", tmp, "--device", "0"], quiet)
        batches = len(gt)
        want = layers * 50 * batches * EVAL_REPS
        got = dict(fused_layer_inference=li.LAUNCHES, products=dict(_chain.GEMM_LAUNCHES),
                   sampling_calls=run["gen_calls"])
        if got != dict(fused_layer_inference=want, products={"wgmma": 4 * want, "fma": 0},
                       sampling_calls=batches * EVAL_REPS) or TB.LAUNCHES["fwd"]:
            raise AssertionError(f"cli.eval_humanml launched {got}, expected {want} layer "
                                 f"kernel launches ({layers} x 50 steps x {batches} batches x "
                                 f"{EVAL_REPS} replications) and 4 products each on wgmma")
        summary = run["summary"]
        _check_summary("cli.eval_humanml", summary)
        with quiet():
            cpu = evaluation(host, lambda: iter(gt), {}, EvalConfig(replication_times=EVAL_REPS))
        gt_rows = {}
        for metric, tol in (("R_precision", 0.0), ("Matching Score", 1e-4), ("FID", 1e-4),
                            ("Diversity", 1e-4)):
            a = np.asarray(summary[metric]["ground truth"]["mean"])
            c = np.asarray(cpu[metric]["ground truth"]["mean"])
            gt_rows[metric] = [a.tolist(), c.tolist()]
            # R-precision: within one retrieval of the pass's 32 x batches rows
            ok = (np.abs(a - c).max() <= 1 / (32 * batches) if metric == "R_precision"
                  else np.allclose(a, c, rtol=tol, atol=1e-6))
            if not ok:
                raise AssertionError(f"ground truth {metric}: card {a}, CPU {c}")
        print(f"cli.eval_humanml flagship (B=32, 50 steps, CFG 2.5, bf16; debug, {EVAL_REPS} "
              f"replications x {batches} batches): launches {json.dumps(got)}; ground truth "
              f"card vs CPU {json.dumps(gt_rows)}; vald R-precision "
              f"{np.round(summary['R_precision']['vald']['mean'], 4).tolist()}, FID "
              f"{float(summary['FID']['vald']['mean']):.4f}")
        print(f"t2m protocol s/replication (host clock, matching + FID + diversity passes): "
              f"{json.dumps(run['rep_s'])}; per replication, generation {run['gen_ms']:.1f} ms "
              f"and evaluator {run['eval_ms']:.1f} ms (CUDA events)")
        flagship = dict(li=li.LAUNCHES, rep_s=run["rep_s"], gen_ms=run["gen_ms"],
                        eval_ms=run["eval_ms"])
        gen, wrapper = run["gen"], run["wrapper"]
        stats = dataset_norm_stats(root)
        loader = GeneratedMotionLoader(gen, gt, HashTextEmbedder(), seed=0, model_mean=stats[0],
                                       model_std=stats[1], eval_mean=ds.mean, eval_std=ds.std)
        one_replication = lambda: evaluation(wrapper, lambda: iter(gt), {"vald": lambda r: loader},
                                             EvalConfig(replication_times=1))

        # 16c: DiP, a short cli.train and the autoregressive protocol.
        dip_run = os.path.join(tmp, "dip")
        with quiet():
            train_cli.main(["--save_dir", dip_run, "--data_dir", root, *DIP_EVAL_TRAIN])
        torch.cuda.synchronize()
        for c in (TB.LAUNCHES, ET.LAUNCHES, _chain.GEMM_LAUNCHES):
            _zero(c)
        li.LAUNCHES = 0
        dip = _eval_run(torch, ["--model_path", dip_run, "--data_dir", root, "--eval_mode",
                                "debug", "--replications", str(DIP_EVAL_REPS),
                                "--evaluator_dir", tmp, "--autoregressive", "--guidance_param",
                                "7.5", "--device", "0"],
                        quiet)
        chunks = sum(-(-f // 40) for f in dip["ar_frames"])
        want = chunks * 10 * layers
        got = {"fused_block_attention_inference": TB.LAUNCHES["fwd"],
               "fused_encoder_tail_inference": ET.LAUNCHES["fwd"]}
        if (got != {k: want for k in got} or li.LAUNCHES
                or dict(_chain.GEMM_LAUNCHES) != {"wgmma": 4 * want, "fma": 0}):
            raise AssertionError(f"DiP eval launched {got}, layer kernel {li.LAUNCHES}, products "
                                 f"{dict(_chain.GEMM_LAUNCHES)}; expected {want} each ({chunks} "
                                 f"chunks x 10 steps x {layers} layers), 4 products each")
        _check_summary("cli.eval_humanml --autoregressive", dip["summary"])
        print(f"cli.eval_humanml --autoregressive DiP (context 20, pred 40, 10 steps, CFG 7.5, "
              f"bf16; debug, {DIP_EVAL_REPS} replication, {len(dip['ar_frames'])} batches, "
              f"{chunks} chunks): launches {json.dumps(got)}, products "
              f"{json.dumps(_chain.GEMM_LAUNCHES)}; "
              f"s/replication {json.dumps(dip['rep_s'])}; per replication generation "
              f"{dip['gen_ms']:.1f} ms and evaluator {dip['eval_ms']:.1f} ms (CUDA events)")
    finally:
        os.chdir(cwd)
        torch.backends.cudnn.allow_tf32 = tf32
    return dict(flagship=flagship, dip=dict(got, rep_s=dip["rep_s"]), ev_ms=ev_ms,
                one_replication=one_replication)


# Phase 17: the action-to-motion path at the flagship width: SMPL at its
# published sizes (V 6890, J 24, 10 betas, 207 pose-blend rows, 9 extra
# regressors; a synthetic model drawn from a seed, since SMPL_NEUTRAL.pkl is
# a download), the published HumanAct12 recipe (--cond_mask_prob 0
# --lambda_rcxyz 1 --lambda_vel 1 --lambda_fc 1), the classifiers at the
# reference's widths and the a2m / unconstrained protocols on a synthetic
# HumanAct12 tree of A2M_CLIPS clips (the eval megabatch: 6 batches of 32).
SMPL_TOL = 1e-5  # SMPL and the classifiers, card vs CPU at f32: of the largest |value|
A2M_RECIPE_LOSS = dict(lambda_rcxyz=1.0, lambda_vel=1.0, lambda_fc=1.0, vel_drop_last_feats=6)
A2M_RECIPE = ["--cond_mask_prob", "0", "--lambda_rcxyz", "1", "--lambda_vel", "1",
              "--lambda_fc", "1"]
A2M_CLIPS = 192
A2M_CLF_STEPS = 40
A2M_SEEDS = 2
A2M_STEPS = 50  # diffusion steps of the protocols' checkpoints
A2M_CLI = ["--dataset", "humanact12", "--num_frames", "60", "--batch_size", "64",
           "--compute_dtype", "bfloat16", "--diffusion_steps", str(A2M_STEPS),
           "--log_interval", "10", "--device", "0"]


def _rot6d_clips(torch, rng, B, T):
    """[B, T, 25, 6]: 24 rotations (random unit quaternions) in rot6d and a
    translation row, as HumanAct12's features are."""
    from mdm_tpu_torch.core import rotations as R

    q = torch.from_numpy(rng.normal(size=(B, T, 24, 4)).astype(np.float32))
    rot6d = R.matrix_to_rotation_6d(R.quaternion_to_matrix(q / q.norm(dim=-1, keepdim=True)))
    transl = torch.zeros(B, T, 1, 6)
    transl[..., :3] = torch.from_numpy(rng.normal(size=(B, T, 1, 3)).astype(np.float32))
    return torch.cat([rot6d, transl], dim=2)


def _a2m_smpl_case(torch, rng, B, T):
    """Phase 14c's a2m batch with valid rot6d features, and its draws."""
    batch, draws = _a2m_case(torch, rng, B, T)
    batch["x"] = _rot6d_clips(torch, rng, B, T).reshape(B, T, -1)
    return batch, draws


def _rel_err(torch, got, want):
    return (got.float().cpu() - want.float()).abs().max().item() / \
        max(want.float().abs().max().item(), 1e-30)


def phase_smpl(torch, dev, tmp):
    """Phase 17a: a synthetic SMPL pickle at the published sizes through
    ``SMPLModel.load``; ``rot2xyz`` of [64, 60, 25, 6] rot6d for every joint
    set, card against CPU at f32 (TF32 off); the smpl set's forward and
    forward + backward ms; the peak memory of the smpl set against the
    vertices'. Returns the model and the numbers."""
    from mdm_tpu_torch.scripts.a2m_rehearsal import write_synthetic_smpl
    from mdm_tpu_torch.smpl import JOINTSTYPES, Rot2XYZConfig, SMPLModel, rot2xyz

    path = write_synthetic_smpl(tmp)
    smpl = SMPLModel.load(path, os.path.join(os.path.dirname(path), "J_regressor_extra.npy"))
    V = smpl.v_template.shape[0]
    sizes = (V, smpl.num_joints, smpl.num_betas, smpl.posedirs.shape[0],
             smpl.j_regressor_extra.shape[0])
    if sizes != (6890, 24, 10, 207, 9):
        raise AssertionError(f"SMPL sizes {sizes}")
    B, T = A2M_B, A2M_T
    x = _rot6d_clips(torch, np.random.default_rng(17), B, T)
    errs = {}
    for jt in JOINTSTYPES:
        cfg = Rot2XYZConfig(jointstype=jt, vertstrans=True)
        errs[jt] = _rel_err(torch, rot2xyz(smpl, x.to(dev), cfg), rot2xyz(smpl, x, cfg))
        if not errs[jt] <= SMPL_TOL:
            raise AssertionError(f"rot2xyz {jt}: card vs CPU {errs[jt]:.3g} of the largest value")
    cfg = Rot2XYZConfig(jointstype="smpl", vertstrans=True)
    xg = x.to(dev).requires_grad_(True)
    fwd_bwd_ms = _time_ms(torch, lambda: rot2xyz(smpl, xg, cfg).square().sum().backward())
    with torch.no_grad():
        fwd_ms = _time_ms(torch, lambda: rot2xyz(smpl, xg, cfg))
        peak = {}
        for jt in ("smpl", "vertices"):
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated()
            out = rot2xyz(smpl, xg, Rot2XYZConfig(jointstype=jt, vertstrans=True))
            torch.cuda.synchronize()
            peak[jt] = torch.cuda.max_memory_allocated() - base
            del out
    vertex_tensor = B * T * V * 3 * 4
    if not peak["smpl"] < vertex_tensor:
        raise AssertionError(f"rot2xyz smpl allocated {peak['smpl']} bytes, not below one "
                             f"[{B * T}, {V}, 3] f32 tensor")
    row = dict(rel_err=errs, fwd_ms=fwd_ms, fwd_bwd_ms=fwd_bwd_ms, peak_bytes=peak)
    print(f"SMPL ({V} vertices, 24 joints, 10 betas, 207 pose-blend rows, 9 extra regressors; "
          f"synthetic, seeded) rot2xyz [{B}, {T}, 25, 6] f32, card vs CPU (tolerance "
          f"{SMPL_TOL} of the largest value), ms (CUDA events) and peak bytes: {json.dumps(row)}")
    return smpl, row


def _smpl_get_xyz(smpl):
    """The recipe's decode: rot6d features [B, T, 150] -> smpl joints."""
    from mdm_tpu_torch.smpl import Rot2XYZConfig, rot2xyz

    r2x = Rot2XYZConfig(jointstype="smpl", vertstrans=False)
    return lambda f: rot2xyz(smpl, f.reshape(f.shape[0], f.shape[1], 25, 6), r2x)


def _a2m_train_setup(torch, dev, smpl=None):
    """(state, batch, step) of the a2m step at the flagship width (trans_enc,
    action, rot6d, B = 64, T = 60, bf16, rate 0.1) on valid rot6d clips: with
    ``smpl``, the HumanAct12 recipe (no condition dropout, the rcxyz,
    velocity and foot-contact losses through SMPL, and its ``get_xyz``);
    without, phase 14c's bare step."""
    from mdm_tpu_torch.diffusion import LossConfig, Schedule
    from mdm_tpu_torch.models import MDM, Conditioning, MDMConfig
    from mdm_tpu_torch.train import (OptimConfig, TrainStepConfig, create_train_state,
                                     make_train_step)

    B, T = A2M_B, A2M_T
    x = _rot6d_clips(torch, np.random.default_rng(2), B, T).reshape(B, T, -1)
    batch = {"x": x.to(dev), "mask": torch.ones(B, T, dtype=torch.bool, device=dev),
             "cond": Conditioning(action=(torch.arange(B) % A2M["num_actions"]).to(dev))}
    cfg = MDMConfig(compute_dtype="bfloat16", dropout=RATE, **A2M, **FLAGSHIP)
    state = create_train_state(MDM(cfg).init_weights(torch.Generator().manual_seed(0)).to(dev),
                               OptimConfig(lr=1e-3))
    step_cfg, get_xyz = TrainStepConfig(optim=OptimConfig(lr=1e-3)), None
    if smpl is not None:
        get_xyz = _smpl_get_xyz(smpl)
        step_cfg = TrainStepConfig(loss=LossConfig(**A2M_RECIPE_LOSS),
                                   optim=OptimConfig(lr=1e-3), cond_mask_prob=0.0)
    fit = make_train_step(Schedule.create("cosine", 1000).to(dev), step_cfg, get_xyz=get_xyz)
    return state, batch, fit


def phase_a2m_recipe(torch, dev, smpl, bare_ms):
    """Phase 17b: the HumanAct12 recipe at the flagship width (trans_enc,
    action, rot6d, B = 64, T = 60, bf16, rate 0.1, no condition dropout,
    the rcxyz, velocity and foot-contact losses through SMPL): 25 steps on
    valid rot6d clips, the loss falls, the last 20 timed beside phase 14c's
    bare step, launches exact; then one f32 step card against CPU."""
    from mdm_tpu_torch.ops import _chain
    from mdm_tpu_torch.ops import attention_train_block as TB
    from mdm_tpu_torch.ops import dropout_bits as DB
    from mdm_tpu_torch.ops import encoder_tail as ET
    from mdm_tpu_torch.train import step_key

    B, T, steps = A2M_B, A2M_T, 25
    state, batch, fit = _a2m_train_setup(torch, dev, smpl)
    num_layers = FLAGSHIP["num_layers"]
    for counts in (TB.LAUNCHES, ET.LAUNCHES, DB.LAUNCHES, _chain.GEMM_LAUNCHES):
        _zero(counts)
    keys = [step_key(7, i) for i in range(steps)]
    _run_steps(torch, fit, state, batch, keys[:5])
    ms, losses = _run_steps(torch, fit, state, batch, keys[5:])
    launches = _train_counts(TB, ET, DB, _chain)
    n = num_layers * steps
    want = {"fused_train_attention_block.fwd": n, "fused_train_attention_block.bwd": n,
            "fused_encoder_tail.fwd": n, "fused_encoder_tail.bwd": n, "dropout_bits": 0,
            "tail_dropout_bits": 0, "sequence_dropout_bits": steps, "products.wgmma": 12 * n,
            "products.fma": 0}
    if launches != want:
        raise AssertionError(f"a2m recipe training launched {launches}, expected {want}")
    first, last = _falls("a2m recipe training", losses)
    metrics = {k: float(v) for k, v in fit(state, batch, step_key(7, steps))[1].items()
               if k in ("rot_mse", "rcxyz_mse", "vel_mse", "fc")}
    row = dict(ms_per_step=ms, bare_ms_per_step=bare_ms, loss_first_10=first,
               loss_last_10=last, terms=metrics, launches=launches)
    print(f"a2m recipe B={B} T={T} bf16 dropout {RATE}, rcxyz + vel + fc through SMPL: "
          f"{json.dumps(row)} (ms/step: CUDA events over the last 20 of {steps} steps; bare: "
          f"phase 14c)")
    del state
    phase_step_card_vs_cpu(torch, dev, steps=1, dropout=RATE, route="a2m recipe (SMPL losses)",
                           model_kw=A2M, case=_a2m_smpl_case, loss=A2M_RECIPE_LOSS,
                           step_kw=dict(get_xyz=_smpl_get_xyz(smpl)))
    return launches, row


def _classifiers_card_vs_cpu(torch, dev):
    """Phase 17c: the GRU (72 -> 128 x 2 -> 12), UESTC's STGCN (smpl, 6 ->
    40) and the modi-15 STGCN (3 -> 12) at T = 60 and the batches the path
    runs them at (B = 32, the classifier stages'; B = 192, the protocols'
    megabatch), seeded weights, card against CPU on the same inputs under
    f32_math."""
    import copy

    from mdm_tpu_torch.eval.a2m_setup import StgcnAdapter
    from mdm_tpu_torch.eval.classifiers import MotionDiscriminator
    from mdm_tpu_torch.eval.networks import f32_math, reset_seeded
    from mdm_tpu_torch.eval.stgcn import STGCN, STGCNConfig

    rng = np.random.default_rng(18)
    T = A2M_T
    randn = lambda *s: torch.from_numpy(rng.normal(size=s).astype(np.float32))  # noqa
    cases = {
        "MotionDiscriminator 72 -> 128 x 2 -> 12": (MotionDiscriminator(72, 128, 2, 12), (72,)),
        "STGCN smpl 6 -> 40": (StgcnAdapter(STGCN(STGCNConfig(in_channels=6, num_class=40))),
                               (24, 6)),
        "STGCN openpose_modi15 3 -> 12": (StgcnAdapter(STGCN(STGCNConfig(
            in_channels=3, num_class=12, layout="openpose_modi15"))), (15, 3)),
    }
    errs = {}
    for name, (clf, shape) in cases.items():
        reset_seeded(clf, 1)
        card = copy.deepcopy(clf).to(dev)
        for B in (32, A2M_CLIPS):
            x, lengths = randn(B, T, *shape), torch.from_numpy(rng.integers(1, T + 1, B))
            with torch.no_grad(), f32_math():
                want, got = clf(x, lengths), card(x.to(dev), lengths)
            errs[f"{name} [{B}, {T}]"] = {k: _rel_err(torch, got[k], want[k]) for k in want}
    if not max(max(e.values()) for e in errs.values()) <= SMPL_TOL:
        raise AssertionError(f"a2m classifiers: card vs CPU {errs}")
    print(f"a2m classifiers f32 (f32_math; cuDNN TF32 allowed outside), card vs CPU, relative "
          f"to the largest |output| (tolerance {SMPL_TOL}): {json.dumps(errs)}")
    return errs


def phase_a2m_protocols(torch, TB, ET, DB, li, dev, tmp):
    """Phase 17c-d in ``tmp`` (its body_models/smpl holds phase 17a's model):
    the classifiers card against CPU; ``cli.train_evaluators --stage
    a2m_classifier`` (the GRU on SMPL xyz) and ``--stage
    unconstrained_stgcn`` (ms/step by CUDA events after step 20);
    ``cli.train`` of an a2m checkpoint with the recipe and
    ``--eval_during_training``; ``cli.eval_a2m`` debug (2 seeds) with the
    self-trained classifier: s/seed, its generation / SMPL / classifier
    split, #1 exactly 8 x 50 x seeds; an unconditioned ``cli.train`` and
    ``cli.eval_unconstrained`` debug: s per pass. Each entry point counted
    from zero. Returns the launches, the times and a function that runs
    one a2m seed (phase 12 profiles it)."""
    import mdm_tpu_torch.smpl as smpl_pkg
    from mdm_tpu_torch.cli import eval_a2m as eval_a2m_cli
    from mdm_tpu_torch.cli import eval_unconstrained as eval_unc_cli
    from mdm_tpu_torch.cli import train as train_cli
    from mdm_tpu_torch.cli import train_evaluators as tev_cli
    from mdm_tpu_torch.eval import a2m_setup
    from mdm_tpu_torch.eval import train_evaluators as TE
    from mdm_tpu_torch.eval.harness_a2m import A2MEvaluation
    from mdm_tpu_torch.ops import _chain
    from mdm_tpu_torch.sampling import MotionGenerator
    from mdm_tpu_torch.scripts.a2m_rehearsal import build_dataset

    layers = FLAGSHIP["num_layers"]
    cwd, tf32 = os.getcwd(), torch.backends.cudnn.allow_tf32
    os.chdir(tmp)
    # The CLIs run under PyTorch's default, which lets cuDNN take TF32; the
    # classifiers turn it off themselves, and 17c holds that.
    torch.backends.cudnn.allow_tf32 = True
    out = {}
    try:
        quiet = lambda: stdout_to(os.path.join(tmp, "a2m_cli.log"))  # noqa: E731
        data = build_dataset(tmp, A2M_CLIPS)
        out["classifier_rel_err"] = _classifiers_card_vs_cpu(torch, dev)

        # 17c: the classifier stages, batches cached on the card.
        clf_npy, st_npy = os.path.join(tmp, "a2m_clf.npy"), os.path.join(tmp, "uncon_stgcn.npy")
        ev_ms, ev_logs = {}, {}
        for stage, save in (("a2m_classifier", clf_npy), ("unconstrained_stgcn", st_npy)):
            marks, logs = [], []

            def timed_make(make):
                def f(*a, **k):
                    init, step = make(*a, **k)

                    def timed(*sa):
                        res = step(*sa)
                        marks.append(torch.cuda.Event(enable_timing=True))
                        marks[-1].record()
                        logs.append(res[2]["loss"])
                        return res
                    return init, timed
                return f

            with patched(TE, "make_a2m_classifier_step", timed_make), quiet():
                tev_cli.main(["--stage", stage, "--dataset", "humanact12", "--data_dir", data,
                              "--save_path", save, "--num_steps", str(A2M_CLF_STEPS),
                              "--batch_size", "32", "--cache_batches", str(A2M_CLIPS // 32),
                              "--log_every", "20", "--lr", "3e-4", "--device", "0"])
            torch.cuda.synchronize()
            ev_ms[stage] = (marks[EVAL_WARM - 1].elapsed_time(marks[-1])
                            / (A2M_CLF_STEPS - EVAL_WARM))
            ev_logs[stage] = [float(logs[i]) for i in (0, A2M_CLF_STEPS - 1)]
            if not np.isfinite(ev_logs[stage]).all():
                raise AssertionError(f"train_evaluators {stage}: loss {ev_logs[stage]}")
        blob = np.load(clf_npy, allow_pickle=True).item()
        if (blob["feature"], blob["arch"], blob["input_size"]) != ("xyz", "gru", 72):
            raise AssertionError(f"a2m_classifier stage: {blob['feature']} {blob['arch']}")
        print(f"train_evaluators a2m stages at the reference widths, B=32, batches cached on the "
              f"card: ms/step (CUDA events, steps {EVAL_WARM}..{A2M_CLF_STEPS}) "
              f"{json.dumps(ev_ms)}; loss first and last {json.dumps(ev_logs)}")
        out["train_evaluators_ms"] = ev_ms

        # 17d: cli.train of an a2m checkpoint with the recipe, 20 steps, and
        # one a2m evaluation during training at the save (guidance 1).
        train_steps, run = 20, os.path.join(tmp, "a2m_run")
        flats = []

        def capture_eval(make):
            def f(*a, **k):
                eval_fn = make(*a, **k)
                return lambda state, step: flats.append(eval_fn(state, step)) or flats[-1]
            return f

        for c in (TB.LAUNCHES, ET.LAUNCHES, DB.LAUNCHES, _chain.GEMM_LAUNCHES):
            _zero(c)
        li.LAUNCHES = 0
        with patched(train_cli, "make_a2m_eval_during_training", capture_eval), quiet():
            train_cli.main(["--save_dir", run, "--data_dir", data, *A2M_CLI, *A2M_RECIPE,
                            "--num_steps", str(train_steps), "--save_interval", str(train_steps),
                            "--eval_during_training", "--eval_rep_times", "1",
                            "--eval_num_samples", "64", "--eval_batch_size", "32"])
        torch.cuda.synchronize()
        n = layers * train_steps
        got = {**_train_counts(TB, ET, DB, _chain), "fused_layer_inference": li.LAUNCHES}
        want = {"fused_train_attention_block.fwd": n, "fused_train_attention_block.bwd": n,
                "fused_encoder_tail.fwd": n, "fused_encoder_tail.bwd": n, "dropout_bits": 0,
                "tail_dropout_bits": 0, "sequence_dropout_bits": train_steps,
                "products.wgmma": 12 * n + 4 * layers * A2M_STEPS, "products.fma": 0,
                "fused_layer_inference": layers * A2M_STEPS}
        if got != want or len(flats) != 1 or not {"accuracy_gen", "fid_gen"} <= set(flats[0]):
            raise AssertionError(f"cli.train a2m recipe launched {got}, expected {want}; its "
                                 f"evaluations {flats}")
        print(f"cli.train a2m recipe (B=64, bf16, {A2M_STEPS} diffusion steps, {train_steps} "
              f"steps) + eval during training (1 seed, 64 clips, guidance 1): launches "
              f"{json.dumps(got)}; Eval accuracy_gen {flats[0]['accuracy_gen']:.4f}, fid_gen "
              f"{flats[0]['fid_gen']:.4f}")
        out["train"] = got

        # cli.eval_a2m, debug, with the self-trained classifier.
        gen_t, smpl_t, clf_t, seeds, kept = [], [], [], [], {}

        def seed_start(make_factory):
            def f(*a, **k):
                make = make_factory(*a, **k)
                kept["make_loaders"] = make

                def timed(seed):
                    seeds.append([time.perf_counter()])
                    return make(seed)
                return timed
            return f

        def seed_end(evaluate):
            def f(self, *a, **k):
                kept["evaluation"] = self
                res = evaluate(self, *a, **k)
                torch.cuda.synchronize()
                seeds[-1].append(time.perf_counter())
                return res
            return f

        for c in (TB.LAUNCHES, _chain.GEMM_LAUNCHES):
            _zero(c)
        li.LAUNCHES = 0
        with contextlib.ExitStack() as stack:
            stack.enter_context(patched(a2m_setup, "make_a2m_loaders_factory", seed_start))
            stack.enter_context(patched(A2MEvaluation, "evaluate", seed_end))
            stack.enter_context(patched(MotionGenerator, "sample_features",
                                        lambda fn: _device_timed(torch, fn, gen_t)))
            stack.enter_context(patched(smpl_pkg, "rot2xyz",
                                        lambda fn: _device_timed(torch, fn, smpl_t)))
            stack.enter_context(patched(A2MEvaluation, "_collect",
                                        lambda fn: _device_timed(torch, fn, clf_t)))
            stack.enter_context(quiet())
            summary = eval_a2m_cli.main(["--model_path", run, "--data_dir", data,
                                         "--eval_mode", "debug", "--a2m_classifier_path",
                                         clf_npy, "--device", "0"])
        torch.cuda.synchronize()
        want_li = layers * A2M_STEPS * A2M_SEEDS
        got = dict(fused_layer_inference=li.LAUNCHES, products=dict(_chain.GEMM_LAUNCHES),
                   sampling_calls=len(gen_t))
        if got != dict(fused_layer_inference=want_li, products={"wgmma": 4 * want_li, "fma": 0},
                       sampling_calls=A2M_SEEDS) or TB.LAUNCHES["fwd"]:
            raise AssertionError(f"cli.eval_a2m launched {got}, expected {want_li} layer kernel "
                                 f"launches ({layers} x {A2M_STEPS} steps x {A2M_SEEDS} seeds, "
                                 f"guidance 1) and 4 products each on wgmma")
        if summary["classifier"] != "self-trained" or not all(
                np.isfinite(summary[k]["mean"]) for k in ("accuracy_gen", "fid_gen", "fid_gt2",
                                                          "diversity_gen")):
            raise AssertionError(f"cli.eval_a2m summary {summary}")
        ms = lambda ts: sum(a.elapsed_time(b) for a, b in ts) / A2M_SEEDS  # noqa: E731
        s_seed = [b - a for a, b in seeds]
        split = dict(generation_ms=ms(gen_t), smpl_ms=ms(smpl_t), classifier_ms=ms(clf_t))
        print(f"cli.eval_a2m (debug, {A2M_SEEDS} seeds, megabatch {A2M_CLIPS} clips, "
              f"{A2M_STEPS} steps, guidance 1, bf16): launches {json.dumps(got)}; s/seed (host "
              f"clock, loaders to metrics) {json.dumps(s_seed)}; per seed (CUDA events) "
              f"{json.dumps(split)}; accuracy_gen {summary['accuracy_gen']['mean']:.4f}, "
              f"fid_gen {summary['fid_gen']['mean']:.4f}, accuracy_gt "
              f"{summary['accuracy_gt']['mean']:.4f}")
        out["eval_a2m"] = dict(got, s_per_seed=s_seed, **split)
        one_seed = lambda: kept["evaluation"].evaluate(kept["make_loaders"](0), seed=0)  # noqa

        # An unconditioned checkpoint and cli.eval_unconstrained.
        uncon = os.path.join(tmp, "uncon_run")
        with quiet():
            train_cli.main(["--save_dir", uncon, "--data_dir", data, *A2M_CLI, "--unconstrained",
                            "--cond_mask_prob", "0", "--num_steps", "4", "--save_interval",
                            "4"])
        torch.cuda.synchronize()
        _zero(_chain.GEMM_LAUNCHES)
        li.LAUNCHES = 0
        t0 = time.perf_counter()
        with quiet():
            summary = eval_unc_cli.main(["--model_path", uncon, "--data_dir", data,
                                         "--eval_mode", "debug", "--a2m_classifier_path", st_npy,
                                         "--device", "0"])
        torch.cuda.synchronize()
        s_pass = time.perf_counter() - t0
        want_li = layers * A2M_STEPS * (A2M_CLIPS // 32)
        if (li.LAUNCHES != want_li or summary["classifier"] != "self-trained"
                or not all(np.isfinite(summary[k]) for k in ("fid", "kid", "precision"))):
            raise AssertionError(f"cli.eval_unconstrained: {li.LAUNCHES} layer kernel launches "
                                 f"(expected {want_li}), summary {summary}")
        print(f"cli.eval_unconstrained (debug, {A2M_CLIPS // 32} batches of 32, {A2M_STEPS} "
              f"steps): {li.LAUNCHES} layer kernel launches, {s_pass:.3f} s a pass (host clock, "
              f"the whole CLI call); fid {summary['fid']:.4f}, kid {summary['kid']:.4f}, "
              f"precision {summary['precision']:.4f}")
        out["eval_unconstrained"] = dict(fused_layer_inference=li.LAUNCHES, s_per_pass=s_pass)
    finally:
        os.chdir(cwd)
        torch.backends.cudnn.allow_tf32 = tf32
    out.update(one_seed=one_seed, data=data,
               stage_npys={"a2m_classifier": clf_npy, "unconstrained_stgcn": st_npy})
    return out


# Phase 18: the published-weights path. The towers at their published
# widths with random weights drawn from a seed (the weights are downloads),
# written through cli.convert_text_encoders from the layouts the published
# checkpoints use; a synthetic reference MDM checkpoint through
# cli.convert_checkpoint; the Predictor's formats; SMPLify mesh export; and
# the classifier stages' determinism.
TOWER_PROMPTS = 32
TOWER_REL = 1e-4  # the towers' outputs, card (f32, TF32 off) vs CPU: of the largest |value|
BERT_SHAPE = dict(B=32, S=64, D=768, H=12)  # DistilBERT's attention at the embedder's 64 tokens
TOWER_MERGES = ["#version synthetic", "p e", "pe r", "per s", "pers o", "perso n</w>", "w a",
                "wa l", "wal k", "walk s</w>", "j u", "ju m", "jum p", "jump s</w>", "t u",
                "tu r", "tur n", "turn s</w>"]
TOWER_WORDS = ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "a", "person", "walk", "##s", "jump", "turn",
               "forward", "then", "and", "slowly", ".", ","]
# A DiP reference run's args.json beside the flagship's: dip_probe's geometry
DIP_REF = dict(arch="trans_dec", text_encoder_type="bert", context_len=20, pred_len=40,
               mask_frames=True, diffusion_steps=10)
MESH_ITERATIONS = 150


def _tower_sources(torch, tmp):
    """An OpenAI-layout CLIP state dict (the text keys, a visual key and
    logit_scale) and an HF DistilBertModel directory (q/k/v_lin, the
    ``distilbert.`` prefix), random at the published widths, and the two
    tokenizer files: a synthetic BPE merges file and WordPiece vocabulary."""
    import gzip

    from mdm_tpu_torch.models.text_encoders import ClipTextConfig, ClipTextEncoder

    g = torch.Generator().manual_seed(18)
    clip = ClipTextEncoder(ClipTextConfig())
    sd = {k: torch.randn(v.shape, generator=g) * (0.02 if v.dim() > 1 else 0.1)
          for k, v in clip.state_dict().items()}
    for k in sd:
        if k.endswith(("ln_1.weight", "ln_2.weight", "ln_final.weight")):
            sd[k] += 1.0
    sd.update({"logit_scale": torch.tensor(4.6), "visual.proj": torch.zeros(768, 512)})
    torch.save(sd, os.path.join(tmp, "ViT-B-32-text.pt"))
    D, F = 768, 3072
    bert = {"embeddings.word_embeddings.weight": torch.randn(30522, D, generator=g) * 0.5,
            "embeddings.position_embeddings.weight": torch.randn(512, D, generator=g) * 0.5,
            "embeddings.LayerNorm.weight": 1 + 0.1 * torch.randn(D, generator=g),
            "embeddings.LayerNorm.bias": 0.1 * torch.randn(D, generator=g)}
    for i in range(6):
        p = f"transformer.layer.{i}"
        for n, (o, k) in (("attention.q_lin", (D, D)), ("attention.k_lin", (D, D)),
                          ("attention.v_lin", (D, D)), ("attention.out_lin", (D, D)),
                          ("ffn.lin1", (F, D)), ("ffn.lin2", (D, F))):
            bert[f"{p}.{n}.weight"] = torch.randn(o, k, generator=g) * k ** -0.5
            bert[f"{p}.{n}.bias"] = 0.1 * torch.randn(o, generator=g)
        for n in ("sa_layer_norm", "output_layer_norm"):
            bert[f"{p}.{n}.weight"] = 1 + 0.1 * torch.randn(D, generator=g)
            bert[f"{p}.{n}.bias"] = 0.1 * torch.randn(D, generator=g)
    os.makedirs(os.path.join(tmp, "distilbert"))
    torch.save({f"distilbert.{k}": v for k, v in bert.items()},
               os.path.join(tmp, "distilbert", "pytorch_model.bin"))
    assets = os.path.join(tmp, "assets_text")
    os.makedirs(assets)
    with gzip.open(os.path.join(assets, "bpe_simple_vocab_16e6.txt.gz"), "wt") as f:
        f.write("\n".join(TOWER_MERGES))
    with open(os.path.join(assets, "bert_vocab.txt"), "w") as f:
        f.write("\n".join(TOWER_WORDS))
    return os.path.join(tmp, "ViT-B-32-text.pt"), os.path.join(tmp, "distilbert"), assets


def _tower_prompts(n=TOWER_PROMPTS):
    """n prompts of 1-60 words: the BERT rows run from mostly padding to all
    64 tokens; the CLIP rows from 3 tokens to the 22 of MDM's context."""
    words = ["a", "person", "walks", "jumps", "turns", "forward", "then", "and", "slowly"]
    return [" ".join(words[(i * 7 + j) % len(words)] for j in range(1 + (i * 11) % 60))
            for i in range(n)]


def phase_towers(torch, TB, ET, li, dev, tmp):
    """Phase 18a: both towers through their converter and embedders, card
    against CPU, launches counted per embedding batch; #2's rate-0 entry
    alone at DistilBERT's shape. Returns the assets directory and #2's row."""
    from mdm_tpu_torch.cli import convert_text_encoders as ct_cli
    from mdm_tpu_torch.models import layers as tl
    from mdm_tpu_torch.ops import _chain
    from mdm_tpu_torch.sampling.text import make_text_embedder

    clip_pt, bert_dir, assets = _tower_sources(torch, tmp)
    t0 = time.perf_counter()
    with stdout_to(os.path.join(tmp, "convert.log")):
        ct_cli.main(["--clip", clip_pt, "--bert", bert_dir, "--out_dir", assets])
    print(f"18a cli.convert_text_encoders (OpenAI .pt + HF directory): "
          f"{time.perf_counter() - t0:.2f} s")
    prompts = _tower_prompts()
    out = {}
    for kind in ("clip", "bert"):
        card = make_text_embedder(kind, assets, device=dev)
        cpu = make_text_embedder(kind, assets, device="cpu")
        card(prompts)  # warm
        torch.cuda.synchronize()
        TB.LAUNCHES["fwd"], li.LAUNCHES = 0, 0
        _zero(_chain.GEMM_LAUNCHES)
        t0 = time.perf_counter()
        got = card(prompts)
        s = time.perf_counter() - t0
        launches = dict(block=TB.LAUNCHES["fwd"], layer=li.LAUNCHES, **_chain.GEMM_LAUNCHES)
        want = cpu(prompts)
        err = np.abs(got["text_embed"] - want["text_embed"]).max()
        scale = np.abs(want["text_embed"]).max()
        n_block = 6 if kind == "bert" else 0
        expect = dict(block=n_block, layer=0, wgmma=0, fma=2 * n_block)
        if launches != expect:
            raise AssertionError(f"18a {kind}: launches {launches}, expected {expect}")
        if not np.isfinite(got["text_embed"]).all() or err > TOWER_REL * scale:
            raise AssertionError(f"18a {kind} tower: card vs CPU max abs err {err} > "
                                 f"{TOWER_REL} x {scale}")
        if kind == "bert":
            if not np.array_equal(got["text_tokens_mask"], want["text_tokens_mask"]):
                raise AssertionError("18a bert: the token masks differ")
            pad = 1 - got["text_tokens_mask"].mean()
        out[kind] = dict(launches=launches, rel_err=float(err / scale), s=s)
        print(f"18a {kind} tower, {TOWER_PROMPTS} prompts, f32: card vs CPU relative "
              f"{err / scale:.3g} (tolerance {TOWER_REL}); launches per batch "
              f"{json.dumps(launches)}; {s * 1000:.1f} ms a batch (host clock, tokenizer and "
              f"copies included)" + (f"; padding {pad:.3f} of the tokens" if kind == "bert"
                                     else ""))

    # #2's rate-0 entry alone at DistilBERT's self-attention: [32, 64, 768],
    # 12 heads of 64, f32, the key-padding row of the prompts above.
    B, S, D, H = (BERT_SHAPE[k] for k in ("B", "S", "D", "H"))
    g = torch.Generator().manual_seed(181)
    x = torch.randn(B, S, D, generator=g).to(dev)
    w = [(torch.randn(*s, generator=g) * sc).to(dev) for s, sc in
         (((3 * D, D), D ** -0.5), ((3 * D,), 0.1), ((D, D), D ** -0.5), ((D,), 0.1))]
    mask = torch.from_numpy(got["text_tokens_mask"]).to(dev)
    kpm = tl._row_bias(tl.key_padding_bias(~mask), S)
    row = compare_forward(
        torch, "fused_block_attention_inference (DistilBERT)",
        lambda: TB.fused_block_attention_inference(x, *w, H, key_padding_mask=kpm),
        lambda: TB.train_attention_block_reference(x, *w, H, key_padding_mask=kpm),
        TRAIN_REL["float32"], timed=True)
    mha = _torch_mha(torch, *w, H, 0.0).eval()
    M = B * S
    row.update(
        shape=f"[{B}, {S}, {D}] f32, {H} heads, key-padding row ({pad:.3f} padding)",
        launches=out["bert"]["launches"]["block"], path="DistilBERT tower, one prompt batch",
        library_ms=_no_grad_ms(torch, lambda: mha(x, x, x, key_padding_mask=~mask,
                                                  need_weights=False)[0]),
        **dict(zip(("bound_ms", "bound_by"),
                   bound(8 * M * D * D + 4 * B * S * S * D, nbytes(x, *w, kpm, x),
                         F32_FLOPS_PER_S))))
    print("18a #2 rate-0 entry at DistilBERT's shape", json.dumps(row))
    return assets, row, out


def _reference_checkpoint(torch, run_dir, config, args, seed):
    """A reference-format MDM checkpoint (the wrapped {'model', 'model_avg'}
    with clip_model.* and the sinusoidal pe buffers beside the weights, as
    the reference's training loop saves one) and its args.json."""
    from mdm_tpu_torch.models import MDM

    os.makedirs(run_dir)
    sds = []
    for s in (seed, seed + 1):
        sd = MDM(config).init_weights(torch.Generator().manual_seed(s)).state_dict()
        pe = torch.zeros(5000, 1, config.latent_dim)
        sd.update({"sequence_pos_encoder.pe": pe, "embed_timestep.sequence_pos_encoder.pe": pe,
                   "clip_model.token_embedding.weight": torch.zeros(49408, 512)})
        sds.append(sd)
    path = os.path.join(run_dir, "model000475000.pt")
    torch.save({"model": sds[0], "model_avg": sds[1]}, path)
    with open(os.path.join(run_dir, "args.json"), "w") as f:
        json.dump(args, f)
    return path


def phase_reference_import(torch, TB, ET, DB, li, dev, tmp, assets):
    """Phase 18b: cli.convert_checkpoint of a synthetic reference checkpoint
    at the flagship shape, cli.generate --text_encoder_type clip on it (B =
    32, 50 steps, bf16), #1 exactly 400; a DiP one (bert) through
    cli.generate --autoregressive, #2 and #4 counted. Returns the launches,
    the converted flagship run and the results.npy path."""
    from mdm_tpu_torch.cli import convert_checkpoint as cc_cli
    from mdm_tpu_torch.cli import generate as gen_cli
    from mdm_tpu_torch.models import MDMConfig
    from mdm_tpu_torch.ops import _chain
    from mdm_tpu_torch.sampling import text as text_mod
    from mdm_tpu_torch.scripts import dip_probe as DP

    quiet = lambda: stdout_to(os.path.join(tmp, "reference.log"))  # noqa: E731
    layers, B = FLAGSHIP["num_layers"], 32
    # the reference run's args.json: the model's fields, as its parser saves them
    flag_args = dict(dataset="humanml", latent_dim=FLAGSHIP["latent_dim"],
                     ff_size=FLAGSHIP["ff_size"], num_heads=FLAGSHIP["num_heads"],
                     layers=layers, arch="trans_enc", text_encoder_type="clip",
                     cond_mask_prob=0.1, use_ema=True, diffusion_steps=50)
    cases = {"flagship": (MDMConfig(**FLAGSHIP), flag_args, []),
             "dip": (DP.DIP, dict(flag_args, **DIP_REF),
                     ["--autoregressive", "--guidance_param", "7.5"])}
    out, saved = {}, text_mod.DEFAULT_ASSETS
    text_mod.DEFAULT_ASSETS = assets
    os.environ["MDM_TPU_NO_RENDER"] = "1"
    try:
        for name, (config, args, extra) in cases.items():
            t0 = time.perf_counter()
            ref = _reference_checkpoint(torch, os.path.join(tmp, f"ref_{name}"), config, args,
                                        seed=18)
            write_s = time.perf_counter() - t0
            t0 = time.perf_counter()
            with quiet():
                ckpt = cc_cli.main(["--torch_ckpt", ref, "--out_dir",
                                    os.path.join(tmp, f"converted_{name}")])
            convert_s = time.perf_counter() - t0
            gen_dir = os.path.join(tmp, f"gen_{name}")
            _zero_cli_counts(TB, ET, DB, li, _chain)
            t0 = time.perf_counter()
            with quiet():
                gen_cli.main(["--model_path", ckpt, "--text_prompt", "a person walks forward",
                              "--num_samples", str(B), "--num_repetitions", "1",
                              "--motion_length", "9.8", "--output_dir", gen_dir, "--seed", "0",
                              "--compute_dtype", "bfloat16", "--device", "0", *extra])
            torch.cuda.synchronize()
            gen_s = time.perf_counter() - t0
            counts = dict(fused_layer_inference=li.LAUNCHES,
                          fused_block_attention_inference=TB.LAUNCHES["fwd"],
                          fused_encoder_tail_inference=ET.LAUNCHES["fwd"],
                          **{f"products.{k}": v for k, v in _chain.GEMM_LAUNCHES.items()})
            if name == "flagship":  # 50 steps x 8 layers, 4 bf16 products each; CLIP: no kernel
                want = {"fused_layer_inference": layers * 50, "fused_block_attention_inference": 0,
                        "fused_encoder_tail_inference": 0, "products.wgmma": 4 * layers * 50,
                        "products.fma": 0}
            else:  # 196 frames in chunks of 40: 5 chunks x 10 steps x 8 layers, + the tower's 6
                chunks = -(-196 // DIP_REF["pred_len"])
                n = chunks * DIP_REF["diffusion_steps"] * layers
                want = {"fused_layer_inference": 0, "fused_block_attention_inference": n + 6,
                        "fused_encoder_tail_inference": n, "products.fma": 12}
            if any(counts[k] != v for k, v in want.items()):
                raise AssertionError(f"18b {name}: cli.generate launched {counts}, expected "
                                     f"{want}")
            res = np.load(os.path.join(gen_dir, "results.npy"), allow_pickle=True).item()
            if res["motion"].shape[:2] != (B, 196) or not np.isfinite(res["motion"]).all():
                raise AssertionError(f"18b {name}: results.npy motion {res['motion'].shape}")
            out[name] = dict(counts=counts, ckpt=ckpt, results=os.path.join(gen_dir,
                                                                              "results.npy"))
            print(f"18b {name}: reference checkpoint written in {write_s:.2f} s, "
                  f"cli.convert_checkpoint {convert_s:.2f} s, cli.generate "
                  f"--text_encoder_type {args['text_encoder_type']} {' '.join(extra)} B={B} "
                  f"{gen_s:.2f} s (host clock, the whole call): launches {json.dumps(counts)}")
    finally:
        text_mod.DEFAULT_ASSETS = saved
    return out


def phase_predictor_formats(torch, dev, tmp, assets, ckpt):
    """Phase 18c: Predictor on the converted flagship run with the CLIP
    tower, output_format json, hik (an SMPL fit per repetition, SMPL at its
    published sizes under ``tmp``) and animation (an .mp4 where ffmpeg is,
    else plot_3d_motion's GIF and no .mp4; where matplotlib is absent the
    format is not asked for, the phase says so and checks no .mp4 is
    there)."""
    import importlib.util
    import shutil

    from mdm_tpu_torch.sampling import text as text_mod
    from mdm_tpu_torch.serving import Predictor, PredictorConfig

    saved, cwd = text_mod.DEFAULT_ASSETS, os.getcwd()
    text_mod.DEFAULT_ASSETS = assets
    os.chdir(tmp)  # body_models/smpl (phase 18d's synthetic model)
    try:
        p = Predictor(PredictorConfig(model_path=ckpt, text_encoder_type="clip", batch_size=1,
                                      latent_dim=FLAGSHIP["latent_dim"],
                                      layers=FLAGSHIP["num_layers"], device=str(dev)))
        p.setup()
        if p.embedder is None:
            raise AssertionError("18c: Predictor built no CLIP embedder from the assets")
        times = {}
        formats = [("json", 6.0), ("hik", 6.0)]
        mp4 = os.path.join(tmp, "anim", "pred_0.mp4")
        if importlib.util.find_spec("matplotlib") is None:
            if os.path.exists(mp4):
                raise AssertionError(f"18c: {mp4} exists without an animation request")
            print("18c animation: matplotlib absent on this machine: the format was not asked "
                  "for, and no .mp4 is there")
        else:
            formats.append(("animation", 2.0))
        for fmt, seconds in formats:
            t0 = time.perf_counter()
            res = p.predict("a person walks forward", motion_length_sec=seconds, seed=0,
                            output_format=fmt, output_dir=os.path.join(tmp, "anim"))
            torch.cuda.synchronize()
            times[fmt] = time.perf_counter() - t0
            if fmt == "json":
                joints = np.asarray(res["joints"][0])
                if joints.shape != (1, 120, 22, 3) or not np.isfinite(joints).all():
                    raise AssertionError(f"18c json: joints {joints.shape}")
            elif fmt == "hik":
                th = np.asarray(res["thetas"])
                if th.shape != (1, 120, 24, 3) or not np.isfinite(th).all():
                    raise AssertionError(f"18c hik: thetas {th.shape}")
            else:
                path = res["animations"][0]
                if shutil.which("ffmpeg"):
                    ok = path == mp4 and os.path.getsize(mp4) > 0
                    note = "ffmpeg present: .mp4 written"
                else:
                    ok = path.endswith(".gif") and os.path.exists(path) and not os.path.exists(mp4)
                    note = "ffmpeg absent on this machine: plot_3d_motion wrote a GIF, no .mp4"
                if not ok:
                    raise AssertionError(f"18c animation: {path}")
                print(f"18c animation: {note} ({os.path.basename(path)})")
        print(f"18c Predictor (clip, batch 1, 50 steps, bf16): seconds a request (host clock) "
              f"{json.dumps(times)}")
        return times
    finally:
        text_mod.DEFAULT_ASSETS = saved
        os.chdir(cwd)


def phase_mesh_export(torch, tmp, results):
    """Phase 18d: cli.render_mesh on 18b's results.npy (one 196-frame clip)
    with the synthetic SMPL at its published sizes, MESH_ITERATIONS
    iterations on the card: s a clip, the loss at the first and the last
    iteration (it must fall)."""
    from mdm_tpu_torch.cli import render_mesh

    cwd = os.getcwd()
    os.chdir(tmp)
    try:
        t0 = time.perf_counter()
        with stdout_to(os.path.join(tmp, "render.log")):
            conv = render_mesh.main(["--input_path", results, "--iterations",
                                     str(MESH_ITERATIONS), "--out_dir",
                                     os.path.join(tmp, "mesh"), "--device", "0"])
        s = time.perf_counter() - t0
    finally:
        os.chdir(cwd)
    losses = conv.fit["losses"]
    objs = [f for f in os.listdir(os.path.join(tmp, "mesh")) if f.endswith(".obj")]
    if (len(objs) != conv.num_frames or conv.vertices.shape[1:] != (6890, 3)
            or not np.isfinite(losses).all() or not losses[-1] < losses[0]):
        raise AssertionError(f"18d render_mesh: {len(objs)} obj, vertices "
                             f"{conv.vertices.shape}, loss {losses[0]} -> {losses[-1]}")
    print(f"18d cli.render_mesh: {conv.num_frames} frames, {MESH_ITERATIONS} iterations on the "
          f"card, {s:.2f} s a clip (host clock: the fit, the skinning and {len(objs)} .obj "
          f"files); loss {losses[0]:.6g} -> {losses[-1]:.6g}")
    return dict(s_per_clip=s, loss_first=float(losses[0]), loss_last=float(losses[-1]))


def _npy_leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _npy_leaves(v, f"{prefix}/{k}")
    else:
        yield prefix, tree


def phase_stage_determinism(torch, tmp, first_runs, data):
    """Phase 18e, in phase 17's directory: the classifier stages rerun with
    phase 17c's arguments and seed; every saved weight must equal phase
    17c's bitwise. On a difference the stage runs once more under
    torch.use_deterministic_algorithms, which names an op that has no
    deterministic implementation, and the phase fails."""
    from mdm_tpu_torch.cli import train_evaluators as tev_cli

    cwd = os.getcwd()
    os.chdir(tmp)
    rows = {}
    try:
        for stage, first in first_runs.items():
            again = os.path.join(tmp, f"{stage}_again.npy")
            argv = ["--stage", stage, "--dataset", "humanact12", "--data_dir", data,
                    "--save_path", again, "--num_steps", str(A2M_CLF_STEPS), "--batch_size",
                    "32", "--cache_batches", str(A2M_CLIPS // 32), "--log_every", "20", "--lr",
                    "3e-4", "--device", "0"]
            with stdout_to(os.path.join(tmp, "determinism.log")):
                tev_cli.main(argv)
            a = dict(_npy_leaves(np.load(first, allow_pickle=True).item()))
            b = dict(_npy_leaves(np.load(again, allow_pickle=True).item()))
            arrays = [k for k, v in a.items() if isinstance(v, np.ndarray)]
            differ = {k: float(np.abs(a[k].astype(np.float64) - b[k]).max()) for k in arrays
                      if not np.array_equal(a[k], b[k])}
            rows[stage] = dict(arrays=len(arrays), differ=len(differ))
            print(f"18e {stage}: {A2M_CLF_STEPS} steps twice at seed 0: {len(arrays)} weight "
                  f"arrays, {len(differ)} differ" + (f" {json.dumps(differ)}" if differ else
                                                     " (bitwise equal)"))
            if differ:
                torch.use_deterministic_algorithms(True)
                try:
                    with stdout_to(os.path.join(tmp, "determinism.log")):
                        tev_cli.main(argv[:7] + [os.path.join(tmp, f"{stage}_det.npy")]
                                     + argv[8:])
                    note = "no op refused deterministic mode"
                except RuntimeError as e:
                    note = str(e).splitlines()[0]
                finally:
                    torch.use_deterministic_algorithms(False)
                raise AssertionError(f"18e {stage} does not repeat: {json.dumps(differ)}; "
                                     f"under use_deterministic_algorithms: {note}")
    finally:
        os.chdir(cwd)
    return rows


def smpl_forward(torch, smpl, dev):
    """One smpl rot2xyz forward of phase 17a's shape, without gradients."""
    from mdm_tpu_torch.smpl import Rot2XYZConfig, rot2xyz

    x = _rot6d_clips(torch, np.random.default_rng(17), A2M_B, A2M_T).to(dev)
    return lambda: rot2xyz(smpl, x, Rot2XYZConfig(jointstype="smpl", vertstrans=True))


def cuda_kernels(torch, fn):
    """The CUDA kernels one call of fn launches, under torch.profiler (after
    a warm call)."""
    from torch.profiler import ProfilerActivity, profile

    with torch.no_grad():
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
    return sum(1 for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA)


def device_busy(torch, fn):
    """(wall ms, kernel ms, kernels) of one call of fn under torch.profiler:
    CUDA events around it, the sum of its kernels' device time and their
    number."""
    from torch.profiler import ProfilerActivity, profile

    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
    kernels = sum(1 for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA)
    return (start.elapsed_time(end),
            sum(e.self_device_time_total for e in prof.key_averages()) / 1e3, kernels)


def phase_train_busy(torch, dev, dip_step_ms, remat_rows, a2m_ms, smpl, steps=3):
    """Phase 12 for training: ``steps`` DiP train steps (phase 14a's),
    flagship steps with and without remat at B = 128 (phase 14b's; B = 512
    is card-bound, busy 0.98), and the a2m step bare (phase 14c's) and with
    the HumanAct12 recipe's SMPL losses (phase 17b's), each after one warm
    step, under torch.profiler: the kernels' device ms and launches a step,
    and the busy share against the unprofiled ms/step (``a2m_ms``: bare,
    recipe)."""
    from mdm_tpu_torch.train import step_key

    runs = [("DiP train B=64", lambda: _dip_train_setup(torch, dev, 1e-3), dip_step_ms)]
    runs += [(f"flagship train B={r['B']} remat={r['remat']}",
              lambda r=r: _flagship_train_setup(torch, dev, r["B"], r["remat"]), r["ms_per_step"])
             for r in remat_rows if r["B"] == 128]
    runs += [(f"a2m train B={A2M_B} bare", lambda: _a2m_train_setup(torch, dev), a2m_ms[0]),
             (f"a2m train B={A2M_B} recipe (SMPL losses)",
              lambda: _a2m_train_setup(torch, dev, smpl), a2m_ms[1])]
    rows = []
    for name, setup, ms in runs:
        state, batch, step = setup()
        _run_steps(torch, step, state, batch, [step_key(6, 0)])
        wall, busy, kernels = device_busy(torch, lambda: _run_steps(
            torch, step, state, batch, [step_key(6, 1 + i) for i in range(steps)]))
        if not busy:
            raise AssertionError(f"{name}: torch.profiler recorded no device time")
        rows.append(dict(run=name, kernel_ms_per_step=busy / steps,
                         kernels_per_step=kernels / steps,
                         profiled_ms_per_step=wall / steps, ms_per_step=ms,
                         busy_share=busy / steps / ms))
        print("train under torch.profiler", json.dumps(rows[-1]))
        del state
        torch.cuda.empty_cache()
    return rows


def library_layer_ms(torch, dev):
    """One nn.TransformerEncoderLayer forward (its fast path: eval, no grad)
    at the sampling layer shape, bf16: kernel #1's library yardstick. Its ms
    issued back to back and on the card alone (CUDA graph replay), as #1's."""
    from mdm_tpu_torch.scripts.gemm_probe import device_ms

    D, F, H = FLAGSHIP["latent_dim"], FLAGSHIP["ff_size"], FLAGSHIP["num_heads"]
    layer = torch.nn.TransformerEncoderLayer(D, H, F, dropout=0.0, activation="gelu",
                                             batch_first=True).to(dev, torch.bfloat16).eval()
    x = torch.randn(64, 197, D, device=dev, dtype=torch.bfloat16)
    with torch.inference_mode():
        return _time_ms(torch, lambda: layer(x)), device_ms(lambda: layer(x))


def main():
    # Before cuBLAS starts: the workspace setting PyTorch documents for
    # reproducible runs, which the classifier stages' cuDNN GRUs need to
    # repeat bitwise (phase 18e; cli.train_evaluators sets it when it is the
    # process's entry point).
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    import torch

    if not torch.cuda.is_available():
        sys.exit("chip_smoke: no CUDA device is visible; nothing was run")
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from mdm_tpu_torch.diffusion import Schedule
    from mdm_tpu_torch.models import MDM, Conditioning, MDMConfig
    from mdm_tpu_torch.ops import _build, _chain
    from mdm_tpu_torch.ops import attention_train_block as TB
    from mdm_tpu_torch.ops import dropout_bits as DB
    from mdm_tpu_torch.ops import encoder_tail as ET
    from mdm_tpu_torch.ops import layer_inference as li
    from mdm_tpu_torch.sampling import GenerationConfig, HashTextEmbedder, MotionGenerator
    from mdm_tpu_torch.scripts import dip_probe as DP
    from mdm_tpu_torch.scripts import gemm_probe as GP
    from mdm_tpu_torch.serving import Predictor, PredictorConfig

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    t_start = time.perf_counter()
    stamp = lambda what: print(f"[{time.perf_counter() - t_start:.1f} s] {what} done")  # noqa

    # Phase 0: the card and the software.
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(smi.splitlines()[0])
    print(f"torch {torch.__version__} cuda {torch.version.cuda} python {sys.version.split()[0]}")
    clock = subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader"],
                           capture_output=True, text=True, check=True).stdout.strip()
    sm_clock_hz = float(clock.splitlines()[0].split()[0]) * 1e6  # "1980 MHz"
    print(f"SM clock max: {clock.splitlines()[0]}")

    # Phase 1: build the kernels from the sources in this checkout.
    t0 = time.perf_counter()
    so = _build.build()
    _build.load_library()
    print(f"build: {time.perf_counter() - t0:.1f} s -> {os.path.relpath(so)}")
    log = so.with_suffix(".log").read_text()
    regs = [int(n) for n in re.findall(r"Used (\d+) registers", log)]
    spills, entry = {}, None
    for ln in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", ln)
        entry = m.group(1) if m else entry
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", ln)
        if m and m.groups() != ("0", "0"):
            spills[entry] = [int(m.group(1)), int(m.group(2))]
    print(f"ptxas: {len(regs)} kernels, at most {max(regs)} registers, {len(spills)} spilling "
          f"(stores, loads bytes): {json.dumps(spills)}")
    print(f"ptxas, attention forward: {json.dumps(_build.ptxas_report(log, 'attn_fwd_bf16'))}")
    for kernel in ("attn_bwd_dq_bf16", "attn_bwd_dkv_bf16"):
        print(f"ptxas, attention backward {kernel}: "
              f"{json.dumps(_build.ptxas_report(log, kernel))}")
    bwd_blocks = {f"Dh={dh} bias={form} {kern}": _chain.attention_bwd_occupancy(dh, form, kern)
                  for dh in _chain.HEAD_DIMS for form in (0, 1, 2) for kern in _chain.BWD_KERNELS}
    print(f"attention backward occupancy, blocks of 4 warps per SM (bias 0 none, 1 row, "
          f"2 full): {json.dumps(bwd_blocks)}")
    if min(bwd_blocks[f"Dh=128 bias={f} {k}"] for f in (0, 1) for k in _chain.BWD_KERNELS) < 2:
        raise AssertionError("the attention backward holds fewer than 8 warps per SM at Dh=128")
    for kernel in ("attn_fwd_wide", "attn_bwd_dq_wide", "attn_bwd_dkv_wide"):
        print(f"ptxas, attention above Dh 256, {kernel}: "
              f"{json.dumps(_build.ptxas_report(log, kernel))}")
    print(f"ptxas, wgmma products: {json.dumps(_build.ptxas_report(log, GP.KERNEL))}")
    print(f"ptxas, dump: {json.dumps(_build.ptxas_report(log, 'philox_dump'))}")
    tail_ptxas = {k: _build.ptxas_report(log, k) for k in TAIL_KERNELS}
    print(f"ptxas, encoder tail: {json.dumps(tail_ptxas)}")
    tail_spills = [n for rep in tail_ptxas.values() for n, row in rep.items()
                   if row.get("spill_stores") or row.get("spill_loads")]
    if tail_spills or not all(tail_ptxas.values()):
        raise AssertionError(f"encoder tail kernels spill or are missing: {tail_spills}")

    stamp("phases 0-1")

    # Phase 2a: the wgmma product kernel against the plain product at the
    # edges of its tiling, every form: x . W^T (M on both sides of 128 rows
    # and the paths' M, the four product shapes and two ragged (N, K), bias
    # and GELU on and off), dY . W (the same rows, the residual on and off)
    # and dY^T . X (outputs on both sides of the 128 x 128 tile, K = 1, 63,
    # 64, 65, 394, 25216, split-K at the rule's count and one more), bf16 and
    # f32 out, and each form from a new thread; two runs bitwise equal.
    # These launches are comparisons, counted on no path.
    edges = GP.check_edges()
    print(f"wgmma products vs plain: {json.dumps(edges)}; two runs bitwise equal; "
          f"blocks per SM {_chain.wgmma_occupancy(False, False)} (x . W^T), "
          f"{_chain.wgmma_occupancy(True, False, False, True)} (dY . W), "
          f"{_chain.wgmma_occupancy(True, False, True, True)} (dY^T . X)")

    # Phase 2: kernel chain vs plain version at the main path's layer shapes
    # (CFG batch 64 = 2 x 32, S = 1 + 196 frames; serving batch 2 = 2 x 1)
    # and at a small f32 shape with a float additive row.
    D, F, H = FLAGSHIP["latent_dim"], FLAGSHIP["ff_size"], FLAGSHIP["num_heads"]
    flagship = [compare_layer(torch, li, 64, 197, D, F, H, torch.bfloat16, m) for m in (None, "bool")]
    compare_layer(torch, li, 2, 197, D, F, H, torch.bfloat16, None)
    compare_layer(torch, li, 64, 197, D, F, H, torch.float32, None)
    compare_layer(torch, li, 3, 37, 128, 256, 4, torch.float32, "float")
    # D = 1536 (12 heads of 128): the LayerNorm's f32 rows run past the
    # 1024 values a warp holds in registers and read the rest twice.
    for dtype, mask in ((torch.float32, None), (torch.bfloat16, "bool")):
        compare_layer(torch, li, 2, 37, 1536, 512, 12, dtype, mask)
    # Head dims off 128 at the sampling shape: 4 heads of 96 and of 256
    # (padded and widest tile instances of the attention core), 32 heads of
    # 4 (2-byte row copies) and 2 heads of 512 (the wide kernels).
    for width, heads in ((384, H), (1024, H), (128, 32), (1024, 2)):
        compare_layer(torch, li, 64, 197, width, F, heads, torch.bfloat16, "bool")

    stamp("phases 2a-2")

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
    _zero(_chain.GEMM_LAUNCHES)
    out1 = gen.generate(cond, B, T, torch.Generator(dev).manual_seed(0))
    torch.cuda.synchronize()
    if li.LAUNCHES != per_forward * steps:
        raise AssertionError(f"generate launched the layer kernels {li.LAUNCHES} times, "
                             f"expected {per_forward} layers x {steps} steps")
    products = dict(_chain.GEMM_LAUNCHES)  # 4 per layer call: q/k/v, out, linear1, linear2
    if products != {"wgmma": 4 * per_forward * steps, "fma": 0}:
        raise AssertionError(f"generate's products launched {products}, expected "
                             f"{4 * per_forward * steps} on the wgmma kernel and none elsewhere")
    print(f"generate's products: {products}")
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

    stamp("phases 2b-4")
    M = 64 * 197  # the timed layer: CFG batch 64, bf16, no mask
    layer_bytes = 2 * (2 * M * D + 4 * D * D + 2 * D * F + 9 * D + F)
    lib_ms, lib_device_ms = library_layer_ms(torch, dev)
    print(f"#1 over nn.TransformerEncoderLayer: {flagship[0]['ms'] / lib_ms:.3f}x back to back "
          f"({flagship[0]['ms']:.4f} / {lib_ms:.4f} ms), "
          f"{flagship[0]['device_ms'] / lib_device_ms:.3f}x on the card alone "
          f"({flagship[0]['device_ms']:.4f} / {lib_device_ms:.4f} ms)")
    kernels = [dict(name="fused_layer_inference", route="cuda", source=KERNEL_SOURCE,
                    replaces=REPLACES, launches=launches,
                    max_abs_err=max(r["max_abs_err"] for r in flagship),
                    ms=flagship[0]["ms"], device_ms=flagship[0]["device_ms"],
                    plain_ms=flagship[0]["plain_ms"], library_ms=lib_ms,
                    library_device_ms=lib_device_ms, path="sampling",
                    **dict(zip(("bound_ms", "bound_by"),
                               bound(2 * M * (4 * D * D + 2 * D * F) + 4 * 64 * 197 ** 2 * D,
                                     layer_bytes))))]

    # Phase 5: the training chains against their plain versions, at the
    # flagship training layer shape (bool mask with ragged rows) and at a
    # small f32 shape with a float additive row.
    block, tail = phase_train_kernels(torch, TB, ET, TRAIN_SHAPE, torch.bfloat16, "bool")
    phase_train_kernels(torch, TB, ET, dict(B=3, S=37, D=128, H=4, F=256), torch.float32,
                        "float", timed=False)
    # 4 heads of 96 and of 256, 32 heads of 4, 2 heads of 512 (as phase 2).
    for width, heads in ((384, 4), (1024, 4), (128, 32), (1024, 2)):
        phase_train_kernels(torch, TB, ET, dict(TRAIN_SHAPE, D=width, H=heads), torch.bfloat16,
                            "bool", timed=False)
    phase_tail_edges(torch, ET, DB, dev)

    stamp("phase 5")

    # Phase 6: the random stream. The dumps' launches are counted on the
    # training paths that run them (phases 8 and 11), not over these checks.
    dumps = phase_random_stream(torch, TB, ET, DB, TRAIN_SHAPE, dev)

    # Phase 7: the step, card against CPU.
    phase_step_card_vs_cpu(torch, dev)

    # Phase 8: flagship training (the training path's launch counts).
    train_launches, step_ms = phase_flagship_train(torch, TB, ET, DB, dev)

    stamp("phases 6-8")

    # Phases 9-11: the opt-in attention routes. Phase 9's comparisons are
    # not counted; #10 and #12 are counted over their direct-entry calls,
    # #11 over the pallas generate and #7/#8 over the drop training.
    attention = phase_attention_kernels(torch, dev)
    phase_forward_edges(torch, dev)
    phase_backward_edges(torch, dev)
    phase_f32_long_rows(torch, dev)
    direct = phase_direct_entries(torch, model, dev)
    v2_launches, pallas_s = phase_sampling_variants(torch, dev, gen_ms / 1000 / B)
    drop_launches, drop_ms = phase_train_drop(torch, dev, step_ms)

    stamp("phases 9-11")

    # Phase 13: DiP. The decoder layer's kernel route against its plain
    # route and the two rate-0 entries alone (comparisons, not counted);
    # then DiP's generate, whose launches of the rate-0 entries are counted;
    # then the other samplers and cached CFG on phase 3's trans_enc.
    decoder_rows, dip_entries = phase_decoder_layer(torch, dev)
    dip_gen, dip_conds, dip_launches, dip_ms = phase_dip_generate(torch, dev)
    sampler_rows = phase_samplers(torch, gen, cond, dev)

    stamp("phase 13")

    # Phase 14: training every denoiser. DiP training is this slice's main
    # path: its launches are counted from zero over its 30 steps. Then remat
    # at the flagship, action-to-motion (trans_enc and GRU) and goal
    # conditioning; their comparisons and timings are not counted.
    dip_train_launches, dip_step_ms = phase_dip_train(torch, dev)
    remat_rows = phase_remat(torch, dev)
    a2m_rows = phase_a2m(torch, dev)
    phase_goal(torch, dev)
    stamp("phase 14")

    # Phase 15: the command-line path: cli.train, its resume, cli.generate
    # and cli.edit, each counted from zero. Phase 16, this slice's main
    # path: the t2m evaluation protocol on phase 15's tree and checkpoint,
    # each entry point counted from zero.
    with tempfile.TemporaryDirectory() as tmp:
        cli = phase_cli(torch, TB, ET, DB, li, dev, step_ms, gen_ms / 1000 / B, tmp)
        protocol = phase_eval(torch, TB, ET, li, dev, tmp)
    stamp("phases 15-16")

    # Phase 17, this slice's main path: the action-to-motion family. SMPL on
    # the card (its comparisons not counted), the HumanAct12 recipe's steps
    # counted from zero, then the classifiers and the protocols through
    # their entry points, each counted from zero.
    with tempfile.TemporaryDirectory() as tmp:
        smpl, smpl_row = phase_smpl(torch, dev, tmp)
        recipe_launches, recipe_row = phase_a2m_recipe(torch, dev, smpl,
                                                       a2m_rows["trans_enc"]["ms_per_step"])
        a2m = phase_a2m_protocols(torch, TB, ET, DB, li, dev, tmp)
        # Phase 18e, in phase 17's directory: the classifier stages repeat.
        determinism = phase_stage_determinism(torch, tmp, a2m["stage_npys"], a2m["data"])
    stamp("phase 17, 18e")

    # Phase 18a-d, this slice's main path: the published-weights path. The
    # towers' embeddings counted per batch; cli.generate on converted
    # reference checkpoints counted from zero; the Predictor's formats and
    # the mesh export on the SMPL at its published sizes.
    from mdm_tpu_torch.scripts.a2m_rehearsal import write_synthetic_smpl

    with tempfile.TemporaryDirectory() as tmp:
        assets, bert_row, towers = phase_towers(torch, TB, ET, li, dev, tmp)
        reference = phase_reference_import(torch, TB, ET, DB, li, dev, tmp, assets)
        write_synthetic_smpl(tmp)
        predictor_s = phase_predictor_formats(torch, dev, tmp, assets,
                                              reference["flagship"]["ckpt"])
        mesh = phase_mesh_export(torch, tmp, reference["flagship"]["results"])
    print("phase 18", json.dumps(dict(towers=towers, predictor_s=predictor_s, mesh=mesh,
                                      determinism=determinism,
                                      reference={k: v["counts"] for k, v in reference.items()})))
    stamp("phase 18")
    sampling_paths = {"sampling (phases 3-4)": kernels[0]["launches"],
                      "cli.generate (phase 15)": cli["generate"]["fused_layer_inference"],
                      "cli.edit (phase 15)": cli["edit"]["fused_layer_inference"],
                      "cli.eval_humanml (phase 16)": protocol["flagship"]["li"],
                      "cli.train --eval_during_training, a2m (phase 17)":
                      a2m["train"]["fused_layer_inference"],
                      "cli.eval_a2m (phase 17)": a2m["eval_a2m"]["fused_layer_inference"],
                      "cli.eval_unconstrained (phase 17)":
                      a2m["eval_unconstrained"]["fused_layer_inference"],
                      "cli.generate, converted reference checkpoint, CLIP (phase 18b)":
                      reference["flagship"]["counts"]["fused_layer_inference"]}
    kernels[0].update(launches=sum(sampling_paths.values()), launches_by_path=sampling_paths,
                      path="; ".join(sampling_paths))

    # Phase 5's timed shapes (bf16, bool mask, bits drawn in-kernel: no
    # bits are read), analytically.
    Bt, St, Dt, Ht, Ft = (TRAIN_SHAPE[k] for k in ("B", "S", "D", "H", "F"))
    Mt = Bt * St
    bits_b, mask_b = 4 * Bt * Ht * St * St, Bt * St
    block_w = 2 * (4 * Dt * Dt + 4 * Dt)
    tail_w = 2 * (2 * Dt * Ft + Ft + 5 * Dt)
    tail_bits = 4 * Mt * (2 * Dt + Ft)
    work = {  # name.direction -> (FLOPs, bytes): a backward's products are twice the forward's
        "fused_train_attention_block.fwd": (8 * Mt * Dt * Dt + 4 * Bt * St * St * Dt,
                                            4 * Mt * Dt + block_w + mask_b),
        "fused_train_attention_block.bwd": (16 * Mt * Dt * Dt + 8 * Bt * St * St * Dt,
                                            6 * Mt * Dt + 2 * block_w + mask_b),
        "fused_encoder_tail.fwd": (4 * Mt * Dt * Ft, 6 * Mt * Dt + tail_w),
        "fused_encoder_tail.bwd": (8 * Mt * Dt * Ft, 10 * Mt * Dt + 2 * tail_w),
    }
    library = {"fused_train_attention_block.fwd": block["library_fwd_ms"],
               "fused_train_attention_block.bwd": block["library_bwd_ms"]}
    for name, row in (("fused_train_attention_block", block), ("fused_encoder_tail", tail)):
        for d, key in (("forward", "fwd"), ("backward", "bwd")):
            source, replaces = TRAIN_KERNELS[f"{name}.{d}"]
            paths = {"training, AUTO (phase 8)": train_launches[f"{name}.{key}"],
                     "DiP training, AUTO (phase 14)": dip_train_launches[f"{name}.{key}"],
                     "cli.train (phase 15)": cli["train"][f"{name}.{key}"],
                     "cli.train, resumed (phase 15)": cli["resume"][f"{name}.{key}"],
                     "a2m recipe training (phase 17b)": recipe_launches[f"{name}.{key}"],
                     "cli.train a2m recipe (phase 17)": a2m["train"][f"{name}.{key}"]}
            kernels.append(dict(name=f"{name}.{d}", route="cuda", source=source,
                                replaces=replaces, launches=sum(paths.values()),
                                launches_by_path=paths,
                                max_abs_err=row[f"max_abs_err_{key}"], ms=row[f"{key}_ms"],
                                device_ms=row.get(f"{key}_device_ms"),
                                plain_ms=row[f"{key}_plain_ms"],
                                library_ms=library.get(f"{name}.{key}"), path="; ".join(paths),
                                **dict(zip(("bound_ms", "bound_by"),
                                           bound(*work[f"{name}.{key}"])))))
    # The dumps: 4 bytes a word stored, and the words' draws (draw_bound_ms).
    # #6's launches: the AUTO step's sequence dropout (phase 8, the same
    # kernel) and the drop variant's tail (phase 11); #9's: the xla variant.
    dump_words = {"dropout_bits": bits_b // 4, "tail_dropout_bits": tail_bits // 4}
    dump_paths = {
        "dropout_bits": {"training, xla variant": drop_launches["dropout_bits"],
                         "DiP training, AUTO (cross-attention, phase 14)":
                         dip_train_launches["dropout_bits"]},
        "tail_dropout_bits": {"training, AUTO (sequence dropout)":
                              train_launches["sequence_dropout_bits"],
                              "training, drop variant (tail)": drop_launches["tail_dropout_bits"],
                              "DiP training, AUTO (sequence and attn-out dropout, phase 14)":
                              dip_train_launches["sequence_dropout_bits"],
                              "cli.train (sequence dropout, phase 15)":
                              cli["train"]["sequence_dropout_bits"],
                              "cli.train, resumed (sequence dropout, phase 15)":
                              cli["resume"]["sequence_dropout_bits"],
                              "a2m recipe training (sequence dropout, phase 17b)":
                              recipe_launches["sequence_dropout_bits"],
                              "cli.train a2m recipe (sequence dropout, phase 17)":
                              a2m["train"]["sequence_dropout_bits"]},
    }
    for name, words in dump_words.items():
        source, replaces = TRAIN_KERNELS[name]
        byte_ms, _ = bound(0, 4 * words)
        draw_ms = draw_bound_ms(words, sm_clock_hz)
        kernels.append(dict(name=name, route="cuda", source=source, replaces=replaces,
                            launches=sum(dump_paths[name].values()),
                            path="; ".join(dump_paths[name]),
                            launches_by_path=dump_paths[name], **dumps[name], library_ms=None,
                            bound_ms=max(byte_ms, draw_ms),
                            bound_by="bytes" if byte_ms >= draw_ms else "operations",
                            byte_bound_ms=byte_ms, draw_bound_ms=draw_ms))
    print(f"sequence_dropout_bits [{Bt}, {St}, {Dt}]: {dumps['sequence_dropout_bits']['ms']:.4f} "
          f"ms, draw bound {draw_bound_ms(Bt * St * Dt, sm_clock_hz):.4f}, byte bound "
          f"{bound(0, 4 * Bt * St * Dt)[0]:.4f}")
    routes = {  # name -> (TPU kernel it replaces, launches on its path, the path)
        "fused_dropout_attention.forward": ("mdm_tpu/ops/attention_dropout.py:181",
                                            drop_launches["fused_dropout_attention.fwd"],
                                            "training, drop variant"),
        "fused_dropout_attention.backward": ("mdm_tpu/ops/attention_dropout.py:214",
                                             drop_launches["fused_dropout_attention.bwd"],
                                             "training, drop variant"),
        "fused_attention": ("mdm_tpu/ops/attention.py:76", direct["fused_attention"],
                            "direct entry"),
        "fused_attention_v2": ("mdm_tpu/ops/attention_v2.py:69", v2_launches,
                               "sampling, pallas variant"),
        "fused_attention_block": ("mdm_tpu/ops/attention_block.py:84",
                                  direct["fused_attention_block"], "direct entry"),
    }
    for name, (replaces, n, path) in routes.items():
        kernels.append(dict(name=name, route="cuda", source=ATTENTION_SOURCE, replaces=replaces,
                            launches=n, path=path, **attention[name]))
    for name, (source, replaces) in DIP_SOURCES.items():
        paths = {"DiP sampling (trans_dec decoder layers), B=1 and B=32 (phase 13)":
                 dip_launches[name],
                 "cli.eval_humanml --autoregressive (phase 16)": protocol["dip"][name],
                 "cli.generate --autoregressive, converted DiP checkpoint, bert (phase 18b)":
                 reference["dip"]["counts"][name]}
        extra = {}
        if name == "fused_block_attention_inference":
            paths["DistilBERT tower, one batch of 32 prompts (phase 18a)"] = (
                towers["bert"]["launches"]["block"])
            extra["distilbert"] = bert_row  # the tower's shape: [32, 64, 768] f32, 12 heads
        kernels.append(dict(name=name, route="cuda", source=source, replaces=replaces,
                            launches=sum(paths.values()), launches_by_path=paths,
                            path="; ".join(paths), **dip_entries[name], **extra))
    print(f"s/sample at B=32: layer kernel {gen_ms / 1000 / B:.6f}, pallas variant "
          f"{pallas_s:.6f}, DiP {dip_ms[32] / 1000 / 32:.6f} (B=1: {dip_ms[1] / 1000:.6f}); "
          f"10-step samplers {json.dumps({k: r['s_per_sample'] for k, r in sampler_rows.items()})}"
          f"; ms/step at B=128: AUTO {step_ms:.3f}, drop variant {drop_ms:.3f}; DiP train "
          f"B={DIP_TRAIN_B} {dip_step_ms:.3f}; a2m B={A2M_B} trans_enc "
          f"{a2m_rows['trans_enc']['ms_per_step']:.3f}, gru {a2m_rows['gru']['ms_per_step']:.3f}; "
          f"remat {json.dumps(remat_rows)}; cli.train {cli['train_ms']:.3f} (steps 10-30), "
          f"{cli['train_no_save_ms']:.3f} (16-30); cli.generate "
          f"{cli['generate_ms'] / 1000 / B:.6f} s/sample; a2m recipe "
          f"{recipe_row['ms_per_step']:.3f} ms/step; cli.eval_a2m s/seed "
          f"{json.dumps(a2m['eval_a2m']['s_per_seed'])}")
    if any(k["launches"] <= 0 for k in kernels):
        raise AssertionError(f"a kernel was never launched on its path: {kernels}")
    products = {name: GP.measure(name) for name in GP.MAIN_PATH_PRODUCTS}

    # Phase 12, last of all: phase 3's generate, then phase 13's DiP
    # generates, then phase 14's DiP and remat train steps, once more under
    # torch.profiler for the card's busy share.
    # Last, because the profiler's tracing hooks can slow every later launch
    # of this process.
    wall, busy, _ = device_busy(torch, lambda: gen.generate(cond, B, T,
                                                         torch.Generator(dev).manual_seed(0)))
    print(f"generate under torch.profiler: {wall:.1f} ms ({gen_ms:.1f} without it, phase 3), "
          f"kernels {busy:.1f} ms on the card: device busy share {busy / gen_ms:.3f} of the "
          f"unprofiled run" if busy else
          "generate under torch.profiler: no device time recorded (busy share not measured)")
    for b, c in dip_conds.items():
        wall, busy, _ = device_busy(torch, lambda: dip_gen.generate(
            c, b, DP.FRAMES, torch.Generator(dev).manual_seed(1)))
        print(f"DiP generate B={b} under torch.profiler: {wall:.1f} ms ({dip_ms[b]:.1f} without "
              f"it, phase 13), kernels {busy:.1f} ms on the card: device busy share "
              f"{busy / dip_ms[b]:.3f} of the unprofiled run" if busy else
              f"DiP generate B={b} under torch.profiler: no device time recorded (busy share not "
              f"measured)")
    # Then phase 14's training steps the same way: DiP's, the flagship's
    # with and without remat, and the a2m step's bare and with phase 17b's
    # recipe.
    phase_train_busy(torch, dev, dip_step_ms, remat_rows,
                     (a2m_rows["trans_enc"]["ms_per_step"], recipe_row["ms_per_step"]), smpl)
    # Then one replication of phase 16's flagship protocol (generation and
    # evaluator over the ground-truth pass's batches, then the metrics).
    rep_ms = 1000 * min(protocol["flagship"]["rep_s"])
    wall, busy, _ = device_busy(torch, protocol["one_replication"])
    if not busy:
        raise AssertionError("the t2m protocol's replication: torch.profiler recorded no device "
                             "time")
    print(f"t2m protocol replication under torch.profiler: {wall:.1f} ms ({rep_ms:.1f} without "
          f"it, phase 16's fastest), kernels {busy:.1f} ms on the card: device busy share "
          f"{busy / rep_ms:.3f} of the unprofiled replication")
    # Then one seed of phase 17's a2m protocol (loaders, generation, SMPL,
    # classifier, metrics), and the CUDA kernels one smpl rot2xyz forward
    # launches (the 23-step chain is a Python loop of 4x4 products).
    seed_s = min(a2m["eval_a2m"]["s_per_seed"])
    wall, busy, _ = device_busy(torch, a2m["one_seed"])
    if not busy:
        raise AssertionError("the a2m protocol's seed: torch.profiler recorded no device time")
    print(f"a2m protocol seed under torch.profiler: {wall:.1f} ms ({1000 * seed_s:.1f} without "
          f"it, phase 17's fastest), kernels {busy:.1f} ms on the card: device busy share "
          f"{busy / (1000 * seed_s):.3f} of the unprofiled seed")
    n_kernels = cuda_kernels(torch, smpl_forward(torch, smpl, dev))
    print(f"rot2xyz smpl forward [{A2M_B}, {A2M_T}]: {n_kernels} CUDA kernels (torch.profiler)")
    stamp("phase 12")
    print("gemm products", json.dumps(products))
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
