"""Data- and tensor-parallel checks, run by every rank of a torch.distributed
world.

Each check runs the parallel path and, on rank 0, the one-process path on
the same global inputs; rank 0 prints one ``parallel_check <check> {json}``
line and writes ``<check>.pt`` (the numbers; with ``--keep`` also every
state and sample) into ``--out``.

- ``train``: data-parallel train steps of an MDM (``make_train_step(mesh=)``)
  against the one-process steps on the same global batch, weights and keys
  (or the draws of ``--inputs``). With ``--control`` the same DP run again
  with every rank's batch offset pinned at 0 (each rank then draws the
  masks of global rows 0..n, not its own): the negative control that shows
  the comparison sees the masks. Per variant: the losses, AdamW's first
  moments and the parameters' updates against the one-process run's, and
  ms per step (CUDA events on the card). With ``--model_parallel P`` the
  steps are tensor-parallel over a ``data x model`` mesh of the world (the
  state split by ``tp_rules.shard_state_``, gathered after each step) and
  the one-process steps run TP's route, the einsum attention and the plain
  tail; ``--control`` then pins the model offsets at 0 instead (every rank
  draws heads 0..H/P and FFN columns 0..F/P), and ``--save_resume`` adds a
  TP run that saves its gathered checkpoint after step 1, restores it onto
  a new TP state and goes on (the one-process run saves its own beside it,
  for the layout). Every rank reports its metrics, ms per step, launches
  and its all-reduces' count and bytes by group (model, batch).
- ``sample``: ``--checks`` among ``dp`` (a data-parallel DDIM sample from
  the global initial noise against the one-process one), ``ar`` (DiP's
  autoregressive path the same way, the chunk noise given), ``ddpm`` (a
  data-parallel DDPM sample of a batch whose two halves are the same
  inputs: finite, and the ranks' streams make the halves differ), ``tp``
  (DDIM over a tensor-parallel mesh of the whole world against the
  one-process sample on TP's route, the einsum attention and the plain
  tail; and against the kernel route, as the route's own difference)
  and ``serve`` (``Predictor`` with
  ``tensor_parallel`` = world answering one request on every rank).

Two CPU ranks (the tests' sizes are the defaults)::

    python -c "from mdm_tpu_torch.parallel.multihost import launch_local_multihost as L; \\
print(L(2, module='mdm_tpu_torch.scripts.parallel_check', \\
extra_argv=['train', '--out', 'save/parallel_check', '--control']))"

Two ranks sharing one card: ``launch_local_multihost(2, ..., device="cuda",
backend="gloo")`` and ``--device cuda`` with the flagship's widths.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import os
import time

import numpy as np
import torch

from .. import ops
from ..diffusion import LossConfig, Schedule
from ..models import MDM, Conditioning, MDMConfig
from ..parallel import tp_rules
from ..parallel.mesh import make_mesh, shard_batch
from ..parallel.multihost import barrier, maybe_initialize_distributed, rank, replicate, world_size
from ..sampling import GenerationConfig, MotionGenerator
from ..train import OptimConfig, TrainStepConfig, create_train_state, make_train_step, step_key
from ..train.checkpoints import restore_checkpoint, save_checkpoint
from ..train.resample import LossAwareState


def parse(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("check", choices=["train", "sample"])
    p.add_argument("--out", required=True, help="directory for <check>.pt (rank 0)")
    p.add_argument("--device", default="cuda", help="cuda (the rank's card) or cpu")
    p.add_argument("--arch", default="trans_enc", choices=["trans_enc", "trans_dec"])
    p.add_argument("--latent_dim", type=int, default=64)
    p.add_argument("--ff_size", type=int, default=128)
    p.add_argument("--layers", type=int, default=2)
    p.add_argument("--heads", type=int, default=4)
    p.add_argument("--dtype", default="float32", choices=["float32", "bfloat16"])
    p.add_argument("--dropout", type=float, default=0.1)
    p.add_argument("--batch", type=int, default=8, help="the global batch")
    p.add_argument("--frames", type=int, default=16)
    p.add_argument("--steps", type=int, default=2, help="train steps, or sampling steps")
    p.add_argument("--lr", type=float, default=1e-3)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--schedule_sampler", default="uniform")
    p.add_argument("--goal", action="store_true", help="goal conditioning (trans_dec)")
    p.add_argument("--model_parallel", type=int, default=1,
                   help="train: the mesh's model axis (tensor parallelism above 1)")
    p.add_argument("--remat", action="store_true", help="rematerialise the layers")
    p.add_argument("--control", action="store_true", help="add the offset-0 control run")
    p.add_argument("--save_resume", action="store_true",
                   help="train: add a run through a gathered checkpoint after step 1")
    p.add_argument("--checks", default="dp,ar,ddpm,tp,serve")
    p.add_argument("--inputs", default="", help="torch.save'd dict of given inputs")
    p.add_argument("--keep", action="store_true", help="save every state and sample")
    return p.parse_args(argv)


def model_config(args, **over) -> MDMConfig:
    kw = dict(njoints=263, nfeats=1, latent_dim=args.latent_dim, ff_size=args.ff_size,
              num_layers=args.layers, num_heads=args.heads, dropout=args.dropout,
              compute_dtype=args.dtype, mask_frames=True, remat=args.remat)
    if over.get("arch", args.arch) == "trans_dec":
        kw.update(arch="trans_dec", text_dim=768, text_tokens=True, context_len=5,
                  pred_len=args.frames)
    if args.goal:
        kw.update(multi_target_cond=True, multi_encoder_type="split", target_enc_layers=2)
    kw.update(over)
    return MDMConfig(**kw)


def global_batch(args, cfg: MDMConfig) -> dict:
    """The seeded global batch (numpy): ragged frame masks, and the
    conditioning the config reads."""
    rng = np.random.default_rng(args.seed)
    B, T = args.batch, args.frames
    x = rng.normal(size=(B, T, cfg.njoints)).astype(np.float32)
    mask = np.arange(T)[None] < rng.integers(T // 2, T + 1, size=(B, 1))
    cond = {}
    if cfg.arch == "trans_dec":
        L = 6
        cond["text_embed"] = rng.normal(size=(B, L, 768)).astype(np.float32)
        cond["text_tokens_mask"] = np.arange(L)[None] < rng.integers(1, L + 1, size=(B, 1))
        cond["prefix"] = rng.normal(size=(B, cfg.context_len, cfg.njoints)).astype(np.float32)
    else:
        cond["text_embed"] = rng.normal(size=(B, 512)).astype(np.float32)
    if cfg.multi_target_cond:
        from ..core.goals import sample_goal

        cond["target_validity"] = sample_goal(B, np.random.default_rng(args.seed + 1))[0]
    return {"x": x, "mask": mask, "cond": cond}


def _to(batch: dict, device) -> dict:
    t = lambda v: torch.as_tensor(v).to(device)
    return {"x": t(batch["x"]), "mask": t(batch["mask"]),
            "cond": Conditioning(**{k: t(v) for k, v in batch["cond"].items()})}


def _cpu(obj):
    if isinstance(obj, torch.Tensor):
        return obj.detach().cpu().clone()
    if isinstance(obj, dict):
        return {k: _cpu(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_cpu(v) for v in obj)
    return obj


@contextlib.contextmanager
def offset_pinned_at_zero():
    """Every rank draws its masks as if its rows started at global row 0."""
    real = ops.sharded_rows
    ops.sharded_rows = lambda first_row: real(0)
    try:
        yield
    finally:
        ops.sharded_rows = real


@contextlib.contextmanager
def model_offsets_pinned_at_zero():
    """Every tensor-parallel rank draws its masks as if its heads and FFN
    columns were the layer's first ones."""
    real = tp_rules.shard_model_

    def pinned(model, mesh):
        real(model, mesh)
        for m in model.modules():
            for name in ("head_offset", "ffn_offset"):
                if hasattr(m, name):
                    setattr(m, name, 0)
        return model

    tp_rules.shard_model_ = pinned
    try:
        yield
    finally:
        tp_rules.shard_model_ = real


@contextlib.contextmanager
def counting_all_reduces(mesh, counts: dict):
    """Count every ``torch.distributed.all_reduce`` of the body into
    ``counts``: group name (model, batch, other) -> count and bytes."""
    import torch.distributed as dist

    real = dist.all_reduce

    def spy(tensor, *args, group=None, **kw):
        name = ("model" if group is mesh.model_group else
                "batch" if group is mesh.batch_group else "other")
        c = counts.setdefault(name, {"count": 0, "bytes": 0})
        c["count"] += 1
        c["bytes"] += tensor.numel() * tensor.element_size()
        return real(tensor, *args, group=group, **kw)

    dist.all_reduce = spy
    try:
        yield
    finally:
        dist.all_reduce = real


def _timer(device):
    """() -> a function returning the ms since the call: CUDA events on the
    card, the host clock on the CPU."""
    if device.type == "cuda":
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()

        def stop():
            end.record()
            end.synchronize()
            return start.elapsed_time(end)
        return stop
    t0 = time.perf_counter()
    return lambda: (time.perf_counter() - t0) * 1e3


def launch_counts() -> dict:
    """Every kernel wrapper's launch count in this process, by name."""
    from ..ops import attention_dropout, attention_train_block, dropout_bits, encoder_tail
    from ..ops import layer_inference

    counts = {"fused_layer_inference": layer_inference.LAUNCHES, **dropout_bits.LAUNCHES}
    for name, mod in (("fused_train_attention_block", attention_train_block),
                      ("fused_encoder_tail", encoder_tail),
                      ("fused_dropout_attention", attention_dropout)):
        counts.update({f"{name}.{d}": n for d, n in mod.LAUNCHES.items()})
    return counts


def _since(before: dict) -> dict:
    return {k: v - before[k] for k, v in launch_counts().items()}


def run_train(args, cfg, batch, init, draws, mesh, device, resume_dir: str = "") -> dict:
    """The steps of one variant from ``init``: per-step metrics and ms, and
    the state before the first step and after each (on the CPU; a
    tensor-parallel state gathered). With ``resume_dir`` the state after
    step 1 is saved there and the steps go on from a new state restored
    from the file. On a mesh, the all-reduces by group."""
    from ..train import goal_cond as GC

    # Weight decay, the LR anneal and the EMA decay each move the update.
    optim = OptimConfig(lr=args.lr, weight_decay=0.5, lr_anneal_steps=4, ema_decay=0.9)
    tcfg = TrainStepConfig(loss=LossConfig(lambda_target_loc=1.0 if cfg.multi_target_cond
                                           else 0.0),
                           optim=optim, schedule_sampler=args.schedule_sampler)
    kw = {}
    if cfg.multi_target_cond:
        from ..sampling.pipeline import load_norm_stats

        mean, std = load_norm_stats("humanml")
        kw = dict(target_loss_builder=GC.make_target_loss_builder(mean, std),
                  target_cond_fn=GC.make_target_cond_fn(mean, std))
    sched = Schedule.create("cosine", 1000).to(device)
    step = make_train_step(sched, tcfg, mesh=mesh, **kw)

    def new_state():
        model = MDM(cfg)
        model.load_state_dict(init)
        state = create_train_state(model.to(device), optim)
        if mesh is not None:
            state = tp_rules.shard_state_(replicate(state), mesh)
        return state

    state = new_state()
    if mesh is not None:
        data = shard_batch(_to(batch, "cpu"), mesh, global_batch=True)
    else:
        data = _to(batch, device)
    sampler = (LossAwareState.create(sched.num_timesteps, device=device)
               if args.schedule_sampler == "loss-second-moment" else None)
    states, metrics, ms, reduces = [_cpu(tp_rules.gather_state(state))], [], [], {}
    counting = lambda: (counting_all_reduces(mesh, reduces) if mesh is not None
                        else contextlib.nullcontext())
    before = launch_counts()
    for i in range(args.steps):
        d = None if draws is None else {k: torch.as_tensor(v).to(device)
                                        for k, v in draws[i].items()}
        stop = _timer(device)
        with counting():
            if sampler is not None:
                state, m, sampler = step(state, data, step_key(args.seed, i), sampler, draws=d)
            else:
                state, m = step(state, data, step_key(args.seed, i), draws=d)
        metrics.append({k: float(v) for k, v in m.items()})
        ms.append(stop())
        states.append(_cpu(tp_rules.gather_state(state)))
        if resume_dir and i == 0:
            # every rank of a split state gathers; rank 0 writes
            path = os.path.abspath(os.path.join(resume_dir, "ckpt_000000001"))
            if state.tp is not None or rank() == 0:
                path = save_checkpoint(resume_dir, 1, state)
            if mesh is not None:
                barrier()  # the file is whole before any rank reads it
            state = restore_checkpoint(path, new_state())
    # AdamW's state i belongs to the i-th parameter
    return {"metrics": metrics, "ms": ms, "states": states, "launches": _since(before),
            "all_reduces": reduces, "params": [n for n, _ in state.model.named_parameters()]}


HELD = 2e-3  # a coordinate is held where |m| > HELD x its tensor's largest at every step


def compare_train(run: dict, ref: dict) -> dict:
    """``run`` against the one-process ``ref``: each step's relative loss
    error; after the last step, the largest per-tensor error of AdamW's
    first moment (relative to the tensor's largest), and the relative L2
    error of the parameters' updates at the held coordinates, all tensors
    together. A coordinate whose gradient is rounding noise at some step
    (the key bias, which softmax cancels) takes an Adam step of either sign
    in both runs, so only the held ones are compared; ``held`` is their
    share."""
    loss_rel = [abs(a["loss"] - b["loss"]) / abs(b["loss"])
                for a, b in zip(run["metrics"], ref["metrics"])]
    last, ref_last, init = run["states"][-1], ref["states"][-1], ref["states"][0]
    moment, held = 0.0, {}
    for state in ref["states"][1:]:
        for i, s in state["optimizer"]["state"].items():
            mr = s["exp_avg"].abs()
            keep = held.get(i, torch.ones_like(mr, dtype=torch.bool))
            held[i] = keep & (mr > HELD * mr.max())
    for i, s in ref_last["optimizer"]["state"].items():
        m, mr = last["optimizer"]["state"][i]["exp_avg"], s["exp_avg"]
        moment = max(moment, float((m - mr).abs().max() / mr.abs().max().clamp_min(1e-30)))
    num = den = n_held = n_all = 0.0
    for i, k in enumerate(ref["params"]):
        keep = held.get(i)
        if keep is None:  # no gradient reached it
            continue
        p0 = init["model"][k]
        d, dr = (last["model"][k] - p0) * keep, (ref_last["model"][k] - p0) * keep
        num += float(((d - dr).double() ** 2).sum())
        den += float((dr.double() ** 2).sum())
        n_held, n_all = n_held + int(keep.sum()), n_all + keep.numel()
    return {"loss_rel": loss_rel, "moment_err": moment,
            "update_err": (num / max(den, 1e-300)) ** 0.5, "held": n_held / max(n_all, 1)}


def _layout(path: str) -> dict:
    """A checkpoint's tensors' names and shapes, by part of the state."""
    sd = torch.load(path, weights_only=True)
    shapes = lambda d: {str(k): tuple(v.shape) for k, v in d.items() if isinstance(v, torch.Tensor)}
    return {"model": shapes(sd["model"]), "ema_params": shapes(sd["ema_params"] or {}),
            "moments": {f"{i}.{k}": tuple(v.shape) for i, st in sd["optimizer"]["state"].items()
                        for k, v in st.items()}}


def check_train(args, device) -> dict:
    inputs = torch.load(args.inputs, weights_only=False) if args.inputs else {}
    cfg = model_config(args)
    batch = inputs.get("batch") or global_batch(args, cfg)
    init = inputs.get("state_dict") or MDM(cfg).init_weights(
        torch.Generator().manual_seed(args.seed)).state_dict()
    draws = inputs.get("draws")
    tp = args.model_parallel > 1
    mesh = make_mesh(model_parallel=args.model_parallel, device=device)
    name = "tp" if tp else "dp"
    runs = {name: run_train(args, cfg, batch, init, draws, mesh, device)}
    if args.control:
        with model_offsets_pinned_at_zero() if tp else offset_pinned_at_zero():
            runs["control"] = run_train(args, cfg, batch, init, draws, mesh, device)
    resume_dirs = [os.path.join(args.out, d) for d in ("resume_mesh", "resume_one")]
    if args.save_resume:
        runs["resumed"] = run_train(args, cfg, batch, init, draws, mesh, device, resume_dirs[0])
    import torch.distributed as dist

    per_rank = [None] * world_size()
    dist.all_gather_object(per_rank, {
        run: {"metrics": r["metrics"], "ms": r["ms"], "launches": r["launches"],
              "all_reduces": r["all_reduces"]} for run, r in runs.items()})
    out = {}
    if rank() == 0:
        # TP's route in one process: the einsum attention and the plain tail
        route = ops.pinned(train_block=False, encoder_tail=False) if tp else contextlib.nullcontext()
        with route:
            runs["reference"] = run_train(args, cfg, batch, init, draws, None, device,
                                          resume_dirs[1] if args.save_resume else "")
        out = {"summary": {name: compare_train(r, runs["reference"])
                           for name, r in runs.items() if name != "reference"},
               "ms": {name: r["ms"] for name, r in runs.items()},
               "launches": {name: r["launches"] for name, r in runs.items()},
               "metrics": {name: r["metrics"] for name, r in runs.items()},
               "mesh": {"model_parallel": mesh.model_parallel,
                        "data_parallel": mesh.data_parallel},
               "ranks": per_rank}
        if args.save_resume:
            ckpt = [_layout(os.path.join(d, "ckpt_000000001")) for d in resume_dirs]
            last = [runs[k]["states"][-1] for k in ("resumed", name)]
            out["save_resume"] = {
                "same_layout_as_one_process": ckpt[0] == ckpt[1],
                "resumed_equals_uninterrupted": all(
                    torch.equal(a, b) for a, b in zip(*(_leaves(s) for s in last)))}
        if args.keep:
            out["states"] = {name: r["states"] for name, r in runs.items()}
    return out


def _leaves(tree) -> list:
    """Every tensor of a nested state dict, in key order."""
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, dict):
        return [t for k in sorted(tree, key=str) for t in _leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [t for v in tree for t in _leaves(v)]
    return []


def _sample_inputs(args, cfg, inputs, device):
    B, T = args.batch, args.frames
    rng = np.random.default_rng(args.seed)
    text = inputs.get("text_embed")
    if text is None:
        text = rng.normal(size=(B, 512)).astype(np.float32)
    noise = inputs.get("noise")
    if noise is None:
        noise = rng.normal(size=(B, T, cfg.njoints)).astype(np.float32)
    cond = Conditioning(text_embed=torch.as_tensor(text).to(device),
                        frames_mask=torch.ones(B, T, dtype=torch.bool, device=device))
    return cond, torch.as_tensor(noise).to(device)


def _diff(a: torch.Tensor, b: torch.Tensor) -> dict:
    return {"equal": bool(torch.equal(a, b)),
            "max_abs": float((a.float() - b.float()).abs().max()),
            "scale": float(b.float().abs().max())}


def check_sample(args, device) -> dict:
    inputs = torch.load(args.inputs, weights_only=False) if args.inputs else {}
    checks = args.checks.split(",")
    cfg = model_config(args, arch="trans_enc", dropout=0.0)
    model = MDM(cfg)
    model.load_state_dict(inputs.get("state_dict") or MDM(cfg).init_weights(
        torch.Generator().manual_seed(args.seed)).state_dict())
    model = model.to(device).eval()
    sched = Schedule.create("cosine", 1000, str(args.steps))
    ddim = GenerationConfig(sampler="ddim", guidance_scale=2.5)
    B, T = args.batch, args.frames
    cond, noise = _sample_inputs(args, cfg, inputs, device)
    gen = lambda: torch.Generator(device).manual_seed(args.seed + 1)
    primary = rank() == 0
    out, keep = {}, {}
    dp_mesh = make_mesh(device=device) if {"dp", "ar", "ddpm"} & set(checks) else None

    if "dp" in checks:
        before = launch_counts()
        dp = MotionGenerator(model, sched, ddim, mesh=dp_mesh).sample_features(
            cond, B, T, gen(), noise=noise)
        out["dp_launches"] = _since(before)
        if primary:
            one = MotionGenerator(model, sched, ddim).sample_features(cond, B, T, gen(),
                                                                      noise=noise)
            out["dp_ddim"] = _diff(dp, one)
            keep.update(dp_ddim=dp.cpu(), one_ddim=one.cpu())
    if "ar" in checks:
        dcfg = model_config(args, arch="trans_dec", dropout=0.0, pred_len=4, context_len=4)
        dip = MDM(dcfg).init_weights(torch.Generator().manual_seed(args.seed)).to(device).eval()
        rng = np.random.default_rng(args.seed + 2)
        L, req = 5, 2 * dcfg.pred_len
        t = lambda a: torch.as_tensor(a).to(device)
        dcond = Conditioning(
            text_embed=t(rng.normal(size=(B, L, 768)).astype(np.float32)),
            text_tokens_mask=t(np.arange(L)[None] < rng.integers(1, L + 1, size=(B, 1))),
            frames_mask=torch.ones(B, dcfg.pred_len, dtype=torch.bool, device=device),
            prefix=t(rng.normal(size=(B, dcfg.context_len, 263)).astype(np.float32)))
        chunk_noise = t(rng.normal(size=(2, B, dcfg.pred_len, 263)).astype(np.float32))
        ar = GenerationConfig(sampler="ddim", guidance_scale=2.5, autoregressive=True)
        dp = MotionGenerator(dip, sched, ar, mesh=dp_mesh).sample_autoregressive(
            dcond, B, gen(), required_frames=req, chunk_noise=chunk_noise)
        if primary:
            one = MotionGenerator(dip, sched, ar).sample_autoregressive(
                dcond, B, gen(), required_frames=req, chunk_noise=chunk_noise)
            out["dp_ar"] = _diff(dp, one)
    if "ddpm" in checks:
        half = B // 2
        twin = lambda v: torch.cat([v[:half], v[:half]])
        tcond = cond.replace(text_embed=twin(cond.text_embed), frames_mask=twin(cond.frames_mask))
        sample = MotionGenerator(model, sched, GenerationConfig(guidance_scale=2.5),
                                 mesh=dp_mesh).sample_features(tcond, B, T, gen(),
                                                               noise=twin(noise))
        if primary:
            out["dp_ddpm"] = {"finite": bool(torch.isfinite(sample).all()),
                              "halves_differ": not torch.equal(sample[:half], sample[half:]),
                              "halves_max_abs": float((sample[:half] - sample[half:]).abs().max())}
    if "tp" in checks:
        tp_mesh = make_mesh(model_parallel=world_size(), device=device)
        stop, before = _timer(device), launch_counts()
        tp = MotionGenerator(model, sched, ddim, mesh=tp_mesh).sample_features(
            cond, B, T, gen(), noise=noise)
        tp_ms = stop()
        out["tp_launches"] = _since(before)  # no hand kernel runs under TP
        if primary:
            # TP's route (einsum attention, plain tail) in one process: the
            # same rounding points, the row-parallel sums' order aside
            one = MotionGenerator(model, sched, ddim)
            with ops.pinned(sample_block=False, encoder_tail=False, layer_inference=False):
                stop = _timer(device)
                plain = one.sample_features(cond, B, T, gen(), noise=noise)
                plain_ms = stop()
            kernels = one.sample_features(cond, B, T, gen(), noise=noise)
            out["tp_ddim"] = dict(_diff(tp, plain), ms=tp_ms, one_ms=plain_ms)
            out["tp_vs_kernel_route"] = _diff(tp, kernels)
            out["plain_vs_kernel_route"] = _diff(plain, kernels)
            keep.update(tp_ddim=tp.cpu(), one_tp_ddim=plain.cpu())
    if "serve" in checks:
        from ..serving import Predictor, PredictorConfig

        p = Predictor(PredictorConfig(
            tensor_parallel=world_size(), device=args.device, latent_dim=args.latent_dim,
            layers=args.layers, num_diffusion_steps=20, respacing=str(args.steps),
            max_frames=T, fps=20.0, compute_dtype=args.dtype, text_encoder_type="hash"))
        p.setup()
        joints = torch.tensor(p.predict("a person walks", motion_length_sec=T / 20.0,
                                        seed=3)["joints"][0])
        mesh = p.generator.mesh
        import torch.distributed as dist

        every = torch.zeros((world_size(),) + tuple(joints.shape), dtype=joints.dtype,
                            device=mesh.device)
        every[rank()] = joints
        dist.all_reduce(every)  # each rank's answer in its own row
        every = every.cpu()
        if primary:
            out["serve_tp"] = {"ranks": world_size(), "shape": list(joints.shape),
                               "finite": bool(torch.isfinite(every).all()),
                               "same_on_every_rank": all(torch.equal(every[0], e)
                                                         for e in every),
                               "heads_per_rank": p.generator.model.seqTransEncoder.layers[0]
                               .self_attn.num_heads, "model_parallel": mesh.model_parallel}
    if primary and args.keep:
        out["samples"] = keep
    return out


def main(argv=None):
    args = parse(argv)
    maybe_initialize_distributed()
    device = torch.device(args.device)
    if device.type == "cuda":
        from ..parallel.multihost import local_device

        if not torch.cuda.is_available():
            raise RuntimeError("parallel_check --device cuda: no CUDA device is visible "
                               "(--device cpu runs the checks on the CPU)")
        device = local_device()
        torch.cuda.set_device(device)
    if world_size() < 2:
        raise RuntimeError("parallel_check runs in a world of two ranks or more "
                           "(launch_local_multihost, torchrun)")
    out = (check_train if args.check == "train" else check_sample)(args, device)
    if rank() == 0:
        os.makedirs(args.out, exist_ok=True)
        torch.save(out, os.path.join(args.out, f"{args.check}.pt"))
        printable = {k: v for k, v in out.items() if k not in ("states", "samples", "metrics")}
        print(f"parallel_check {args.check} {json.dumps(printable)}", flush=True)
    barrier()


if __name__ == "__main__":
    main()
