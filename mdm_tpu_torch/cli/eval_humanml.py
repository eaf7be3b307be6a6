"""T2M evaluation entry point: `python -m mdm_tpu_torch.cli.eval_humanml`.

Counterpart of mdm_tpu/cli/eval_humanml.py (reference eval/eval_humanml.py)
on one device: ``--device N`` (the default, 0) generates and embeds on
``cuda:N``, where every denoise step runs the hand-written kernels;
``--device cpu`` on the CPU. Protocol: batch 32, eval modes debug (5
replications) / wo_mm (20) / mm_short (5 + multimodality) / full, frozen
evaluator encoders (``--evaluator_dir``: the reference's finest.tar or a
finest.npy of either package), generated-vs-GT metrics, mean +- CI log.
It loads a checkpoint that mdm_tpu_torch's ``cli.train`` wrote (a run
directory: its highest step), its EMA weights when args.json says the run
kept them, and writes ``eval_<ckpt>_<mode>_gscale<g>.log`` / ``.json``
beside it with mdm_tpu's names and keys. ``--autoregressive`` runs DiP's
protocol (fixed-length prefix windows, chunked generation to each clip's
original length); ``--t2m_baseline_path`` scores the T2M baseline too.
"""
from __future__ import annotations

import os

import numpy as np
import torch


def load_eval_model(args, device, num_actions: int = 1):
    """The checkpoint's model on ``device``: a run directory resolves to its
    highest step; EMA weights only when the run kept them (the model-group
    flag rides args.json; reference model_util.py:118-122)."""
    from ..train.checkpoints import find_resume_checkpoint, restore_params_only
    from ..utils.factory import create_model_and_schedule

    model, sched = create_model_and_schedule(args, num_actions)
    model = model.init_weights(torch.Generator().manual_seed(0)).to(device)
    ckpt = args.model_path
    if os.path.isdir(ckpt) and not os.path.basename(ckpt).startswith("ckpt_"):
        found = find_resume_checkpoint(ckpt)
        if not found:
            raise FileNotFoundError(f"no checkpoint under {ckpt}")
        ckpt = found[0]
    restore_params_only(ckpt, model, use_ema=bool(getattr(args, "use_ema", False)))
    return model, sched, ckpt


def main(argv=None):
    from ..data import BatchIterator, WordVectorizer, get_dataset
    from ..eval import EvalConfig, EvaluatorWrapper, GeneratedMotionLoader, evaluation
    from ..eval.harness import MMGeneratedLoader
    from ..sampling import GenerationConfig, MotionGenerator
    from ..sampling.pipeline import dataset_norm_stats
    from ..sampling.text import make_text_embedder
    from ..utils.parser import evaluation_args, select_device

    args = evaluation_args(argv)
    device = select_device(args)
    mode = args.eval_mode
    replication_times = (args.replications or
                         {"debug": 5, "wo_mm": 20, "mm_short": 5, "full": 20}[mode])
    run_mm = mode in ("mm_short", "full")

    # Ground-truth loader (evaluator normalization) with GloVe vectorizer.
    glove_dir = os.path.join(args.data_dir or "dataset", "..", "glove")
    w_vec = None
    if os.path.exists(os.path.join(glove_dir, "our_vab_data.npy")):
        w_vec = WordVectorizer(glove_dir, "our_vab")
    # DiP (autoregressive) evaluation feeds fixed-length prefix windows
    # (reference eval_humanml.py:295-300 with fixed_len loaders).
    fixed_len = (args.context_len + args.pred_len) if args.autoregressive else 0
    dataset = get_dataset(
        args.dataset, split=args.eval_split if hasattr(args, "eval_split") else "test",
        hml_mode="eval", data_root=args.data_dir or None,
        fixed_len=fixed_len,
    )
    dataset.w_vectorizer = w_vec
    gt_batches = list(BatchIterator(
        dataset, 32, shuffle=True, seed=0, infinite=False,
        pred_len=args.pred_len if args.autoregressive else 0,
    ))

    model, sched, ckpt = load_eval_model(args, device)
    train_stats = dataset_norm_stats(args.data_dir or None)
    eval_mean, eval_std = dataset.mean, dataset.std  # evaluator-family stats
    # The single-device port passes no mesh (data-parallel sampling is
    # ROADMAP Queue 1 item 10).
    gen = MotionGenerator(
        model, sched,
        GenerationConfig(guidance_scale=args.guidance_param,
                         autoregressive=args.autoregressive),
        args.dataset,
        norm_stats=train_stats,
    )
    embedder = make_text_embedder(args.text_encoder_type, device=device)

    def text_embedder(texts):
        if embedder is None:
            return {"text_embed": np.zeros((len(texts), model.config.text_dim), np.float32)}
        return embedder(texts)

    eval_wrapper = EvaluatorWrapper(args.dataset, checkpoints_dir=args.evaluator_dir,
                                    device=device)

    log_file = os.path.join(
        os.path.dirname(ckpt),
        f"eval_{os.path.basename(ckpt)}_{mode}_gscale{args.guidance_param}.log",
    )
    stats = dict(model_mean=train_stats[0] if train_stats else None,
                 model_std=train_stats[1] if train_stats else None,
                 eval_mean=eval_mean, eval_std=eval_std)
    mm_loader_fns = None
    if run_mm:
        mm_loader_fns = {
            "vald": lambda rep: MMGeneratedLoader(gen, gt_batches, text_embedder, seed=rep,
                                                  **stats)
        }
    eval_motion_loader_fns = {
        "vald": lambda rep: GeneratedMotionLoader(gen, gt_batches, text_embedder, seed=rep,
                                                  **stats)
    }
    if args.t2m_baseline_path:
        # Score the original T2M (Guo et al.) baseline generator alongside
        # MDM (reference motion_loaders/model_motion_loaders.py:50-73).
        from ..eval.t2m_generator import (
            T2MBaselineGenerator, T2MBaselineLoader, T2MBaselineMMLoader,
            load_comp_v6, load_len_estimator,
        )

        baseline_gen = T2MBaselineGenerator(
            load_comp_v6(args.t2m_baseline_path),
            load_len_estimator(args.t2m_len_est_path),
            dim_pose=model.config.input_feats,
            min_mov_length=10 if args.dataset == "humanml" else 6,
            device=device,
        )
        eval_motion_loader_fns["t2m_baseline"] = lambda rep: T2MBaselineLoader(
            baseline_gen, gt_batches, seed=rep)
        if run_mm:
            mm_loader_fns["t2m_baseline"] = lambda rep: T2MBaselineMMLoader(
                baseline_gen, gt_batches, seed=rep)
    summary = evaluation(
        eval_wrapper,
        gt_loader_fn=lambda: iter(gt_batches),
        eval_motion_loader_fns=eval_motion_loader_fns,
        config=EvalConfig(
            replication_times=replication_times, run_mm=run_mm, log_file=log_file
        ),
        mm_loader_fns=mm_loader_fns,
    )
    if not w_vec and "zero-glove-text-features" not in summary.get("degraded_reasons", []):
        summary["comparable"] = False
        summary.setdefault("degraded_reasons", []).append("no-glove-vectorizer")
    _write_summary_json(log_file.replace(".log", ".json"), summary)
    return summary


def _write_summary_json(path: str, summary: dict) -> None:
    """Machine-readable eval output with the `comparable` stamp."""
    import json

    def clean(v):
        if isinstance(v, dict):
            return {k: clean(x) for k, x in v.items()}
        if isinstance(v, (list, tuple)):
            return [clean(x) for x in v]
        if isinstance(v, np.ndarray):
            return v.tolist()
        if isinstance(v, (np.floating, np.integer)):
            return v.item()
        return v

    with open(path, "w") as f:
        json.dump(clean(summary), f, indent=1)


if __name__ == "__main__":
    main()
