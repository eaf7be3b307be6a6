"""Action-to-motion evaluation: `python -m mdm_tpu_torch.cli.eval_a2m`.

Counterpart of mdm_tpu/cli/eval_a2m.py (reference
eval/eval_humanact12_uestc.py) on one device: ``--device N`` (the default,
0) generates, decodes and classifies on ``cuda:N``, every denoise step on
the hand-written kernels; ``--device cpu`` on the CPU. Per seed: gen / gt
/ gt2 megabatches (the GT passes and generation over the GT actions, xyz
through SMPL's rot2xyz), the classifier (HumanAct12's GRU, UESTC's STGCN:
the reference's frozen ``.tar``, a self-trained one with
``--a2m_classifier_path``, or a random init stamped degraded), accuracy /
FID / diversity / multimodality, summarized over the seeds (debug: 2,
else 20; ``--replications`` overrides). The summary, with mdm_tpu's
``comparable`` / ``classifier`` / ``degraded_reasons`` stamps, goes to
``eval_a2m_<dataset>.json`` beside the checkpoint. Under a
torch.distributed world each rank generates its rows of every batch
(``auto_mesh``) and rank 0 writes the summary.
"""
from __future__ import annotations

import json
import os


def main(argv=None):
    from ..data import get_dataset
    from ..eval.a2m_setup import build_feature_and_classifier, make_a2m_loaders_factory
    from ..eval.harness_a2m import A2MEvalConfig, A2MEvaluation, evaluate_multi_seed
    from ..parallel.multihost import is_primary, maybe_initialize_distributed
    from ..sampling import GenerationConfig, MotionGenerator, auto_mesh
    from ..utils.parser import evaluation_args, select_device
    from .eval_humanml import load_eval_model

    maybe_initialize_distributed()  # a world samples data-parallel (auto_mesh)
    args = evaluation_args(argv)
    device = select_device(args)
    assert args.dataset in ("humanact12", "uestc")
    num_frames = 60
    dataset = get_dataset(args.dataset, num_frames=num_frames, data_root=args.data_dir or None)
    num_actions = dataset.num_actions

    model, sched, ckpt = load_eval_model(args, device, num_actions)
    B = args.batch_size
    gen = MotionGenerator(model, sched, GenerationConfig(guidance_scale=args.guidance_param),
                          args.dataset, mesh=auto_mesh(device))

    # UESTC's STGCN classifier consumes rot6d features (without the
    # translation row, stgcn_eval.py:58-60); HumanAct12's GRU consumes xyz
    # (raw features, stamped degraded, when the SMPL asset is absent).
    feature_input, clf, degraded = build_feature_and_classifier(
        args.dataset, num_actions, num_frames, model.config.input_feats,
        classifier_path=args.a2m_classifier_path, chunk=B, device=device)
    self_trained = bool(args.a2m_classifier_path)
    make_loaders = make_a2m_loaders_factory(dataset, gen, B, num_frames, feature_input)

    ev = A2MEvaluation(clf, config=A2MEvalConfig(num_classes=num_actions))
    num_seeds = args.replications or {"debug": 2}.get(args.eval_mode, 20)
    summary = evaluate_multi_seed(make_loaders, ev, num_seeds=num_seeds)
    # Runs that do not use the reference's frozen classifier are stamped
    # non-comparable to the published tables: random-init (degraded) or
    # self-trained (functional, but another metric model).
    summary["comparable"] = not degraded and not self_trained
    summary["classifier"] = ("self-trained" if self_trained
                             else "random-init" if degraded
                             else "reference-frozen")
    if degraded:
        summary["degraded_reasons"] = ["random-init-a2m-classifier"]

    out_path = os.path.join(os.path.dirname(ckpt), f"eval_a2m_{args.dataset}.json")
    if is_primary():
        with open(out_path, "w") as f:
            json.dump(summary, f, indent=2)
    print(json.dumps(summary, indent=2))
    return summary


if __name__ == "__main__":
    main()
