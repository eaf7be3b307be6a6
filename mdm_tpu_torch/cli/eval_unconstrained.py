"""Unconstrained-generation evaluation: `python -m mdm_tpu_torch.cli.eval_unconstrained`.

Counterpart of mdm_tpu/cli/eval_unconstrained.py (reference
eval/eval_humanact12_uestc.py --unconstrained + eval/unconstrained/
evaluate.py) on one device: ``--device N`` (the default, 0) or ``--device
cpu``. Over HumanAct12's batches (seed 0) it generates as many
unconditioned motions, decodes both sides to xyz (SMPL, or the pseudo-joint
fallback stamped ``no-smpl-asset``), takes the openpose-15 joint subset
centred on the first frame's mid-hip, and reads the modi-15 STGCN's
features (the reference's frozen checkpoint, a self-trained one with
``--a2m_classifier_path``, or a random init stamped degraded): FID / KID /
precision-recall / diversity against the ground truth, written to
``eval_unconstrained.json`` beside the checkpoint. Under a
torch.distributed world each rank generates its rows of every batch
(``auto_mesh``) and rank 0 writes the result.
"""
from __future__ import annotations

import json
import os


def main(argv=None):
    import torch

    from ..data import BatchIterator, get_dataset
    from ..eval.a2m_setup import load_reference_state_dict, unconstrained_xyz_fn
    from ..eval.harness_a2m import UNCONSTRAINED_JOINT_SUBSET, evaluate_unconstrained_metrics
    from ..eval.networks import f32_math, load_flax_params, reset_seeded
    from ..eval.stgcn import STGCN, STGCNConfig, convert_stgcn
    from ..models.mdm import Conditioning
    from ..parallel.multihost import is_primary, maybe_initialize_distributed
    from ..sampling import GenerationConfig, MotionGenerator, auto_mesh
    from ..utils.parser import evaluation_args, select_device
    from .eval_humanml import load_eval_model

    maybe_initialize_distributed()  # a world samples data-parallel (auto_mesh)
    args = evaluation_args(argv)
    device = select_device(args)
    args.cond_mode = "no_cond"  # whatever the checkpoint's args.json says
    num_frames = 60
    dataset = get_dataset("humanact12", num_frames=num_frames, data_root=args.data_dir or None)
    model, sched, ckpt = load_eval_model(args, device, dataset.num_actions)
    B = args.batch_size
    gen = MotionGenerator(model, sched, GenerationConfig(guidance_scale=1.0), "humanact12",
                          mesh=auto_mesh(device))

    degraded = []
    get_xyz, xyz_degraded = unconstrained_xyz_fn(num_frames, device=device)
    if xyz_degraded:
        # Without the SMPL asset there is no xyz decode; pseudo-joint
        # features keep the protocol running, stamped non-comparable.
        print("WARNING: SMPL asset missing; pseudo-joint features")
        degraded.append("no-smpl-asset")

    # The STGCN feature extractor: the reference's checkpoint when present;
    # else a self-trained modi-15 STGCN (--a2m_classifier_path, from
    # `train_evaluators --stage unconstrained_stgcn`), stamped
    # non-comparable; else a random init.
    num_class = 12
    self_trained = bool(args.a2m_classifier_path)
    clf_path = os.path.join("assets", "actionrecognition", "humanact12_gru_modi_struct.pth.tar")
    blob = None
    if self_trained:
        from ..eval.train_evaluators import load_evaluator_params

        blob = load_evaluator_params(args.a2m_classifier_path)
        assert blob.get("arch") == "stgcn_modi15", (
            f"--a2m_classifier_path {args.a2m_classifier_path} is not an "
            f"unconstrained_stgcn evaluator (arch={blob.get('arch')!r}); "
            f"train one with `train_evaluators --stage unconstrained_stgcn`")
        num_class = int(blob["num_actions"])
    stg_cfg = STGCNConfig(in_channels=3, num_class=num_class, layout="openpose_modi15",
                          edge_importance=True)
    stgcn = STGCN(stg_cfg)
    if blob is not None:
        load_flax_params(stgcn, blob["params"])
    elif os.path.exists(clf_path):
        stgcn.load_state_dict(convert_stgcn(load_reference_state_dict(clf_path), stg_cfg))
    else:
        print(f"WARNING: {clf_path} missing; random STGCN features")
        degraded.append("random-init-stgcn-features")
        reset_seeded(stgcn, 1)
    stgcn = stgcn.to(device).eval()

    @torch.no_grad()
    @f32_math()
    def features_for(motions_xyz):
        # [B, T, 24, 3] -> the openpose-15 subset, centred on the first
        # frame's mid-hip
        sub = motions_xyz[:, :, UNCONSTRAINED_JOINT_SUBSET]
        return stgcn(sub - sub[:, :1, 8:9])["features"]

    cond0 = Conditioning(frames_mask=torch.ones((B, num_frames), dtype=torch.bool))
    noise = torch.Generator(device).manual_seed(args.seed)
    gt_feats, gen_feats = [], []
    for batch in BatchIterator(dataset, B, seed=0, infinite=False):
        gt_feats.append(features_for(get_xyz(batch["x"])))
        feats = gen.sample_features(cond0, B, num_frames, noise)
        gen_feats.append(features_for(get_xyz(feats)))

    metrics = evaluate_unconstrained_metrics(
        torch.cat(gen_feats).cpu().numpy(), torch.cat(gt_feats).cpu().numpy(),
        fast=(args.eval_mode == "debug"),
    )
    # Not comparable to the published tables when degraded or when scoring
    # with a self-trained feature extractor (another metric model).
    metrics["comparable"] = not degraded and not self_trained
    metrics["classifier"] = ("self-trained" if self_trained
                             else "random-init" if "random-init-stgcn-features" in degraded
                             else "reference-frozen")
    if degraded:
        metrics["degraded_reasons"] = degraded
    out_path = os.path.join(os.path.dirname(ckpt), "eval_unconstrained.json")
    if is_primary():
        with open(out_path, "w") as f:
            json.dump(metrics, f, indent=2)
    print(json.dumps(metrics, indent=2))
    return metrics


if __name__ == "__main__":
    main()
