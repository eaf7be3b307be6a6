"""Train the T2M evaluator networks: `python -m mdm_tpu_torch.cli.train_evaluators`.

Counterpart of mdm_tpu/cli/train_evaluators.py (reference trainers.py —
DecompTrainerV3, TextMotionMatchTrainer, LengthEstTrainer) on one device:
``--device N`` (the default, 0) trains on ``cuda:N``, ``--device cpu`` on
the CPU. Stages:

  --stage decomp   movement conv autoencoder (run first)
  --stage match    contrastive text/motion encoders (needs --decomp_path)
  --stage length   motion-length estimator
  --stage a2m_classifier  the action classifier the a2m protocol scores
                   with (the reference ships it only frozen): humanact12,
                   the GRU on SMPL xyz (on the raw rot6d features when the
                   SMPL asset is absent); uestc, the STGCN on rot6d
  --stage unconstrained_stgcn  the modi-15 STGCN feature extractor of the
                   unconstrained protocol, on root-centred openpose-15 xyz

`--stage match` writes a `finest.npy` that `EvaluatorWrapper` (of either
package) loads directly, so a user can produce metric encoders for a NEW
dataset without any reference checkpoint; the a2m stages write the .npy
that ``cli.eval_a2m`` / ``cli.eval_unconstrained`` take as
``--a2m_classifier_path``, with the architecture and representation
recorded in it. Every output is in mdm_tpu's npy layout. ``comp_v6``
(training the T2M baseline generator) raises, naming ROADMAP Queue 1
item 12.
"""
from __future__ import annotations

import os

import numpy as np

NOT_PORTED = {
    "comp_v6": "training the T2M baseline generator (eval/train_t2m_generator.py) is not "
               "ported yet: ROADMAP Queue 1 item 12",
}


def _batches(dataset, batch_size, stage, seed=0):
    """Host batches of the stage: numpy arrays (motions for decomp, the text
    features, lengths and the match step's shift otherwise)."""
    from ..data import BatchIterator

    rng = np.random.default_rng(seed)
    while True:
        it = BatchIterator(dataset, batch_size, shuffle=True, seed=seed,
                           infinite=False)
        for b in it:
            if stage == "decomp":
                yield {"motions": b["x"]}
                continue
            batch = {
                "word_embs": b.get("word_embeddings",
                                   np.zeros((batch_size, 22, 300), np.float32)),
                "pos_onehot": b.get("pos_one_hots",
                                    np.zeros((batch_size, 22, 15), np.float32)),
                "cap_lens": np.maximum(np.asarray(b.get("sent_lens",
                                                        np.full(batch_size, 4))), 1),
                "m_lens": np.asarray(b["lengths"], np.int32),
            }
            if stage == "match":
                batch["motions"] = b["x"]
                # np.random.randint(0, B-1) (trainers.py:975): [0, B-2];
                # shift 0 makes the "negative" pairs the positives — a
                # reference quirk kept for checkpoint comparability.
                batch["shift"] = np.asarray(int(rng.integers(0, max(1, batch_size - 1))))
            yield batch
        seed += 1


def _classifier_batches(dataset, batch_size, seed, to_inputs, device):
    """Endless epochs of the classifier's batches on ``device``: inputs,
    lengths and action labels."""
    import torch

    from ..data import BatchIterator

    while True:
        for b in BatchIterator(dataset, batch_size, shuffle=True, seed=seed, infinite=False):
            yield {"x": to_inputs(b["x"]),
                   "lengths": torch.as_tensor(np.asarray(b["lengths"], np.int32)).to(device),
                   "y": torch.as_tensor(np.asarray(b["action"], np.int32)).to(device)}
        seed += 1


def _fit_classifier(args, clf, input_size, num_frames, example_x, batches, device):
    from ..data.loader import cache_device_batches
    from ..eval.train_evaluators import EvalTrainConfig, make_a2m_classifier_step, run_training

    init, step = make_a2m_classifier_step(clf.to(device), input_size, num_frames,
                                          EvalTrainConfig(lr=args.lr), example_x=example_x)
    if args.cache_batches > 0:
        batches = cache_device_batches(batches, args.cache_batches, device=device)
    params, _ = run_training(init, step, batches, args.num_steps, args.seed,
                             log_every=args.log_every)
    return params


def _train_a2m_classifier(args, device):
    """--stage a2m_classifier (mdm_tpu/cli/train_evaluators.py:76-159):
    humanact12, the GRU MotionDiscriminator on SMPL xyz when the SMPL asset
    is present (eval/a2m/gru_eval.py feeds batch['output_xyz']), else on the
    raw rot6d features; uestc, the STGCN on rot6d [B, T, 24, 6], the
    protocol's own architecture and representation (stgcn_eval.py:58-60).
    The representation and the architecture are saved with the weights."""
    import torch

    from ..data import get_dataset
    from ..eval.a2m_setup import StgcnAdapter, make_a2m_feature_input, raw_features
    from ..eval.classifiers import MotionDiscriminator
    from ..eval.stgcn import STGCN, STGCNConfig
    from ..eval.train_evaluators import save_evaluator_params

    num_frames = 60
    dataset = get_dataset(args.dataset, num_frames=num_frames, data_root=args.data_dir or None)
    hidden_size, hidden_layers = 128, 2
    if args.dataset == "uestc":
        feature_input, feature = make_a2m_feature_input("uestc", device=device), "rot6d"
    else:
        try:
            feature_input, feature = make_a2m_feature_input(args.dataset, device=device), "xyz"
        except FileNotFoundError as e:
            print(f"a2m_classifier: SMPL asset missing ({e}); training on raw rot6d features")
            feature_input, feature = raw_features(device), "raw"
    feat_dim = dataset.sample(0, np.random.default_rng(0))["motion"].shape[-1]
    probe = feature_input(np.zeros((1, num_frames, feat_dim), np.float32))
    input_size = int(probe.shape[-1])
    if feature == "rot6d":
        arch, clf = "stgcn", StgcnAdapter(STGCN(STGCNConfig(
            in_channels=input_size, num_class=dataset.num_actions, layout="smpl")))
    else:
        arch, clf = "gru", MotionDiscriminator(input_size, hidden_size, hidden_layers,
                                               dataset.num_actions)
    batches = _classifier_batches(dataset, args.batch_size, args.seed, feature_input, device)
    params = _fit_classifier(args, clf, input_size, num_frames, torch.zeros_like(probe),
                             batches, device)
    save_evaluator_params(args.save_path, {
        "params": {"params": params}, "input_size": input_size, "feature": feature,
        "num_actions": dataset.num_actions, "arch": arch,
        "hidden_size": hidden_size, "hidden_layers": hidden_layers,
    })


def _train_unconstrained_stgcn(args, device):
    """--stage unconstrained_stgcn (mdm_tpu/cli/train_evaluators.py:162-235):
    the modified-structure 15-joint STGCN of the unconstrained protocol (the
    reference ships it only frozen, humanact12_gru_modi_struct.pth.tar),
    trained as an action classifier on root-centred openpose-15 xyz; its
    penultimate features feed FID / KID / precision-recall. The xyz decode
    is cli.eval_unconstrained's (a2m_setup.unconstrained_xyz_fn)."""
    import torch

    from ..data import get_dataset
    from ..eval.a2m_setup import StgcnAdapter, unconstrained_xyz_fn
    from ..eval.harness_a2m import UNCONSTRAINED_JOINT_SUBSET
    from ..eval.stgcn import STGCN, STGCNConfig
    from ..eval.train_evaluators import save_evaluator_params

    num_frames = 60
    dataset = get_dataset("humanact12", num_frames=num_frames, data_root=args.data_dir or None)
    get_xyz, degraded = unconstrained_xyz_fn(num_frames, device=device)
    if degraded:
        print("unconstrained_stgcn: SMPL asset missing; training on "
              "pseudo-joint features (stamped in the saved .npy)")

    def to_inputs(feats):
        sub = get_xyz(feats)[:, :, UNCONSTRAINED_JOINT_SUBSET]
        return sub - sub[:, :1, 8:9]  # centred on the first frame's mid-hip

    clf = StgcnAdapter(STGCN(STGCNConfig(in_channels=3, num_class=dataset.num_actions,
                                         layout="openpose_modi15", edge_importance=True)))
    batches = _classifier_batches(dataset, args.batch_size, args.seed, to_inputs, device)
    params = _fit_classifier(args, clf, 3, num_frames, torch.zeros((1, num_frames, 15, 3)),
                             batches, device)
    save_evaluator_params(args.save_path, {
        "params": {"params": params}, "feature": "pseudo" if degraded else "xyz",
        "num_actions": dataset.num_actions, "arch": "stgcn_modi15",
        "layout": "openpose_modi15", "in_channels": 3,
    })


def _on_device(batches, device):
    from ..data.loader import pinned_put

    put = pinned_put(device)
    return (put(b) for b in batches)


def main(argv=None):
    # cuBLAS reads its workspace setting when it starts: a fixed one (the
    # value PyTorch documents for reproducible runs) makes the cuDNN GRUs of
    # the evaluators and classifiers repeat bitwise at a seed
    # (eval/networks.py ``f32_math`` pins the rest). A process that started
    # cuBLAS before this call sets it itself.
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    import argparse

    from ..data import WordVectorizer, get_dataset
    from ..eval.networks import (
        MotionEncoderBiGRUCo,
        MotionLenEstimatorBiGRU,
        MovementConvDecoder,
        MovementConvEncoder,
        TextEncoderBiGRUCo,
        load_flax_params,
    )
    from ..eval.train_evaluators import (
        EvalTrainConfig,
        load_evaluator_params,
        make_decomp_step,
        make_length_est_step,
        make_match_step,
        run_training,
        save_evaluator_params,
    )
    from ..utils.parser import _device_arg, select_device

    ap = argparse.ArgumentParser()
    ap.add_argument("--stage", required=True,
                    choices=["decomp", "match", "length", "comp_v6",
                             "a2m_classifier", "unconstrained_stgcn"])
    ap.add_argument("--dataset", default="humanml",
                    choices=["humanml", "kit", "humanact12", "uestc"])
    ap.add_argument("--data_dir", default="")
    ap.add_argument("--glove_dir", default="glove")
    ap.add_argument("--save_path", required=True)
    ap.add_argument("--decomp_path", default="", help="decomp .npy for --stage match")
    ap.add_argument("--batch_size", type=int, default=32)
    ap.add_argument("--num_steps", type=int, default=10000)
    ap.add_argument("--lr", type=float, default=1e-4)
    ap.add_argument("--negative_margin", type=float, default=10.0)
    ap.add_argument("--unit_length", type=int, default=4)
    ap.add_argument("--movement_dim", type=int, default=512)
    ap.add_argument("--coemb_dim", type=int, default=512)
    ap.add_argument("--num_len_buckets", type=int, default=50)
    ap.add_argument("--log_every", type=int, default=100)
    ap.add_argument("--cache_batches", type=int, default=0,
                    help="device-cache the first N batches and cycle them "
                         "(small datasets / slow host links); 0 = off")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=0, type=_device_arg,
                    help="CUDA device index (default 0), or 'cpu'")
    args = ap.parse_args(argv)

    if args.stage in NOT_PORTED:
        raise NotImplementedError(f"--stage {args.stage}: {NOT_PORTED[args.stage]}")
    if args.stage == "a2m_classifier":
        assert args.dataset in ("humanact12", "uestc"), \
            "--stage a2m_classifier needs an action dataset"
        _train_a2m_classifier(args, select_device(args))
        print(f"saved {args.save_path}")
        return
    if args.stage == "unconstrained_stgcn":
        assert args.dataset == "humanact12", \
            "--stage unconstrained_stgcn is a HumanAct12 protocol"
        _train_unconstrained_stgcn(args, select_device(args))
        print(f"saved {args.save_path}")
        return
    assert args.dataset in ("humanml", "kit"), \
        f"--stage {args.stage} needs a t2m dataset"
    device = select_device(args)

    dim_pose = 263 if args.dataset == "humanml" else 251
    w_vec = None
    if os.path.exists(os.path.join(args.glove_dir, "our_vab_data.npy")):
        w_vec = WordVectorizer(args.glove_dir, "our_vab")
    elif args.stage in ("match", "length"):
        print("WARNING: GloVe vectorizer missing; text features are zeros "
              "(trained encoders will NOT be comparable)")
    dataset = get_dataset(
        args.dataset, split="train", hml_mode="eval",
        data_root=args.data_dir or None,
    )
    dataset.w_vectorizer = w_vec

    cfg = EvalTrainConfig(lr=args.lr, unit_length=args.unit_length,
                          negative_margin=args.negative_margin)
    batches = _batches(dataset, args.batch_size, args.stage, args.seed)
    if args.cache_batches > 0:
        from ..data.loader import cache_device_batches

        batches = cache_device_batches(batches, args.cache_batches, device=device)
    else:
        batches = _on_device(batches, device)
    if args.stage == "decomp":
        # init(seed) draws the weights (networks.reset_seeded)
        enc = MovementConvEncoder(dim_pose - 4, args.movement_dim, args.movement_dim).to(device)
        dec = MovementConvDecoder(args.movement_dim, args.movement_dim, dim_pose).to(device)
        init, step = make_decomp_step(enc, dec, cfg)
        params, _ = run_training(init, step, batches, args.num_steps, args.seed,
                                 log_every=args.log_every,
                                 step_args=lambda b: (b["motions"],))
        save_evaluator_params(args.save_path, dict(params))
    elif args.stage == "length":
        est = MotionLenEstimatorBiGRU(300, 15, 512, args.num_len_buckets).to(device)
        init, step = make_length_est_step(est, cfg)
        params, _ = run_training(init, step, batches, args.num_steps, args.seed,
                                 log_every=args.log_every)
        save_evaluator_params(args.save_path, {"estimator": params})
    else:  # match
        assert args.decomp_path, "--stage match requires --decomp_path"
        movement_params = load_evaluator_params(args.decomp_path)["enc"]
        movement_enc = load_flax_params(
            MovementConvEncoder(dim_pose - 4, args.movement_dim, args.movement_dim),
            movement_params).to(device)
        text_enc = TextEncoderBiGRUCo(300, 15, args.coemb_dim, args.coemb_dim).to(device)
        motion_enc = MotionEncoderBiGRUCo(args.movement_dim, args.coemb_dim * 2,
                                          args.coemb_dim).to(device)
        init, step = make_match_step(text_enc, motion_enc, movement_enc, cfg)
        params, _ = run_training(init, step, batches, args.num_steps, args.seed,
                                 log_every=args.log_every)
        # EvaluatorWrapper-ready layout (finest.npy)
        save_evaluator_params(args.save_path, {
            "movement": {"params": movement_params},
            "text": {"params": params["text"]},
            "motion": {"params": params["motion"]},
        })
    print(f"saved {args.save_path}")


if __name__ == "__main__":
    main()
