"""Shared construction for the a2m eval protocol (classifier + loaders).

Counterpart of mdm_tpu/eval/a2m_setup.py, used by the standalone CLIs
(cli/eval_a2m.py, cli/eval_unconstrained.py), by evaluation during
training (cli/train.py) and by the classifier-training stages
(cli/train_evaluators.py), as the reference shares
eval_humanact12_uestc.evaluate between eval and train
(train/training_loop.py:275-286).

Each pass is one megabatch (the whole eval epoch concatenated on the host,
byte-identical to mdm_tpu's): one copy to the device, one
``sample_features`` call, one SMPL decode, one classifier call. The SMPL
decode of the ``smpl`` joints runs no skinning (smpl/lbs.py), so the
megabatch holds no vertex tensor and ``chunk`` has nothing to bound; it
stays in the signatures, as mdm_tpu's.
"""
from __future__ import annotations

import os
from typing import Callable, Dict, Iterable, Tuple

import numpy as np
import torch
from torch import nn

from .classifiers import MotionDiscriminator, convert_motion_discriminator
from .networks import load_flax_params, reset_seeded
from .stgcn import STGCN, STGCNConfig, convert_stgcn


class StgcnAdapter(nn.Module):
    """Gives the STGCN MotionDiscriminator's (x, lengths) call; the lengths
    are ignored (the reference's STGCN takes fixed 60-frame clips,
    stgcn_eval.py:58-75). Its flax layout is the STGCN's own."""

    def __init__(self, stg: STGCN):
        super().__init__()
        self.stg = stg

    def forward(self, x, lengths=None):
        return self.stg(x)

    def flax_layout(self):
        return self.stg.flax_layout()


def load_reference_state_dict(path: str) -> Dict:
    """A reference classifier checkpoint's state dict (its ``model`` entry)."""
    sd = torch.load(path, map_location="cpu", weights_only=False)
    return sd.get("model", sd)


def build_a2m_classifier(dataset_name: str, num_actions: int,
                         device="cpu") -> Tuple[nn.Module, bool]:
    """The frozen a2m classifier on ``device``: (module, degraded).

    HumanAct12 -> GRU MotionDiscriminator on xyz (reference
    eval/a2m/gru_eval.py), its input width the checkpoint's, else the 72
    of the smpl joints the decode gives (mdm_tpu's random init takes 75
    and cannot read them); UESTC -> STGCN on rot6d (stgcn_eval.py:58-60).
    degraded=True when the reference checkpoint asset is missing and a
    random init (seed 1, mdm_tpu's initialisers) stands in (metrics then
    not comparable)."""
    if dataset_name == "uestc":
        clf_path = os.path.join("assets", "actionrecognition", "uestc_rot6d_stgcn.tar")
    else:
        clf_path = os.path.join("assets", "actionrecognition", "humanact12_gru.tar")
    sd = load_reference_state_dict(clf_path) if os.path.exists(clf_path) else None
    if dataset_name == "uestc":
        cfg = STGCNConfig(in_channels=6, num_class=num_actions, layout="smpl")
        clf = StgcnAdapter(STGCN(cfg))
        if sd is not None:
            clf.stg.load_state_dict(convert_stgcn(sd, cfg))
    else:
        width = 24 * 3 if sd is None else int(np.shape(sd["recurrent.weight_ih_l0"])[1])
        clf = MotionDiscriminator(width, 128, 2, num_actions)
        if sd is not None:
            clf.load_state_dict(convert_motion_discriminator(sd))
    if sd is not None:
        return clf.to(device), False
    print(f"WARNING: classifier checkpoint {clf_path} missing; random init")
    return reset_seeded(clf, 1).to(device), True


def build_feature_and_classifier(
    dataset_name: str, num_actions: int, num_frames: int, input_feats: int,
    classifier_path: str = "", chunk: int = 0, device="cpu",
) -> Tuple[Callable, nn.Module, bool]:
    """(feature_input, classifier on ``device``, degraded).

    humanact12's GRU consumes SMPL xyz; when the SMPL asset is missing, a
    random-init GRU classifies the raw rot6d features so the protocol still
    runs, stamped degraded by every caller. ``classifier_path`` loads a
    self-trained classifier (the .npy of ``train_evaluators --stage
    a2m_classifier``, of either package): the blob records the architecture
    (arch / hidden_size / hidden_layers) and the representation it was
    trained on (xyz / rot6d / raw), and the same pipeline is rebuilt.
    Functional, but not comparable to the published tables, which use the
    reference's frozen classifier. ``num_frames`` and ``chunk`` keep
    mdm_tpu's signature: the port's classifiers take any T, and the SMPL
    decode holds no vertex tensor to bound."""
    if classifier_path:
        from .train_evaluators import load_evaluator_params

        blob = load_evaluator_params(classifier_path)
        assert int(blob.get("num_actions", num_actions)) == num_actions, \
            (classifier_path, blob.get("num_actions"), num_actions)
        if blob.get("arch", "gru") == "stgcn":
            clf = StgcnAdapter(STGCN(STGCNConfig(
                in_channels=int(blob["input_size"]), num_class=num_actions, layout="smpl")))
        else:
            clf = MotionDiscriminator(
                int(blob["input_size"]), int(blob.get("hidden_size", 128)),
                int(blob.get("hidden_layers", 2)), num_actions)
        clf = load_flax_params(clf, blob["params"]).to(device)
        if blob["feature"] in ("xyz", "rot6d"):
            feature_input = make_a2m_feature_input(
                dataset_name if blob["feature"] == "xyz" else "uestc", chunk=chunk,
                device=device)
        else:
            feature_input = raw_features(device)
        return feature_input, clf, False

    clf, degraded = build_a2m_classifier(dataset_name, num_actions, device)
    try:
        return make_a2m_feature_input(dataset_name, chunk=chunk, device=device), clf, degraded
    except FileNotFoundError as e:
        print(f"a2m eval: SMPL asset missing ({e}); degrading to "
              "raw-feature classifier (non-comparable)")
        clf = reset_seeded(MotionDiscriminator(input_feats, 128, 2, num_actions), 1).to(device)
        return raw_features(device), clf, True


def raw_features(device) -> Callable:
    """The features themselves as the classifier's input, on ``device``."""
    return lambda feats: torch.as_tensor(feats).to(device)


def make_a2m_feature_input(dataset_name: str, chunk: int = 0, device="cpu") -> Callable:
    """feats_norm [B, T, 150] (numpy or a tensor) -> the classifier's input
    on ``device``: the flattened smpl joints [B, T, 72] through SMPL with
    the translation (humanact12; the asset must exist, else
    FileNotFoundError), or the 24 rot6d rows [B, T, 24, 6] (uestc).
    ``chunk`` is accepted for mdm_tpu's signature (module docstring)."""
    del chunk
    if dataset_name == "uestc":
        def feature_input(feats_norm):
            feats = torch.as_tensor(feats_norm).to(device)
            r6 = feats.reshape(feats.shape[0], feats.shape[1], 25, 6)
            return r6[:, :, :-1]  # rotations only, the translation row dropped

        return feature_input

    from ..smpl import Rot2XYZConfig, SMPLModel, rot2xyz

    smpl = SMPLModel.load()
    r2x_cfg = Rot2XYZConfig(jointstype="smpl", vertstrans=True)

    @torch.no_grad()
    def feature_input(feats_norm):
        feats = torch.as_tensor(feats_norm).to(device)
        joints = rot2xyz(smpl, feats.reshape(feats.shape[0], feats.shape[1], 25, 6), r2x_cfg)
        return joints.reshape(joints.shape[0], joints.shape[1], -1)  # [B, T, 72]

    return feature_input


def make_a2m_loaders_factory(
    dataset, generator, batch_size: int, num_frames: int,
    feature_input: Callable, max_batches: int = 0,
) -> Callable[[int], Dict[str, Iterable]]:
    """make_loaders(seed) -> {gen, gt, gt2}, each one megabatch.

    Per seed: a reshuffled GT pass, an independently shuffled gt2 pass (the
    reference's FID sanity baseline, gru_eval.py:55-78), and generation over
    the GT pass's actions and masks in one ``sample_features`` call, its
    noise drawn from a device generator seeded with the seed. max_batches >
    0 truncates each pass (evaluation during training uses a small budget,
    training_loop.py:277). The host batches (shuffle order, per-clip frame
    sampling) are mdm_tpu's, byte for byte."""
    from ..data import BatchIterator
    from ..models.mdm import Conditioning

    def _epoch(seed_):
        xs, ls, ys, ms = [], [], [], []
        it = BatchIterator(dataset, batch_size, seed=seed_, infinite=False)
        for i, batch in enumerate(it):
            if max_batches and i >= max_batches:
                break
            xs.append(batch["x"])
            ls.append(np.asarray(batch["lengths"]))
            ys.append(np.asarray(batch["action"]))
            ms.append(np.asarray(batch["mask"]))
        return (np.concatenate(xs), np.concatenate(ls), np.concatenate(ys),
                np.concatenate(ms))

    def make_loaders(seed):
        x1, l1, y1, m1 = _epoch(seed)
        x2, l2, y2, m2 = _epoch(seed + 1000)
        gt1 = [{"output_xyz": feature_input(x1), "lengths": l1, "y": y1}]
        gt2 = [{"output_xyz": feature_input(x2), "lengths": l2, "y": y2}]
        cond = Conditioning(frames_mask=torch.from_numpy(m1), action=torch.from_numpy(y1))
        noise = torch.Generator(generator.device).manual_seed(seed)
        # The features stay on the device: generate -> SMPL -> classify
        # runs without a host sync.
        feats = generator.sample_features(cond, len(y1), num_frames, noise)
        genb = [{"output_xyz": feature_input(feats), "lengths": l1, "y": y1}]
        return {"gt": gt1, "gt2": gt2, "gen": genb}

    return make_loaders


def unconstrained_xyz_fn(num_frames: int = 60, device="cpu"):
    """The xyz decode of the unconstrained protocol (reference
    eval/unconstrained/evaluate.py:57-110 feeds SMPL xyz): SMPL rot2xyz when
    the body-model asset exists, else the pseudo-joint fallback (the first
    72 raw rotation features as [B, T, 24, 3]) so the protocol still runs.
    Returns (feats -> xyz [B, T, 24, 3] on ``device``, degraded). Shared by
    cli/eval_unconstrained.py and the unconstrained_stgcn training stage, so
    both sides of the metric see the same decode."""
    from ..smpl import Rot2XYZConfig, SMPLModel, rot2xyz

    try:
        smpl = SMPLModel.load()
    except FileNotFoundError:
        def pseudo(feats):
            feats = torch.as_tensor(feats).to(device)
            return feats[..., :72].reshape(feats.shape[0], feats.shape[1], 24, 3)

        return pseudo, True
    r2x_cfg = Rot2XYZConfig(jointstype="smpl", vertstrans=True)

    @torch.no_grad()
    def decode(feats):
        feats = torch.as_tensor(feats).to(device)
        return rot2xyz(smpl, feats.reshape(feats.shape[0], feats.shape[1], 25, 6), r2x_cfg)

    return decode, False
