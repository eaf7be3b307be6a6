"""Closed-loop quality rehearsal of mdm_tpu_torch's action-to-motion family,
through its CLIs, with no downloaded assets.

Counterpart of scripts/synthetic_a2m_rehearsal.py (``--protocol a2m``) and
scripts/synthetic_unconstrained_rehearsal.py (``--protocol
unconstrained``). The published numbers need the reference's frozen
classifiers (assets/actionrecognition/*.tar); this script shows instead
that classifier training, MDM training and the multi-seed protocol compose
into an action-to-motion system whose metrics separate a trained model
from an untrained one:

  1. Writes a HumanAct12-format pickle where the label fully determines
     the motion: class -> oscillation frequency, a fixed pose-space
     direction and a root heading (12 classes).
  2. Trains the classifier with ``cli.train_evaluators``: ``--stage
     a2m_classifier`` (the GRU on the raw rot6d features: no SMPL asset
     here, as in mdm_tpu's runs) or ``--stage unconstrained_stgcn`` (the
     modi-15 STGCN on the pseudo joints).
  3. Trains an action-conditioned (a2m) or unconditioned (``no_cond``)
     flagship MDM with ``cli.train`` and a 1-step control.
  4. Scores both with ``cli.eval_a2m`` / ``cli.eval_unconstrained`` against
     the same classifier and prints one JSON line per model and a
     separation line: the trained model must beat its control on accuracy
     and FID (a2m), on FID, KID and precision (unconstrained).
  5. Unconstrained: measures the extractor's own gain, the FID between the
     ground truth's features and those of the ground truth plus Gaussian
     noise of 0.01 and 0.05 in the raw features (``extractor_gain``). Each
     seed trains its own extractor on its own data, so a FID is read
     against its seed's gain.

``write_synthetic_smpl`` writes an SMPL pickle at the published sizes from
a seed, for runs that need the SMPL layer without the asset
(``chip_smoke.py`` phase 17, the tests).

On the card (one GPU, ~10 min):
    python3 -m mdm_tpu_torch.scripts.a2m_rehearsal [--protocol unconstrained] [--out rows.json]
On the CPU (a plumbing check at tiny widths):
    python3 -m mdm_tpu_torch.scripts.a2m_rehearsal --smoke
"""
from __future__ import annotations

import argparse
import json
import os
import pickle
import shutil
import subprocess
import tempfile
import time

import numpy as np

NUM_CLASSES = 12
FPS = 20.0
SMPL_PARENTS = [-1, 0, 0, 0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 9, 9, 12, 13, 14, 16, 17, 18, 19, 20, 21]


def build_dataset(work: str, n_clips: int, seed: int = 0) -> str:
    """A HumanAct12-format pickle under ``work`` where y determines the
    motion, draw for draw as scripts/synthetic_a2m_rehearsal.py's
    build_dataset. Returns its directory."""
    rng = np.random.default_rng(seed)
    # Fixed per-class pose-space directions (orthonormal across 72-d) and
    # frequencies: the class is recoverable from the raw features.
    w = np.random.default_rng(1234).normal(size=(72, NUM_CLASSES))
    dirs, _ = np.linalg.qr(w)  # [72, 12] orthonormal columns
    freqs = 0.4 + 0.25 * np.arange(NUM_CLASSES)  # Hz, distinct per class
    headings = 2.0 * np.pi * np.arange(NUM_CLASSES) / NUM_CLASSES

    poses, joints3d, ys = [], [], []
    for i in range(n_clips):
        y = i % NUM_CLASSES
        L = int(rng.integers(60, 120))
        t = np.arange(L, dtype=np.float32) / FPS
        phase = 2.0 * np.pi * rng.random()
        carrier = np.sin(2.0 * np.pi * freqs[y] * t + phase)
        pose = 0.25 * carrier[:, None] * dirs[:, y][None, :]
        pose += 0.02 * rng.normal(size=pose.shape)
        # Root trajectory: a constant-heading walk + noise; other joints rest.
        j = 0.05 * rng.normal(size=(L, 24, 3))
        step = 0.02 * np.stack([np.cos(headings[y]) * np.arange(L),
                                np.zeros(L),
                                np.sin(headings[y]) * np.arange(L)], axis=1)
        j[:, 0] += step
        poses.append(pose.astype(np.float32))
        joints3d.append(j.astype(np.float32))
        ys.append(y)

    d = os.path.join(work, "HumanAct12Poses")
    os.makedirs(d, exist_ok=True)
    with open(os.path.join(d, "humanact12poses.pkl"), "wb") as f:
        pickle.dump({"poses": poses, "joints3D": joints3d, "y": ys}, f)
    return d


def write_synthetic_smpl(root: str, vertices: int = 6890, betas: int = 10, faces: int = 13776,
                         seed: int = 0) -> str:
    """``root``/body_models/smpl/SMPL_NEUTRAL.pkl and J_regressor_extra.npy
    at SMPL's published sizes by default (6890 vertices, 24 joints with
    SMPL's kinematic tree and its uint32 root sentinel, ``betas`` shape
    directions, 207 pose-blend rows, 9 extra regressors), drawn from
    ``seed``: positive regressor and skinning weights that sum to one, a
    1.7-unit body, small blend shapes. Where ``SMPLModel.load()`` reads them
    from ``root``. Returns the pickle's path."""
    rng = np.random.default_rng(seed)
    nj = len(SMPL_PARENTS)
    jr = rng.random((nj, vertices)) ** 8
    w = rng.random((vertices, nj)) ** 8
    kintree = np.stack([SMPL_PARENTS, np.arange(nj)]).astype(np.int64)
    kintree[0, 0] = 2 ** 32 - 1
    data = {"v_template": rng.normal(size=(vertices, 3)) * np.array([0.3, 0.85, 0.15]),
            "shapedirs": rng.normal(size=(vertices, 3, betas)) * 0.01,
            "posedirs": rng.normal(size=(vertices, 3, (nj - 1) * 9)) * 0.01,
            "J_regressor": jr / jr.sum(axis=1, keepdims=True),
            "weights": w / w.sum(axis=1, keepdims=True),
            "kintree_table": kintree.astype(np.uint32),
            "f": rng.integers(0, vertices, size=(faces, 3)).astype(np.uint32)}
    d = os.path.join(root, "body_models", "smpl")
    os.makedirs(d, exist_ok=True)
    path = os.path.join(d, "SMPL_NEUTRAL.pkl")
    with open(path, "wb") as f:
        pickle.dump(data, f)
    extra = rng.random((9, vertices)) ** 8
    np.save(os.path.join(d, "J_regressor_extra.npy"),
            (extra / extra.sum(axis=1, keepdims=True)).astype(np.float32))
    return path


def _a2m_row(summary):
    return {k: round(summary[k]["mean"], 4)
            for k in ("accuracy_gen", "accuracy_gt", "fid_gen", "fid_gt2", "diversity_gen",
                      "multimodality_gen")} | {"classifier": summary["classifier"]}


def _unconstrained_row(summary):
    return {k: round(float(summary[k]), 6)
            for k in ("fid", "kid", "kid_std", "precision", "recall", "diversity")}


def extractor_gain(data_dir, clf_path, device, sigmas=(0.01, 0.05), seed=0):
    """{sigma: FID(gt features, features of gt + sigma * N(0, 1))} through
    the self-trained modi-15 STGCN at ``clf_path`` and the decode
    cli.eval_unconstrained uses, over the same epoch of ground truth."""
    import torch

    from ..data import BatchIterator, get_dataset
    from ..eval import metrics as M
    from ..eval.a2m_setup import unconstrained_xyz_fn
    from ..eval.harness_a2m import UNCONSTRAINED_JOINT_SUBSET
    from ..eval.networks import f32_math, load_flax_params
    from ..eval.stgcn import STGCN, STGCNConfig
    from ..eval.train_evaluators import load_evaluator_params
    from ..utils.parser import select_device

    dev = select_device(argparse.Namespace(device=device if device == "cpu" else int(device)))
    blob = load_evaluator_params(clf_path)
    stgcn = STGCN(STGCNConfig(in_channels=3, num_class=int(blob["num_actions"]),
                              layout="openpose_modi15", edge_importance=True))
    stgcn = load_flax_params(stgcn, blob["params"]).to(dev).eval()
    get_xyz, _ = unconstrained_xyz_fn(60, device=dev)
    noise = torch.Generator().manual_seed(seed)
    feats = {s: [] for s in (0.0,) + tuple(sigmas)}
    with torch.no_grad(), f32_math():
        for batch in BatchIterator(get_dataset("humanact12", num_frames=60, data_root=data_dir),
                                   32, seed=0, infinite=False):
            x = torch.as_tensor(batch["x"])
            for s, out in feats.items():
                sub = get_xyz(x + s * torch.randn(x.shape, generator=noise))
                sub = sub[:, :, UNCONSTRAINED_JOINT_SUBSET]
                out.append(stgcn(sub - sub[:, :1, 8:9])["features"].cpu().numpy())
    stats = {s: M.calculate_activation_statistics(np.concatenate(f)) for s, f in feats.items()}
    return {str(s): float(M.calculate_frechet_distance(*stats[0.0], *stats[s])) for s in sigmas}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--protocol", default="a2m", choices=["a2m", "unconstrained"])
    ap.add_argument("--work_dir", default=os.path.join(tempfile.gettempdir(),
                                                       "mdm_tpu_torch_a2m_rehearsal"))
    ap.add_argument("--smoke", action="store_true",
                    help="tiny model + few steps on the CPU (plumbing check)")
    ap.add_argument("--train_steps", type=int, default=2000)
    ap.add_argument("--clf_steps", type=int, default=600)
    ap.add_argument("--replications", type=int, default=3, help="a2m seeds (smoke: 2)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="0",
                    help="CUDA device index (default 0), or 'cpu' (--smoke's default)")
    ap.add_argument("--out", default="", help="also write the rows, the card and the timings "
                                              "as JSON to this path")
    args = ap.parse_args(argv)

    from ..cli import eval_a2m, eval_unconstrained
    from ..cli import train as train_cli
    from ..cli import train_evaluators as tev_cli
    from ..train.checkpoints import find_resume_checkpoint

    a2m = args.protocol == "a2m"
    device = "cpu" if args.smoke and args.device == "0" else args.device
    work = os.path.abspath(os.path.join(args.work_dir, args.protocol))
    os.makedirs(work, exist_ok=True)
    n_clips = 96 if args.smoke else 576
    data_dir = build_dataset(work, n_clips, args.seed)
    print(f"[1/4] dataset: {data_dir}", flush=True)
    cwd = os.getcwd()
    os.chdir(work)  # the dataset's parse cache goes under ./save
    timings = {}

    def run(name, cli_main, argv):
        t0 = time.perf_counter()
        out = cli_main(argv + ["--device", device])
        timings[name] = time.perf_counter() - t0
        return out

    try:
        # ---- 2. the classifier / feature extractor.
        clf_path = os.path.join(work, "a2m_classifier.npy" if a2m else "uncon_stgcn.npy")
        stage = "a2m_classifier" if a2m else "unconstrained_stgcn"
        smoke_clf = (["--num_steps", "40"] if a2m else ["--num_steps", "4", "--batch_size", "8"])
        run(f"train_evaluators {stage}", tev_cli.main, [
            "--stage", stage, "--dataset", "humanact12", "--data_dir", data_dir,
            "--save_path", clf_path, "--log_every", "20" if args.smoke else "50", "--lr", "3e-4",
        ] + (smoke_clf if args.smoke else ["--num_steps", str(args.clf_steps),
                                           "--cache_batches", str(n_clips // 32)]))
        print(f"[2/4] classifier: {clf_path}", flush=True)

        # ---- 3. MDM (trained + 1-step untrained control).
        model_flags = (["--latent_dim", "64", "--ff_size", "128", "--layers", "2",
                        "--diffusion_steps", "8"] if args.smoke
                       else ["--compute_dtype", "bfloat16", "--diffusion_steps", "50"])
        if not a2m:
            model_flags += ["--unconstrained"]
        runs = {}
        for tag, steps in (("trained", 40 if args.smoke else args.train_steps), ("untrained", 1)):
            save_dir = os.path.join(work, f"save_{tag}")
            shutil.rmtree(save_dir, ignore_errors=True)  # a stale run dir would be resumed
            run(f"train {tag}", train_cli.main, [
                "--save_dir", save_dir, "--overwrite", "--dataset", "humanact12",
                "--data_dir", data_dir, "--num_frames", "60",
                "--num_steps", str(steps), "--save_interval", str(max(steps, 1)),
                "--log_interval", "20" if args.smoke else "200",
                # lr 1e-4, the reference's; the smoke's 64-d model learns at 3e-4
                "--batch_size", "64", "--lr", "3e-4" if args.smoke else "1e-4",
                "--seed", str(args.seed),
            ] + model_flags + ([] if args.smoke else ["--cache_batches", str(n_clips // 64)]))
            runs[tag] = find_resume_checkpoint(save_dir)[0]
            print(f"[3/4] {tag} checkpoint: {runs[tag]}", flush=True)

        # ---- 4. the protocol on both, the same classifier.
        results = {}
        for tag, ckpt in runs.items():
            common = ["--model_path", ckpt, "--eval_mode", "debug", "--data_dir", data_dir,
                      "--a2m_classifier_path", clf_path]
            if a2m:
                summary = run(f"eval {tag}", eval_a2m.main, common + [
                    "--replications", str(2 if args.smoke else args.replications)])
                results[tag] = _a2m_row(summary)
            else:
                summary = run(f"eval {tag}", eval_unconstrained.main, common)
                results[tag] = _unconstrained_row(summary)
            print(json.dumps({"model": tag, **results[tag]}), flush=True)
        if not a2m:
            t0 = time.perf_counter()
            results["extractor_gain"] = extractor_gain(data_dir, clf_path, device)
            timings["extractor_gain"] = time.perf_counter() - t0
            print(json.dumps({"extractor_gain": results["extractor_gain"]}), flush=True)
    finally:
        os.chdir(cwd)

    t, u = results["trained"], results["untrained"]
    if a2m:
        sep = {"fid_ratio_untrained_over_trained": round(u["fid_gen"] / max(t["fid_gen"], 1e-9), 2),
               "trained_beats_untrained": bool(t["fid_gen"] < u["fid_gen"]
                                               and t["accuracy_gen"] > u["accuracy_gen"])}
    else:
        sep = {"fid_ratio_untrained_over_trained": round(u["fid"] / max(t["fid"], 1e-9), 2),
               "kid_ratio_untrained_over_trained": round(u["kid"] / max(t["kid"], 1e-9), 2),
               "trained_beats_untrained": bool(t["fid"] < u["fid"] and t["kid"] < u["kid"]
                                               and t["precision"] >= u["precision"])}
    print(json.dumps({"separation": sep}))
    print(json.dumps({"seconds": timings}))
    if args.out:
        card = None
        if device != "cpu":
            card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                                   "--format=csv,noheader"], capture_output=True, text=True,
                                  check=True).stdout.strip().splitlines()[0]
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump({"protocol": args.protocol, "smoke": args.smoke,
                       "train_steps": 40 if args.smoke else args.train_steps,
                       "clf_steps": args.clf_steps, "device": device, "card": card,
                       "results": results, "separation": sep, "seconds_host_clock": timings},
                      f, indent=1)
    return results, sep


if __name__ == "__main__":
    main()
