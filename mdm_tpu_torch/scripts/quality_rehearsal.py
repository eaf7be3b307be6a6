"""Closed-loop quality rehearsal of mdm_tpu_torch, through its CLIs, with no
downloaded assets.

Counterpart of scripts/synthetic_quality_rehearsal.py. The published
quality numbers need the reference's checkpoints and frozen evaluators; this
script shows instead that the port's whole pipeline — data loading,
evaluator TRAINING, MDM training, and the batch-32 replication eval
protocol — composes into a text-to-motion system whose metrics separate a
trained model from an untrained one and approach the ground-truth ceiling:

  1. Writes a HumanML3D-format dataset (new_joint_vecs/, texts/, Mean/Std,
     splits, a synthetic GloVe vocab) where the caption FULLY determines the
     motion: verb -> frequency, adverb -> amplitude, direction word ->
     spatial pattern (32 caption classes).
  2. Trains the metric encoders with `cli.train_evaluators` (--stage
     decomp, then --stage match -> finest.npy).
  3. Trains a flagship-config MDM with `cli.train` (hash text encoder) and
     a 1-step "untrained" control.
  4. Runs `cli.eval_humanml` (debug protocol: 5 replications, batch 32) on
     both checkpoints against the SAME trained evaluators.
  5. Prints one JSON line per model: R-precision top-1/2/3, matching score,
     FID, diversity (and the ground truth's).

--family dip trains trans_dec at context 20 / pred 40 on a 10-step
schedule and evaluates through the autoregressive protocol at guidance
7.5; --dataset kit runs the loop at KIT's 251 features.

On the card (one GPU, ~10 min):
    python3 -m mdm_tpu_torch.scripts.quality_rehearsal [--out rows.json]
On the CPU (a plumbing check at tiny widths):
    python3 -m mdm_tpu_torch.scripts.quality_rehearsal --smoke
"""
from __future__ import annotations

import argparse
import json
import os
import pickle
import shutil
import subprocess
import tempfile

import numpy as np

VERBS = {"walk": 0.5, "wave": 1.0, "jump": 1.8, "spin": 3.0}     # Hz
ADVERBS = {"slowly": 0.6, "quickly": 1.5}                         # amplitude
DIRECTIONS = ("forward", "backward", "left", "right")             # pattern id
FPS = 20.0


def _direction_patterns(rng: np.random.Generator, dim: int) -> np.ndarray:
    """[4, dim] near-orthogonal spatial envelopes, fixed by seed."""
    w = rng.normal(size=(4, dim)).astype(np.float32)
    q, _ = np.linalg.qr(w.T)  # orthonormalize across the feature axis
    return np.ascontiguousarray(q.T[:4]).astype(np.float32)


def make_clip(rng, pats, verb, adverb, direction, length):
    f, a, d = VERBS[verb], ADVERBS[adverb], DIRECTIONS.index(direction)
    dim = pats.shape[1]
    t = np.arange(length, dtype=np.float32) / FPS
    phase = 2.0 * np.pi * rng.random()
    carrier = np.sin(2.0 * np.pi * f * t + phase).astype(np.float32)
    motion = a * carrier[:, None] * (pats[d] * np.sqrt(dim))[None, :]
    motion += 0.05 * rng.normal(size=motion.shape).astype(np.float32)
    return motion


def build_dataset(work: str, n_train: int, n_test: int, seed: int = 0, dim: int = 263):
    """HumanML3D-format tree + synthetic GloVe under `work`: dim 263
    (HumanML3D) or 251 (KIT-ML, 21 joints). Returns (data root, glove dir)."""
    rng = np.random.default_rng(seed)
    pats = _direction_patterns(np.random.default_rng(1234), dim)
    root = os.path.join(work, "HumanML3D")
    os.makedirs(os.path.join(root, "new_joint_vecs"), exist_ok=True)
    os.makedirs(os.path.join(root, "texts"), exist_ok=True)

    classes = [(v, a, d) for v in VERBS for a in ADVERBS for d in DIRECTIONS]
    splits = {"train": n_train, "test": n_test, "val": max(n_test // 2, 32)}
    idx = 0
    all_train_frames = []
    for split, n in splits.items():
        names = []
        for i in range(n):
            verb, adverb, direction = classes[i % len(classes)]
            length = int(rng.integers(60, 197))
            motion = make_clip(rng, pats, verb, adverb, direction, length)
            name = f"{idx:06d}"
            idx += 1
            np.save(os.path.join(root, "new_joint_vecs", f"{name}.npy"), motion)
            caption = f"a person {verb}s {adverb} {direction}"
            tokens = f"a/DET person/NOUN {verb}/VERB {adverb}/ADV {direction}/ADV"
            with open(os.path.join(root, "texts", f"{name}.txt"), "w") as fh:
                fh.write(f"{caption}#{tokens}#0.0#0.0\n")
            names.append(name)
            if split == "train":
                all_train_frames.append(motion)
        with open(os.path.join(root, f"{split}.txt"), "w") as fh:
            fh.write("\n".join(names))
    frames = np.concatenate(all_train_frames, axis=0)
    np.save(os.path.join(root, "Mean.npy"), frames.mean(0))
    np.save(os.path.join(root, "Std.npy"), frames.std(0) + 1e-6)
    return root, write_glove(work, ["a", "person"] + list(VERBS) + list(ADVERBS)
                             + list(DIRECTIONS))


def write_glove(work: str, words, seed: int = 7) -> str:
    """A synthetic GloVe vocabulary (WordVectorizer's our_vab layout) of
    ``words`` plus sos/eos/unk, unit vectors from ``seed``, under work/glove."""
    glove = os.path.join(work, "glove")
    os.makedirs(glove, exist_ok=True)
    words = ["sos", "eos", "unk"] + list(words)
    vecs = np.random.default_rng(seed).normal(size=(len(words), 300)).astype(np.float32)
    vecs /= np.linalg.norm(vecs, axis=1, keepdims=True)
    np.save(os.path.join(glove, "our_vab_data.npy"), vecs)
    with open(os.path.join(glove, "our_vab_words.pkl"), "wb") as fh:
        pickle.dump(words, fh)
    with open(os.path.join(glove, "our_vab_idx.pkl"), "wb") as fh:
        pickle.dump({w: i for i, w in enumerate(words)}, fh)
    return glove


def _row(tag, summary):
    mean = lambda metric, name: np.atleast_1d(summary[metric][name]["mean"])
    return {
        "model": tag,
        "R_precision_top123": [round(float(x), 4) for x in mean("R_precision", "vald")],
        "R_precision_gt": [round(float(x), 4) for x in mean("R_precision", "ground truth")],
        "matching": round(float(mean("Matching Score", "vald")[0]), 4),
        "matching_gt": round(float(mean("Matching Score", "ground truth")[0]), 4),
        "FID": round(float(mean("FID", "vald")[0]), 4),
        "Diversity": round(float(mean("Diversity", "vald")[0]), 4),
        "Diversity_gt": round(float(mean("Diversity", "ground truth")[0]), 4),
    }


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--work_dir", default=os.path.join(tempfile.gettempdir(),
                                                       "mdm_tpu_torch_rehearsal"))
    ap.add_argument("--smoke", action="store_true",
                    help="tiny model + few steps on the CPU (plumbing check)")
    ap.add_argument("--train_steps", type=int, default=3000)
    ap.add_argument("--eval_mode", default="debug")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--family", default="t2m", choices=["t2m", "dip"],
                    help="t2m: trans_enc full-sequence model (guidance 2.5); dip: trans_dec "
                         "prefix-completion model trained at context 20 / pred 40 on a 10-step "
                         "schedule and evaluated through the autoregressive protocol at "
                         "guidance 7.5 (reference DiP.md:18-23, utils/sampler_util.py:41-81)")
    ap.add_argument("--dataset", default="humanml", choices=["humanml", "kit"],
                    help="kit runs the whole loop at KIT shapes (251-d, 21 joints)")
    ap.add_argument("--device", default="0",
                    help="CUDA device index (default 0), or 'cpu' (--smoke's default)")
    ap.add_argument("--out", default="", help="also write the rows, the card and the timings "
                                              "as JSON to this path")
    args = ap.parse_args(argv)

    import time

    from ..cli import eval_humanml as eval_cli
    from ..cli import train as train_cli
    from ..cli import train_evaluators as tev_cli
    from ..train.checkpoints import find_resume_checkpoint

    device = "cpu" if args.smoke and args.device == "0" else args.device
    work = os.path.abspath(args.work_dir)
    os.makedirs(work, exist_ok=True)
    n_train, n_test = (96, 64) if args.smoke else (480, 320)
    dim = 251 if args.dataset == "kit" else 263
    root, glove = build_dataset(work, n_train, n_test, args.seed, dim=dim)
    print(f"[1/5] dataset: {root} ({args.dataset}, {dim}-d)", flush=True)
    cwd = os.getcwd()
    os.chdir(work)  # the dataset's parse cache goes under ./save
    timings = {}

    def run(name, cli_main, argv):
        t0 = time.perf_counter()
        out = cli_main(argv + ["--device", device])
        timings[name] = time.perf_counter() - t0
        return out

    try:
        # ---- 2. metric encoders (decomp -> match), the protocol's 512-d
        # widths. EvaluatorWrapper resolves "t2m/" for humanml and
        # "<dataset>/" for kit (the reference's checkpoint layout).
        ev_family = "t2m" if args.dataset == "humanml" else args.dataset
        ev_dir = os.path.join(work, ev_family, "text_mot_match", "model")
        os.makedirs(ev_dir, exist_ok=True)
        decomp = os.path.join(work, "decomp.npy")
        finest = os.path.join(ev_dir, "finest.npy")
        dims = ["--movement_dim", "64", "--coemb_dim", "64"] if args.smoke else []
        steps_d, steps_m = ("60", "120") if args.smoke else ("400", "1500")
        cache = [] if args.smoke else ["--cache_batches", str(n_train // 32)]
        ds = ["--dataset", args.dataset, "--data_dir", root, "--glove_dir", glove,
              "--log_every", "50", "--lr", "3e-4"] + dims + cache
        run("train_evaluators decomp", tev_cli.main,
            ["--stage", "decomp", "--save_path", decomp, "--num_steps", steps_d] + ds)
        print(f"[2/5] decomp: {decomp}", flush=True)
        run("train_evaluators match", tev_cli.main,
            ["--stage", "match", "--save_path", finest, "--decomp_path", decomp,
             "--num_steps", steps_m] + ds)
        print(f"[2/5] match encoders: {finest}", flush=True)

        # ---- 3. MDM training (hash text embedder; flagship config by
        # default), directly on a short schedule; eval samples at the
        # checkpoint's own diffusion_steps (args.json).
        if args.family == "dip":
            ctx, pred = (4, 8) if args.smoke else (20, 40)
            model_flags = ["--arch", "trans_dec", "--context_len", str(ctx),
                           "--pred_len", str(pred), "--autoregressive",
                           "--diffusion_steps", "8" if args.smoke else "10"]
        else:
            model_flags = ["--diffusion_steps", "8" if args.smoke else "50"]
        model_flags += (["--latent_dim", "64", "--ff_size", "128", "--layers", "2"]
                        if args.smoke else ["--compute_dtype", "bfloat16"])
        n_steps = 40 if args.smoke else args.train_steps
        runs = {}
        for tag, steps in (("trained", n_steps), ("untrained", 1)):
            save_dir = os.path.join(work, f"save_{tag}")
            # A stale run dir would be resumed — always start fresh.
            shutil.rmtree(save_dir, ignore_errors=True)
            run(f"train {tag}", train_cli.main, [
                "--save_dir", save_dir, "--overwrite", "--dataset", args.dataset,
                "--data_dir", root, "--text_encoder_type", "hash",
                "--num_steps", str(steps), "--save_interval", str(max(steps, 1)),
                "--log_interval", "20" if args.smoke else "200",
                # lr 1e-4 = the reference's training lr (parser_util.py:151)
                "--batch_size", "64", "--lr", "3e-4" if args.smoke else "1e-4",
                "--seed", str(args.seed),
            ] + model_flags + ([] if args.smoke else ["--cache_batches", str(n_train // 64)]))
            runs[tag] = find_resume_checkpoint(save_dir)[0]
            print(f"[3/5] {tag} checkpoint: {runs[tag]}", flush=True)

        # ---- 4/5. the eval protocol on both, the same trained evaluators.
        eval_flags = (["--autoregressive", "--guidance_param", "7.5"]
                      if args.family == "dip" else ["--guidance_param", "2.5"])
        results = {}
        for tag, ckpt in runs.items():
            summary = run(f"eval {tag}", eval_cli.main, [
                "--model_path", ckpt, "--eval_mode", args.eval_mode, "--data_dir", root,
                "--evaluator_dir", work,
            ] + eval_flags + (["--replications", "2"] if args.smoke else []))
            results[tag] = _row(tag, summary)
            print(json.dumps(results[tag]), flush=True)
    finally:
        os.chdir(cwd)

    sep = {
        "fid_ratio_untrained_over_trained": round(
            results["untrained"]["FID"] / max(results["trained"]["FID"], 1e-9), 2),
        "trained_beats_untrained": bool(
            results["trained"]["FID"] < results["untrained"]["FID"]
            and results["trained"]["R_precision_top123"][-1]
            > results["untrained"]["R_precision_top123"][-1]
        ),
    }
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
            json.dump({"family": args.family, "dataset": args.dataset, "smoke": args.smoke,
                       "train_steps": n_steps, "eval_mode": args.eval_mode, "device": device,
                       "card": card, "results": results, "separation": sep,
                       "seconds_host_clock": timings}, f, indent=1)
    return results, sep


if __name__ == "__main__":
    main()
