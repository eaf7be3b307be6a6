"""Generation entry point: `python -m mdm_tpu_torch.cli.generate --model_path ...`.

Counterpart of mdm_tpu/cli/generate.py (reference sample/generate.py). It
rebuilds the model from the run's args.json, loads a checkpoint of the
port (EMA parameters when the run kept them), samples on ``--device`` (the
card unless ``--device cpu``) and writes results.npy with mdm_tpu's keys
and shapes, plus stick-figure videos where matplotlib and ffmpeg are
available. Prompt sources: --text_prompt, --input_text file,
--action_name/--action_file, --dynamic_text_path (one prompt per DiP
chunk), or the dataset's test split. A missing checkpoint warns and
samples with random weights, as in mdm_tpu; an orbax checkpoint written by
mdm_tpu raises (converting one is ROADMAP Queue 1 item 11).
"""
from __future__ import annotations

import os

import numpy as np
import torch


def load_prompts(args):
    if args.text_prompt:
        return [args.text_prompt] * args.num_samples, False
    if args.input_text:
        with open(args.input_text) as f:
            lines = [line.strip() for line in f if line.strip()]
        return lines, False
    if args.dynamic_text_path:
        with open(args.dynamic_text_path) as f:
            chunks = [line.strip() for line in f if line.strip()]
        return [chunks] * args.num_samples, True
    if args.action_name:
        return [args.action_name] * args.num_samples, False
    if args.action_file:
        with open(args.action_file) as f:
            return [line.strip() for line in f if line.strip()], False
    return None, False


def resolve_action_map(dataset: str, data_dir):
    """Action name -> class index through the dataset's own class list
    (reference data_loaders/a2m/uestc.py:40-74; humanact12's fixed map)."""
    if dataset == "uestc":
        from ..data.a2m import uestc_action_classes

        return {name: i for i, name in
                uestc_action_classes(data_dir or "dataset/uestc").items()}
    from ..data.a2m import HUMANACT12_ACTIONS

    return {v: k for k, v in HUMANACT12_ACTIONS.items()}


def load_model(args, model, device):
    """Seeded weights, then the checkpoint's (a run directory: its highest
    step) when it exists; warns and keeps the seeded weights when it does
    not. The model ends on ``device``."""
    from ..train.checkpoints import find_resume_checkpoint, restore_params_only

    model = model.init_weights(torch.Generator().manual_seed(0)).to(device)
    ckpt = args.model_path
    if os.path.isdir(ckpt) and not os.path.basename(ckpt).startswith("ckpt_"):
        found = find_resume_checkpoint(ckpt)
        if not found:
            raise FileNotFoundError(f"no checkpoint under {ckpt}")
        ckpt = found[0]
    if os.path.exists(ckpt):
        # EMA only if the run kept it: the model-group flag rides args.json
        # (reference model_util.py:118-122 use_avg semantics).
        restore_params_only(ckpt, model, use_ema=bool(getattr(args, "use_ema", False)))
        print(f"loaded checkpoint {ckpt}")
    else:
        print("WARNING: model_path missing; sampling with random weights")
    return model


def _cond_tensors(embeds, device):
    return {k: torch.as_tensor(v).to(device) for k, v in embeds.items()}


def main(argv=None):
    from ..models.mdm import Conditioning
    from ..sampling import GenerationConfig, MotionGenerator
    from ..sampling.pipeline import dataset_norm_stats
    from ..sampling.text import make_text_embedder
    from ..utils.factory import create_model_and_schedule, create_schedule
    from ..utils.parser import generate_args, select_device

    args = generate_args(argv)
    device = select_device(args)
    fps = 12.5 if args.dataset == "kit" else 20
    max_frames = 196 if args.dataset in ("humanml", "kit") else 60
    n_frames = min(max_frames, int(args.motion_length * fps))

    # dataset -> action-class count (reference model_util.py:24-71)
    num_actions = {"humanact12": 12, "uestc": 40}.get(args.dataset, 1)
    model, _ = create_model_and_schedule(args, num_actions)
    sched = create_schedule(args, timestep_respacing=None)

    prompts, dynamic = load_prompts(args)
    dataset_prefix = None
    dataset_actions = None
    dataset_lengths = None
    if prompts is None:
        # Prompt source of last resort: the dataset's test split
        # (reference generate.py uses hml_mode='text_only'; 'train' for AR
        # prefix sampling).
        try:
            from ..data import get_dataset_loader

            loader = get_dataset_loader(
                args.dataset, args.num_samples, num_frames=max_frames,
                split="test", hml_mode="train", data_root=args.data_dir or None,
                fixed_len=(model.config.context_len + model.config.pred_len)
                if args.autoregressive else 0,
                pred_len=model.config.pred_len if args.autoregressive else 0,
            )
            batch = next(iter(loader))
            prompts = list(batch.get("text", batch.get("action_text", [])))[: args.num_samples]
            if "action" in batch:  # a2m: the indices come with the batch
                dataset_actions = np.asarray(batch["action"])[: args.num_samples]
            if "lengths" in batch:
                # each sample's real length rides into results.npy
                # (reference generate.py:175-191 all_lengths)
                dataset_lengths = np.asarray(batch["lengths"])[: args.num_samples]
            if args.autoregressive and "prefix" in batch:
                dataset_prefix = batch["prefix"][: args.num_samples]
        except Exception as e:
            print(f"(dataset prompts unavailable: {e})")
            prompts = ["a person walks forward"] * args.num_samples
    B = min(len(prompts), args.num_samples) or args.num_samples
    prompts = prompts[:B]

    # Action-conditioned models: prompts are action names/indices -> the
    # EmbedAction table index (reference generate.py:66-74,100-119).
    action_idx = None
    if "action" in model.config.cond_mode and dataset_actions is not None:
        action_idx = torch.as_tensor(dataset_actions[:B], dtype=torch.int64)
    elif "action" in model.config.cond_mode:
        name_to_idx = resolve_action_map(args.dataset, args.data_dir)
        idxs = []
        for p in prompts:
            name = p[0] if isinstance(p, list) else p
            if isinstance(name, int) or (isinstance(name, str) and name.isdigit()):
                idxs.append(int(name))
            elif isinstance(name, str) and name in name_to_idx:
                idxs.append(name_to_idx[name])
            else:
                known = ", ".join(list(name_to_idx)[:12])
                raise SystemExit(
                    f"unknown action {name!r} for dataset {args.dataset}; "
                    f"pass one of [{known}, ...] or a numeric class index"
                )
        action_idx = torch.as_tensor(idxs, dtype=torch.int64)
    if dynamic:
        if not args.autoregressive:
            raise SystemExit("--dynamic_text_path requires --autoregressive")
        # each chunk prompt drives exactly one prediction window
        # (reference generate.py:65)
        n_frames = len(prompts[0]) * model.config.pred_len

    model = load_model(args, model, device)

    prefix0 = None
    if model.config.is_prefix_comp:
        if dataset_prefix is not None:
            prefix0 = torch.as_tensor(dataset_prefix)
        else:
            prefix0 = torch.zeros((B, model.config.context_len, model.config.input_feats))
    # Dataset prompts condition the model on each clip's real length via the
    # frame mask (reference data_loaders/tensors.py:3-6,48); synthetic
    # prompts fill n_frames. The AR/prefix path keeps its own chunk masks.
    if (dataset_lengths is not None and not args.autoregressive
            and not model.config.is_prefix_comp):
        dataset_lengths = np.minimum(np.asarray(dataset_lengths), n_frames)
        frames_mask0 = torch.arange(n_frames)[None, :] < torch.as_tensor(
            dataset_lengths[:B])[:, None]
    else:
        frames_mask0 = torch.ones((B, n_frames), dtype=torch.bool)
    cond0 = Conditioning(
        frames_mask=frames_mask0,
        text_embed=(torch.zeros((B, model.config.text_dim))
                    if "text" in model.config.cond_mode else None),
        action=action_idx,
        prefix=prefix0,
    ).to(device)

    embedder = make_text_embedder(args.text_encoder_type, device=device)
    per_chunk_cond = None
    if embedder is not None:
        if dynamic:
            # One prompt per autoregressive prediction window (reference
            # generate.py:59-65,134-142 + sampler_util.py:41-81).
            chunk_embeds = [_cond_tensors(embedder([c] * B), device) for c in prompts[0]]
            cond = cond0.replace(**chunk_embeds[0])

            def per_chunk_cond(i, c):
                return c.replace(**chunk_embeds[min(i, len(chunk_embeds) - 1)])
        else:
            flat_prompts = [p[0] if isinstance(p, list) else p for p in prompts]
            cond = cond0.replace(**_cond_tensors(embedder(flat_prompts), device))
    else:
        cond = cond0
        if "text" in model.config.cond_mode:
            # No encoder assets for a text-conditioned model: CFG against
            # the zero embedding is just 2x-cost unconditioned sampling.
            print(
                "WARNING: text encoder unavailable "
                f"({args.text_encoder_type!r}); sampling unconditioned "
                "(guidance 1) — prompts only label the outputs"
            )
            args.guidance_param = 1.0

    gen = MotionGenerator(
        model, sched,
        GenerationConfig(
            guidance_scale=args.guidance_param,
            sampler=args.sampler,
            cfg_cache_interval=args.cfg_cache_interval,
            autoregressive=args.autoregressive,
            autoregressive_include_prefix=args.autoregressive_include_prefix,
        ),
        args.dataset,
        norm_stats=dataset_norm_stats(args.data_dir or None),
    )

    all_motions, all_text = [], []
    generator = torch.Generator(device).manual_seed(args.seed)
    for rep in range(args.num_repetitions):
        if per_chunk_cond is not None:
            out = gen.generate(cond, B, n_frames, generator, per_chunk_cond=per_chunk_cond)
        else:
            out = gen.generate(cond, B, n_frames, generator)
        joints = out.get("joints", out["features"]).float().cpu().numpy()
        all_motions.append(joints)
        all_text += [p if isinstance(p, str) else " | ".join(p) for p in prompts]

    out_dir = args.output_dir or os.path.join(
        os.path.dirname(args.model_path) or ".", f"samples_seed{args.seed}"
    )
    os.makedirs(out_dir, exist_ok=True)

    # Per-sample real lengths (reference generate.py:175-191): dataset
    # prompts keep each clip's length; synthetic prompts fill n_frames; the
    # prefix/AR path stores the generated frame count (:181-183).
    motion_arr = np.concatenate(all_motions, axis=0)
    if model.config.is_prefix_comp or args.autoregressive:
        lengths = np.full(B, motion_arr.shape[1])
    elif dataset_lengths is not None:
        lengths = np.minimum(np.asarray(dataset_lengths[:B]), motion_arr.shape[1])
    else:
        lengths = np.full(B, n_frames)
    all_lengths = np.tile(lengths, args.num_repetitions)

    npy_path = os.path.join(out_dir, "results.npy")
    np.save(
        npy_path,
        {
            "motion": motion_arr,
            "text": all_text,
            "lengths": all_lengths,
            "num_samples": B,
            "num_repetitions": args.num_repetitions,
        },
    )
    with open(npy_path.replace(".npy", ".txt"), "w") as f:
        f.write("\n".join(all_text))
    with open(npy_path.replace(".npy", "_len.txt"), "w") as f:
        f.write("\n".join(str(int(n)) for n in all_lengths))
    print(f"saved {npy_path}")

    if os.environ.get("MDM_TPU_NO_RENDER"):
        return
    try:
        from ..visualize.plot_script import plot_3d_motion, plot_3d_motion_grid

        max_length = int(all_lengths.max())

        def cell(si, ri):
            m = motion_arr[ri * B + si][:max_length].copy()
            L = int(all_lengths[ri * B + si])
            if m.shape[0] > L:
                # freeze the last real frame so all cells share a duration
                # (reference generate.py:236-238)
                m[L:-1] = m[L - 1]
            return m

        # Prefix-completion context frames render in the GT (blue) colors
        # (reference generate.py:241-244; AR strips the prefix).
        gt_frames = (
            np.arange(model.config.context_len)
            if model.config.is_prefix_comp and not args.autoregressive
            else ()
        )
        for ri in range(args.num_repetitions):
            for si in range(B):
                path = os.path.join(out_dir, f"sample{si:02d}_rep{ri:02d}.mp4")
                path = plot_3d_motion(path, cell(si, ri), title=all_text[ri * B + si],
                                      dataset=args.dataset, fps=fps,
                                      gt_frames=gt_frames)
                print(f"rendered {path}")
        # Tiled grid, 3 samples (rows) x all repetitions (columns) per file
        # (reference save_multiple_samples, generate.py:253-280).
        for s0 in range(0, B, 3):
            s1 = min(s0 + 3, B)
            cells, titles = [], []
            for si in range(s0, s1):
                for ri in range(args.num_repetitions):
                    cells.append(cell(si, ri))
                    titles.append(all_text[ri * B + si])
            grid = os.path.join(out_dir, f"samples_{s0:02d}_to_{s1 - 1:02d}.mp4")
            grid = plot_3d_motion_grid(
                grid, cells, titles, ncols=args.num_repetitions,
                dataset=args.dataset, fps=fps, gt_frames=gt_frames,
            )
            print(f"rendered {grid}")
    except Exception as e:
        print(f"(skipping video render: {e})")


if __name__ == "__main__":
    main()
