"""Editing entry point (inpainting): `python -m mdm_tpu_torch.cli.edit`.

Counterpart of mdm_tpu/cli/edit.py (reference sample/edit.py) on
``--device`` (the card unless ``--device cpu``). Modes: in_between (keep
the prefix before prefix_end*len and the suffix from suffix_start*len) and
upper_body (keep the lower-body feature dims); the mask is applied to the
x0 prediction in every diffusion step. The ground truth is the first
batch of the dataset's test split; results.npy has mdm_tpu's keys.
"""
from __future__ import annotations

import os

import numpy as np
import torch


def main(argv=None):
    from ..data import get_dataset_loader
    from ..models.mdm import Conditioning
    from ..sampling import GenerationConfig, MotionGenerator, in_between_mask, upper_body_mask
    from ..sampling.pipeline import dataset_norm_stats
    from ..sampling.text import make_text_embedder
    from ..utils.factory import create_model_and_schedule
    from ..utils.parser import edit_args, select_device
    from .generate import load_model

    args = edit_args(argv)
    device = select_device(args)
    max_frames = 196 if args.dataset in ("humanml", "kit") else 60

    data = get_dataset_loader(
        args.dataset, args.num_samples, num_frames=max_frames, split="test",
        hml_mode="train", data_root=args.data_dir or None,
    )
    batch = next(iter(data))
    gt = batch["x"][: args.num_samples]
    lengths = batch["lengths"][: args.num_samples]
    B, T, D = gt.shape

    model, sched = create_model_and_schedule(args)
    model = load_model(args, model, device)
    cond0 = Conditioning(
        frames_mask=torch.as_tensor(batch["mask"][:B]),
        text_embed=torch.zeros((B, model.config.text_dim)),
    ).to(device)

    if args.edit_mode == "in_between":
        mask = in_between_mask(lengths, T, D, args.prefix_end, args.suffix_start)
    else:
        mask = upper_body_mask(T, B)

    # Text conditioning as reference edit.py:69-72: --text_condition
    # replaces every caption, and empty text forces guidance 0 (the
    # reference's default in-betweening is unconditioned);
    # --use_dataset_captions instead conditions each sample on its own
    # dataset caption at the requested guidance.
    guidance = args.guidance_param
    cond = cond0
    texts = None
    if args.text_condition:
        texts = [args.text_condition] * B
    elif args.use_dataset_captions and batch.get("text"):
        texts = list(batch["text"][:B])
    if texts is not None:
        embedder = make_text_embedder(args.text_encoder_type)
        if embedder is not None:
            cond = cond0.replace(**{k: torch.as_tensor(v).to(device)
                                    for k, v in embedder(texts).items()})
        else:
            # No encoder assets: the captions cannot condition the model, so
            # edit unconditioned, loudly, and record no captions.
            print(
                "WARNING: text encoder unavailable "
                f"({args.text_encoder_type!r}); editing unconditioned "
                "(guidance 0) — requested captions ignored"
            )
            texts = None
            guidance = 0.0
    else:
        guidance = 0.0

    gen = MotionGenerator(
        model, sched,
        GenerationConfig(guidance_scale=guidance, sampler=args.sampler),
        args.dataset,
        norm_stats=dataset_norm_stats(args.data_dir or None),
    )
    feats = gen.sample_features(
        cond, B, T, torch.Generator(device).manual_seed(args.seed),
        inpainting_mask=torch.as_tensor(mask).to(device),
        inpainted_motion=torch.as_tensor(gt).to(device),
    )
    joints = gen.features_to_joints(feats) if gen.mean is not None else feats
    joints = joints.float().cpu().numpy()

    out_dir = args.output_dir or os.path.join(
        os.path.dirname(args.model_path) or ".", f"edit_{args.edit_mode}_seed{args.seed}"
    )
    os.makedirs(out_dir, exist_ok=True)
    np.save(
        os.path.join(out_dir, "results.npy"),
        {"motion": joints, "gt": np.asarray(gt), "mask": mask,
         "edit_mode": args.edit_mode, "lengths": lengths,
         "text": texts if texts is not None else [""] * B},
    )
    print(f"saved {os.path.join(out_dir, 'results.npy')}")


if __name__ == "__main__":
    main()
