"""Convert a reference PyTorch MDM checkpoint to a checkpoint of the port.

Counterpart of mdm_tpu/cli/convert_checkpoint.py:

    python -m mdm_tpu_torch.cli.convert_checkpoint \\
        --torch_ckpt ./save/humanml_trans_enc_512/model000475000.pt \\
        --out_dir ./save/humanml_trans_enc_512_torch

Writes ``ckpt_{step:09d}`` (the parameters, the EMA copy, the step) and
``args.json`` in the port's format (train/checkpoints.py), so that
``cli.generate``, ``cli.edit`` and ``Predictor`` load the run unchanged. The
model fields come from the reference run's ``args.json`` beside the .pt when
there is one, else from the flags. The model is built on the CPU and loads
the converted weights with ``strict=True``, which checks every name and
shape.
"""
from __future__ import annotations

import argparse
import os
import re

# The reference args.json fields that shape the model (mdm_tpu's list, and
# the DiP / goal / conditioning fields its factory also reads).
MODEL_FIELDS = ("dataset", "latent_dim", "ff_size", "num_heads", "layers", "arch",
                "text_encoder_type", "cond_mask_prob", "emb_trans_dec", "context_len",
                "pred_len", "emb_policy", "mask_frames", "multi_target_cond",
                "multi_encoder_type", "target_enc_layers", "unconstrained", "use_ema",
                "noise_schedule", "diffusion_steps")


def main(argv=None):
    import json

    import torch

    from ..core.goals import ALL_GOAL_JOINT_NAMES
    from ..models.convert import convert_mdm_state_dict, load_torch_checkpoint
    from ..models.mdm import MDM
    from ..train.checkpoints import save_args, save_checkpoint
    from ..train.state import OptimConfig, create_train_state
    from ..utils.factory import get_model_config
    from ..utils.parser import apply_rules

    p = argparse.ArgumentParser()
    p.add_argument("--torch_ckpt", required=True)
    p.add_argument("--out_dir", required=True)
    p.add_argument("--dataset", default="humanml")
    p.add_argument("--latent_dim", default=512, type=int)
    p.add_argument("--ff_size", default=1024, type=int)
    p.add_argument("--num_heads", default=4, type=int)
    p.add_argument("--layers", default=8, type=int)
    p.add_argument("--arch", default="trans_enc")
    p.add_argument("--text_encoder_type", default="clip")
    p.add_argument("--cond_mask_prob", default=0.1, type=float)
    p.add_argument("--emb_trans_dec", default=False, type=lambda x: str(x).lower() == "true")
    p.add_argument("--context_len", default=0, type=int)
    p.add_argument("--pred_len", default=0, type=int)
    args = p.parse_args(argv)

    ref_args_path = os.path.join(os.path.dirname(os.path.abspath(args.torch_ckpt)), "args.json")
    if os.path.exists(ref_args_path):
        with open(ref_args_path) as f:
            saved = json.load(f)
        for k in MODEL_FIELDS:
            if k in saved:
                setattr(args, k, saved[k])

    args = apply_rules(args)
    num_actions = {"humanact12": 12, "uestc": 40}.get(args.dataset, 1)
    config = get_model_config(args, num_actions)
    goal_joints = ALL_GOAL_JOINT_NAMES if args.dataset == "humanml" else None
    params = convert_mdm_state_dict(load_torch_checkpoint(args.torch_ckpt, use_ema=False),
                                    config, goal_joints)
    ema = convert_mdm_state_dict(load_torch_checkpoint(args.torch_ckpt, use_ema=True),
                                 config, goal_joints)

    model = MDM(config)
    model.load_state_dict(params, strict=True)
    state = create_train_state(model, OptimConfig())
    missing = set(state.ema_params) - set(ema)
    if missing:
        raise KeyError(f"EMA state dict lacks {sorted(missing)}")
    with torch.no_grad():
        for name, t in state.ema_params.items():
            t.copy_(ema[name])
    m = re.search(r"(\d+)", os.path.basename(args.torch_ckpt))
    state.step = int(m.group(1)) if m else 0

    save_args(args.out_dir, vars(args))
    path = save_checkpoint(args.out_dir, state.step, state)
    print(f"converted -> {path}")
    return path


if __name__ == "__main__":
    main()
