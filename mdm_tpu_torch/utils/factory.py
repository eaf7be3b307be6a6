"""Model/diffusion factory (reference utils/model_util.py:18-116).

Counterpart of mdm_tpu/utils/factory.py: the same args give the port's
MDMConfig, Schedule and LossConfig the same fields.

Maps (args, dataset) -> MDMConfig + Schedule + LossConfig, pinning MDM's
fixed choices: predict-x0, MSE loss, FIXED_SMALL sigma (sigma_small=True).
"""
from __future__ import annotations

from typing import Optional, Tuple

from ..core.hml_codec import HML_EE_JOINT_NAMES
from ..diffusion import LossConfig, MeanType, Schedule, VarType
from ..models.mdm import MDM, MDMConfig


def get_model_config(args, num_actions: int = 1) -> MDMConfig:
    data_rep, njoints, nfeats = "rot6d", 25, 6
    num_goal_joints = 0
    if args.dataset == "humanml":
        data_rep, njoints, nfeats = "hml_vec", 263, 1
        num_goal_joints = 1 + len(HML_EE_JOINT_NAMES)  # pelvis + end effectors
    elif args.dataset == "kit":
        data_rep, njoints, nfeats = "hml_vec", 251, 1

    text_tokens = getattr(args, "text_encoder_type", "clip") == "bert"
    return MDMConfig(
        njoints=njoints,
        nfeats=nfeats,
        latent_dim=args.latent_dim,
        ff_size=getattr(args, "ff_size", 1024),
        num_layers=args.layers,
        num_heads=getattr(args, "num_heads", 4),
        dropout=0.1,
        data_rep=data_rep,
        arch=args.arch,
        cond_mode=getattr(args, "cond_mode", "text"),
        text_dim=768 if text_tokens else 512,
        text_tokens=text_tokens,
        num_actions=num_actions,
        emb_trans_dec=getattr(args, "emb_trans_dec", False),
        emb_policy=getattr(args, "emb_policy", "add"),
        pos_embed_max_len=getattr(args, "pos_embed_max_len", 5000),
        mask_frames=getattr(args, "mask_frames", False),
        context_len=getattr(args, "context_len", 0),
        pred_len=getattr(args, "pred_len", 0),
        multi_target_cond=getattr(args, "multi_target_cond", False),
        multi_encoder_type=getattr(args, "multi_encoder_type", "multi"),
        target_enc_layers=getattr(args, "target_enc_layers", 1),
        num_goal_joints=num_goal_joints,
        compute_dtype=getattr(args, "compute_dtype", "float32"),
    )


def create_schedule(args, timestep_respacing: Optional[str] = None) -> Schedule:
    return Schedule.create(
        noise_schedule=args.noise_schedule,
        diffusion_steps=args.diffusion_steps,
        timestep_respacing=timestep_respacing,
    )


def create_loss_config(args) -> LossConfig:
    # a2m (rot6d) motions carry the root translation as a trailing 6-feature
    # row that the velocity loss excludes (reference gaussian_diffusion.py:1337).
    vel_drop = 6 if args.dataset in ("humanact12", "uestc") else 0
    return LossConfig(
        mean_type=MeanType.START_X,  # MDM always predicts x0
        var_type=VarType.FIXED_SMALL if getattr(args, "sigma_small", True) else VarType.FIXED_LARGE,
        lambda_rcxyz=getattr(args, "lambda_rcxyz", 0.0),
        lambda_vel=getattr(args, "lambda_vel", 0.0),
        lambda_fc=getattr(args, "lambda_fc", 0.0),
        lambda_target_loc=getattr(args, "lambda_target_loc", 0.0),
        vel_drop_last_feats=vel_drop,
    )


def create_model_and_schedule(
    args, num_actions: int = 1, timestep_respacing: Optional[str] = None
) -> Tuple[MDM, Schedule]:
    return MDM(get_model_config(args, num_actions)), create_schedule(args, timestep_respacing)
