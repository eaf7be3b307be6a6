"""CLI argument system (reference utils/parser_util.py:1-319).

Counterpart of mdm_tpu/utils/parser.py with the same flags and defaults.
Every CLI parses through ``_build``, which first turns on the kernel cache
(utils/compile_cache.py: ``MDM_TPU_COMPILE_CACHE`` chooses the directory
the CUDA kernels' library is built into and loaded from), and ``--device``
picks the card:
``--device N`` (the default, 0) runs on ``cuda:N`` and ``--device cpu``
on the CPU; ``select_device(args)`` raises when no CUDA device is visible
and the CPU was not asked for.

Same three-tier scheme:
1. argparse groups (base/diffusion/model/dataset/training/sampling/generate/
   edit/eval);
2. a persisted `args.json` written next to checkpoints at training time and
   *re-loaded over* the model/diffusion/dataset groups by every downstream
   CLI (parse_and_load_from_model);
3. derived rules (`apply_rules`): pred_len defaults to context_len,
   lambda_target_loc > 0 implies multi_target_cond, cond_mask_prob == 0
   clamps guidance to 1.
"""
from __future__ import annotations

import argparse
import json
import os
from typing import List, Optional, Union

MODEL_GROUPS = ("dataset", "model", "diffusion")


def _device_arg(value: str) -> Union[int, str]:
    """``--device``: a CUDA device index, or ``cpu``."""
    return "cpu" if value == "cpu" else int(value)


def select_device(args):
    """The torch device ``args.device`` names, made the current CUDA device:
    ``cuda:N`` for an index, which must exist (no silent CPU run), or the
    CPU for ``cpu``. In a torch.distributed world of several ranks the
    default index 0 names the rank's own card,
    ``cuda:{LOCAL_RANK % device_count}`` (parallel/multihost.py), and an
    nccl world refuses the CPU."""
    import torch

    from ..parallel.multihost import local_device, world_size

    if world_size() > 1:
        import torch.distributed as dist

        if args.device == "cpu" and dist.get_backend() == "nccl":
            raise RuntimeError("--device cpu in an nccl world: nccl moves CUDA tensors only; "
                               "set MDM_TPU_DIST_BACKEND=gloo for a CPU world")
        if args.device == 0 and torch.cuda.is_available():
            torch.cuda.set_device(local_device())
            return local_device()
    if args.device == "cpu":
        return torch.device("cpu")
    if not torch.cuda.is_available():
        raise RuntimeError(f"--device {args.device}: no CUDA device is visible; "
                           "pass --device cpu to run on the CPU")
    if not 0 <= args.device < torch.cuda.device_count():
        raise RuntimeError(f"--device {args.device}: only {torch.cuda.device_count()} "
                           "CUDA devices are visible")
    torch.cuda.set_device(args.device)  # the kernels launch on the current device's stream
    return torch.device("cuda", args.device)


def add_base_options(parser):
    g = parser.add_argument_group("base")
    g.add_argument("--seed", default=10, type=int)
    g.add_argument("--batch_size", default=64, type=int)
    g.add_argument("--cuda", default=True, type=bool,
                   help="accepted for reference-arg compat; --device picks "
                        "the device (reference parser_util.py:76)")
    g.add_argument("--external_mode", default=False, type=bool,
                   help="accepted for compat; backward-compat no-op in the "
                        "reference too (parser_util.py:82)")
    g.add_argument("--device", default=0, type=_device_arg,
                   help="CUDA device index (default 0), or 'cpu'")
    g.add_argument("--train_platform_type", default="NoPlatform", type=str,
                   choices=["NoPlatform", "Tensorboard", "WandB", "ClearML"])


def add_diffusion_options(parser):
    g = parser.add_argument_group("diffusion")
    g.add_argument("--noise_schedule", default="cosine", choices=["linear", "cosine"])
    g.add_argument("--diffusion_steps", default=1000, type=int)
    g.add_argument("--sigma_small", default=True, type=lambda x: str(x).lower() != "false")


def add_model_options(parser):
    g = parser.add_argument_group("model")
    # dit: DiT's AdaLN-Zero blocks (models/mdm.py), generation only (DiT-XL: --layers 28
    # --latent_dim 1152 --ff_size 4608 --num_heads 16)
    g.add_argument("--arch", default="trans_enc", choices=["trans_enc", "trans_dec", "gru", "dit"])
    # 'hash': deterministic asset-free embeddings (beyond-reference; for
    # smoke runs and new-dataset bootstrapping without CLIP/BERT weights).
    g.add_argument("--text_encoder_type", default="clip",
                   choices=["clip", "bert", "hash"])
    g.add_argument("--emb_trans_dec", default=False, type=lambda x: str(x).lower() == "true")
    g.add_argument("--emb_policy", default="add", choices=["add", "cat"])
    g.add_argument("--layers", default=8, type=int)
    g.add_argument("--latent_dim", default=512, type=int)
    g.add_argument("--ff_size", default=1024, type=int)
    g.add_argument("--num_heads", default=4, type=int)
    g.add_argument("--cond_mask_prob", default=0.1, type=float)
    g.add_argument("--mask_frames", action="store_true")
    g.add_argument("--lambda_rcxyz", default=0.0, type=float)
    g.add_argument("--lambda_vel", default=0.0, type=float)
    g.add_argument("--lambda_fc", default=0.0, type=float)
    g.add_argument("--lambda_target_loc", default=0.0, type=float)
    g.add_argument("--unconstrained", action="store_true")
    g.add_argument("--pos_embed_max_len", default=5000, type=int)
    # Reference default is OFF (parser_util.py:121, store_true); eval/sample
    # load the avg model only when the checkpoint was trained with it
    # (model_util.py:118-122) — this flag rides args.json like the reference.
    g.add_argument("--use_ema", default=False, type=lambda x: str(x).lower() == "true",
                   nargs="?", const=True)
    g.add_argument("--multi_target_cond", action="store_true")
    g.add_argument("--multi_encoder_type", default="multi", choices=["multi", "single", "split"])
    g.add_argument("--target_enc_layers", default=1, type=int)
    g.add_argument("--context_len", default=0, type=int)
    g.add_argument("--pred_len", default=0, type=int)
    g.add_argument("--compute_dtype", default="float32", choices=["float32", "bfloat16"])


def add_data_options(parser):
    g = parser.add_argument_group("dataset")
    g.add_argument("--dataset", default="humanml",
                   choices=["humanml", "kit", "humanact12", "uestc"])
    g.add_argument("--data_dir", default="", type=str)


def add_training_options(parser):
    g = parser.add_argument_group("training")
    g.add_argument("--save_dir", required=True, type=str)
    g.add_argument("--overwrite", action="store_true")
    g.add_argument("--lr", default=1e-4, type=float)
    g.add_argument("--weight_decay", default=0.0, type=float)
    g.add_argument("--adam_beta2", default=0.999, type=float)
    g.add_argument("--avg_model_beta", default=0.9999, type=float)
    g.add_argument("--lr_anneal_steps", default=0, type=int)
    g.add_argument("--log_interval", default=1000, type=int)
    g.add_argument("--save_interval", default=50000, type=int)
    g.add_argument("--profile_trace_dir", default="", type=str,
                   help="capture a torch.profiler trace of steps 2-6 here "
                        "(TensorBoard/Perfetto)")
    g.add_argument("--num_steps", default=600_000, type=int)
    g.add_argument("--num_frames", default=60, type=int)
    # 'uniform' is the reference's effective default (training_loop.py:104
    # hardcodes it); 'loss-second-moment' activates the importance sampler
    # the reference ships as dead code (diffusion/resample.py:83-154), here
    # as a ring buffer updated inside the jitted step.
    g.add_argument("--schedule_sampler", default="uniform",
                   choices=["uniform", "loss-second-moment"])
    g.add_argument("--cache_batches", default=0, type=int,
                   help="device-cache the first N collated batches and cycle "
                        "them (beyond-reference; small datasets / slow host "
                        "links). Deviates from per-epoch reshuffle; off by "
                        "default")
    g.add_argument("--resume_checkpoint", default="", type=str)
    g.add_argument("--eval_during_training", action="store_true")
    g.add_argument("--eval_batch_size", default=32, type=int)
    g.add_argument("--eval_split", default="test", choices=["val", "test"])
    g.add_argument("--eval_rep_times", default=3, type=int)
    g.add_argument("--eval_num_samples", default=1000, type=int)
    g.add_argument("--evaluator_dir", default=".", type=str,
                   help="dir containing t2m/text_mot_match/model/finest.{tar,npy}"
                        " for --eval_during_training (reference get_opt"
                        " checkpoints_dir)")
    g.add_argument("--gen_during_training", action="store_true")
    g.add_argument("--gen_num_samples", default=3, type=int)
    g.add_argument("--gen_num_repetitions", default=2, type=int)
    g.add_argument("--gen_guidance_param", default=2.5, type=float)
    g.add_argument("--target_joint_names", default="DIMP_FINAL", type=str)
    g.add_argument("--autoregressive", action="store_true")
    g.add_argument("--autoregressive_include_prefix", action="store_true")
    # accepted for reference CLI compatibility; declared-but-unused upstream
    g.add_argument("--autoregressive_init", default="data", choices=["data", "isaac"],
                   help="accepted for compat; unused (dead flag in the reference too)")


def add_sampling_options(parser):
    g = parser.add_argument_group("sampling")
    g.add_argument("--model_path", required=True, type=str)
    g.add_argument("--output_dir", default="", type=str)
    g.add_argument("--num_samples", default=10, type=int)
    g.add_argument("--num_repetitions", default=3, type=int)
    g.add_argument("--guidance_param", default=2.5, type=float)
    g.add_argument("--sampler", default="ddpm",
                   choices=["ddpm", "ddim", "plms", "dpmpp_2m"],
                   help="denoise loop; dpmpp_2m is the fast multistep ODE "
                        "solver (beyond-reference, good at 10-20 steps)")
    g.add_argument("--cfg_cache_interval", default=0, type=int,
                   help=">1 reuses the uncond CFG branch for k steps "
                        "(1 + 1/k forwards per step; approximate)")
    g.add_argument("--autoregressive", action="store_true")
    g.add_argument("--autoregressive_include_prefix", action="store_true")
    g.add_argument("--autoregressive_init", default="data", choices=["data", "isaac"],
                   help="accepted for compat; unused (dead flag in the reference too)")


def add_generate_options(parser):
    g = parser.add_argument_group("generate")
    g.add_argument("--motion_length", default=6.0, type=float)
    g.add_argument("--input_text", default="", type=str)
    g.add_argument("--dynamic_text_path", default="", type=str)
    g.add_argument("--text_prompt", default="", type=str)
    g.add_argument("--action_file", default="", type=str)
    g.add_argument("--action_name", default="", type=str)
    g.add_argument("--target_joint_names", default="", type=str)


def add_edit_options(parser):
    g = parser.add_argument_group("edit")
    g.add_argument("--edit_mode", default="in_between", choices=["in_between", "upper_body"])
    g.add_argument("--text_condition", default="", type=str)
    # Beyond-reference: condition each edit on its dataset caption. The
    # reference always REPLACES captions with --text_condition and forces
    # guidance 0 when it is empty (sample/edit.py:69-72), i.e. default
    # in-betweening is unconditioned there; this flag opts into
    # caption-conditioned editing instead.
    g.add_argument("--use_dataset_captions", action="store_true")
    g.add_argument("--prefix_end", default=0.25, type=float)
    g.add_argument("--suffix_start", default=0.75, type=float)


def add_evaluation_options(parser):
    g = parser.add_argument_group("eval")
    g.add_argument("--model_path", required=True, type=str)
    g.add_argument("--eval_mode", default="wo_mm", choices=["wo_mm", "mm_short", "debug", "full"])
    g.add_argument("--guidance_param", default=2.5, type=float)
    g.add_argument("--autoregressive", action="store_true")
    # Score the original T2M baseline generator alongside the MDM model
    # (reference comp_v6_model_dataset.py via motion_loaders): path to the
    # Comp_v6 `.tar` checkpoint and its sibling length-estimator checkpoint.
    g.add_argument("--t2m_baseline_path", default="", type=str)
    g.add_argument("--t2m_len_est_path", default="", type=str)
    g.add_argument("--evaluator_dir", default=".", type=str,
                   help="dir containing t2m/text_mot_match/model/finest.{tar,npy}"
                        " (reference get_opt checkpoints_dir)")
    g.add_argument("--replications", default=0, type=int,
                   help="override the eval_mode's replication count "
                        "(0 = mode default: debug 5 / wo_mm 20 / mm_short 5)")
    g.add_argument("--a2m_classifier_path", default="", type=str,
                   help="self-trained a2m classifier .npy (train_evaluators "
                        "--stage a2m_classifier) instead of the converted "
                        "reference checkpoint; functional but stamped "
                        "non-comparable to published tables")


def get_cond_mode(args) -> str:
    if getattr(args, "unconstrained", False):
        return "no_cond"
    if args.dataset in ("humanml", "kit"):
        return "text"
    return "action"


def apply_rules(args):
    """Derived-arg rules (reference parser_util.py:46-54, 22-23)."""
    if getattr(args, "context_len", 0) > 0 and getattr(args, "pred_len", 0) == 0:
        args.pred_len = args.context_len
    if getattr(args, "lambda_target_loc", 0.0) > 0:
        args.multi_target_cond = True
    if getattr(args, "cond_mask_prob", 1.0) == 0 and hasattr(args, "guidance_param"):
        args.guidance_param = 1.0
    args.cond_mode = get_cond_mode(args)
    return args


def _group_arg_names(parser) -> List[str]:
    names = []
    for group in parser._action_groups:
        if group.title in MODEL_GROUPS:
            names += [a.dest for a in group._group_actions]
    return names


def load_args_from_model(args, parser, model_path: str):
    """Overlay model/diffusion/dataset args from the run's args.json: beside
    a checkpoint, or in a run directory given as the model path."""
    run_dir = (model_path if os.path.isdir(model_path)
               and not os.path.basename(os.path.normpath(model_path)).startswith("ckpt_")
               else os.path.dirname(model_path))
    args_path = os.path.join(run_dir, "args.json")
    if not os.path.exists(args_path):
        return args
    with open(args_path) as f:
        saved = json.load(f)
    for name in _group_arg_names(parser):
        if name in saved:
            setattr(args, name, saved[name])
    return args


def _build(groups, argv=None):
    # Every CLI funnels through here before its first kernel launch: the
    # one central place to make the kernel library's directory
    # (MDM_TPU_COMPILE_CACHE; utils/compile_cache.py).
    from .compile_cache import enable_compile_cache

    enable_compile_cache()
    parser = argparse.ArgumentParser()
    for g in groups:
        g(parser)
    args = parser.parse_args(argv)
    return parser, args


def train_args(argv: Optional[List[str]] = None):
    _, args = _build(
        [add_base_options, add_data_options, add_model_options,
         add_diffusion_options, add_training_options], argv,
    )
    return apply_rules(args)


def generate_args(argv: Optional[List[str]] = None):
    parser, args = _build(
        [add_base_options, add_data_options, add_model_options,
         add_diffusion_options, add_sampling_options, add_generate_options], argv,
    )
    args = load_args_from_model(args, parser, args.model_path)
    return apply_rules(args)


def edit_args(argv: Optional[List[str]] = None):
    parser, args = _build(
        [add_base_options, add_data_options, add_model_options,
         add_diffusion_options, add_sampling_options, add_edit_options], argv,
    )
    args = load_args_from_model(args, parser, args.model_path)
    return apply_rules(args)


def evaluation_args(argv: Optional[List[str]] = None):
    parser, args = _build(
        [add_base_options, add_data_options, add_model_options,
         add_diffusion_options, add_evaluation_options], argv,
    )
    args = load_args_from_model(args, parser, args.model_path)
    args.batch_size = 32  # protocol-locked
    return apply_rules(args)
