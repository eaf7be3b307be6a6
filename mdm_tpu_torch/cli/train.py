"""Training entry point: `python -m mdm_tpu_torch.cli.train --save_dir ...`.

Counterpart of mdm_tpu/cli/train.py (reference train/train_mdm.py) on one
device: ``--device N`` (the default, 0) trains on ``cuda:N``, where every
layer runs the hand-written kernels; ``--device cpu`` trains on the CPU
through their plain versions. With no CUDA device visible and the CPU not
asked for, it raises. The run writes args.json and ``ckpt_{step:09d}``
files (torch.save) into --save_dir and resumes from the highest step there
bit for bit: the batches are a pure function of (seed, step) and so are the
step's draws.

On HumanAct12 / UESTC, ``--lambda_rcxyz`` / ``--lambda_fc`` decode the
rot6d features to joints through the SMPL layer inside the loss
(``body_models/smpl/SMPL_NEUTRAL.pkl``, FileNotFoundError without it); on
HumanML3D / KIT the step refuses them, as mdm_tpu's does.

``--eval_during_training`` runs at every save the t2m evaluation protocol
(when an evaluator checkpoint is present under ``--evaluator_dir``) or, on
an action dataset, the a2m protocol at guidance 1, both from the EMA
weights when the run keeps them.

Not here: a multi-process run (MDM_TPU_COORDINATOR / MDM_TPU_MULTIHOST
raise, naming ROADMAP Queue 1 item 10).
"""
from __future__ import annotations

import os

import numpy as np
import torch


def refuse_multi_process():
    """The port trains on one device: a multi-process launch raises."""
    for var in ("MDM_TPU_COORDINATOR", "MDM_TPU_MULTIHOST"):
        if os.environ.get(var):
            raise NotImplementedError(
                f"{var}={os.environ[var]!r} asks for a multi-process run; mdm_tpu_torch's "
                "training is single-device (data parallelism is ROADMAP Queue 1 item 10)")


def main(argv=None):
    from ..data import get_dataset_loader
    from ..data.loader import pin_batch
    from ..train import (
        LoopConfig,
        OptimConfig,
        TrainLoop,
        TrainStepConfig,
        create_train_state,
        make_train_step,
    )
    from ..train.platforms import get_platform
    from ..utils.factory import create_loss_config, create_model_and_schedule
    from ..utils.parser import select_device, train_args

    refuse_multi_process()
    args = train_args(argv)
    device = select_device(args)
    if os.path.exists(args.save_dir) and os.listdir(args.save_dir) and not args.overwrite:
        if not any(f.startswith("ckpt_") for f in os.listdir(args.save_dir)):
            raise FileExistsError(
                f"save_dir {args.save_dir} exists (use --overwrite or resume)"
            )

    num_frames = 196 if args.dataset in ("humanml", "kit") else args.num_frames
    data = get_dataset_loader(
        args.dataset, args.batch_size, num_frames=num_frames,
        data_root=args.data_dir or None,
        fixed_len=args.context_len + args.pred_len,
        pred_len=args.pred_len,
    )
    if device.type == "cuda":
        # Pinned in the prefetch thread, so the copy to the card is non-blocking.
        data.host_transform = pin_batch
    num_actions = getattr(data.dataset, "num_actions", 1)

    # The embedder is resolved before the model: without the CLIP/BERT assets
    # training runs on the deterministic hash embedder and records
    # text_encoder_type=hash in args.json, so generate/edit rebuild the same
    # embedder (mdm_tpu/cli/train.py:70-84).
    text_embedder = None
    if args.cond_mode == "text":
        from ..sampling.text import make_text_embedder

        text_embedder = make_text_embedder(args.text_encoder_type, device=device)
        if text_embedder is None:
            print(
                "WARNING: text encoder assets unavailable "
                f"({args.text_encoder_type!r}); training on deterministic "
                "hash embeddings (text_encoder_type=hash recorded in "
                "args.json) — NOT semantically meaningful, smoke/dev only"
            )
            args.text_encoder_type = "hash"
            text_embedder = make_text_embedder("hash")

    model, sched = create_model_and_schedule(args, num_actions)
    # Seeded weights from a CPU generator (they cannot equal flax's init).
    model = model.init_weights(torch.Generator().manual_seed(args.seed)).to(device)
    sched = sched.to(device)
    if text_embedder is not None:
        data.text_embedder = text_embedder

    target_loss_builder = None
    target_cond_fn = None
    goal_modifier = None
    if getattr(args, "lambda_target_loc", 0.0) > 0 and args.dataset == "humanml":
        from ..train.goal_cond import (
            goal_cond_modifier,
            make_target_cond_fn,
            make_target_loss_builder,
        )

        mean, std = data.dataset.mean, data.dataset.std
        target_loss_builder = make_target_loss_builder(mean, std)
        target_cond_fn = make_target_cond_fn(mean, std)
        goal_rng = np.random.default_rng(args.seed + 1)

        def goal_modifier(b):
            # compute_target=False: the step extracts the GT targets.
            return goal_cond_modifier(
                b, goal_rng, mean, std,
                force_joints=args.target_joint_names or None,
                compute_target=False,
            )

    n_params = sum(p.numel() for p in model.parameters())
    print(f"model params: {n_params/1e6:.2f}M")

    config = TrainStepConfig(
        loss=create_loss_config(args),
        optim=OptimConfig(
            lr=args.lr, weight_decay=args.weight_decay,
            adam_beta2=args.adam_beta2, lr_anneal_steps=args.lr_anneal_steps,
            ema_decay=args.avg_model_beta, use_ema=args.use_ema,
        ),
        cond_mask_prob=args.cond_mask_prob,
        schedule_sampler=getattr(args, "schedule_sampler", "uniform"),
    )
    # Geometric losses (rcxyz / vel_rcxyz / fc) decode rot6d -> joints through
    # the differentiable SMPL layer inside the loss (reference
    # gaussian_diffusion.py:1241-1347); elsewhere the step refuses them.
    get_xyz = None
    if (args.lambda_rcxyz > 0 or args.lambda_fc > 0) and args.dataset in ("humanact12", "uestc"):
        get_xyz = make_get_xyz()
    step = make_train_step(
        sched, config, get_xyz=get_xyz,
        target_loss_builder=target_loss_builder,
        target_cond_fn=target_cond_fn if target_loss_builder else None,
    )
    if config.schedule_sampler == "loss-second-moment":
        # The loss-aware step threads its per-timestep loss history beside
        # the train state; adapt it to TrainLoop's (state, batch, key) step.
        from ..train.resample import LossAwareState

        sampler_box = {"s": LossAwareState.create(sched.num_timesteps, device=device)}
        inner_step = step

        def step(state, batch, key):  # noqa: F811
            state, metrics, sampler_box["s"] = inner_step(state, batch, key, sampler_box["s"])
            return state, metrics

    state = create_train_state(model, config.optim)
    platform = get_platform(args.train_platform_type, args.save_dir)

    gen_fn = None
    if args.gen_during_training:
        gen_fn = make_gen_during_training(args, model, data, text_embedder, device)
    eval_fn = None
    if args.eval_during_training and args.dataset in ("humanml", "kit"):
        eval_fn = make_eval_during_training(args, model, text_embedder, device)
    elif args.eval_during_training and args.dataset in ("humanact12", "uestc"):
        eval_fn = make_a2m_eval_during_training(args, model, data.dataset, num_frames, device)

    batches = wrap_batches(data, model.config, device, goal_modifier)
    if getattr(args, "cache_batches", 0) > 0:
        from ..data.loader import cache_device_batches

        batches = cache_device_batches(batches, args.cache_batches, device=device)

    loop = TrainLoop(
        step,
        state,
        batches,
        LoopConfig(
            save_dir=args.save_dir, num_steps=args.num_steps,
            log_interval=args.log_interval, save_interval=args.save_interval,
            profile_trace_dir=args.profile_trace_dir,
            eval_during_training=args.eval_during_training,
            gen_during_training=args.gen_during_training,
            resume_checkpoint=args.resume_checkpoint,
        ),
        args=vars(args),
        platform=platform,
        gen_fn=gen_fn,
        eval_fn=eval_fn,
        rng_seed=args.seed,
    )
    loop.run()
    platform.close()
    return loop


def make_eval_during_training(args, model, text_embedder, device):
    """Short t2m eval pass per checkpoint (reference
    training_loop.py:252-289; mdm_tpu/cli/train.py:229-319), sampling from
    the EMA weights when the run keeps them.

    Requires the frozen evaluator checkpoint (t2m/text_mot_match/model/
    finest.tar, or a self-trained finest.npy); a no-op with a message when
    it is absent. The ground-truth batches, the sampling copy of the model
    and the evaluator are built on the first call and reused."""
    import glob

    evaluator_dir = getattr(args, "evaluator_dir", ".") or "."
    ckpt = os.path.join(
        evaluator_dir,
        "t2m" if args.dataset == "humanml" else args.dataset,
        "text_mot_match", "model", "finest.tar",
    )
    if not glob.glob(os.path.splitext(ckpt)[0] + ".*"):
        print(f"eval_during_training: evaluator checkpoint {ckpt} missing; skipping")
        return None
    cache = {}

    def eval_fn(state, step):
        from ..data import BatchIterator, WordVectorizer, get_dataset
        from ..diffusion import Schedule
        from ..eval import EvalConfig, EvaluatorWrapper, GeneratedMotionLoader, evaluation
        from ..sampling import GenerationConfig, MotionGenerator

        if not cache:
            glove_dir = "glove"
            w_vec = None
            if os.path.exists(os.path.join(glove_dir, "our_vab_data.npy")):
                w_vec = WordVectorizer(glove_dir, "our_vab")
            dataset = get_dataset(
                args.dataset, split=args.eval_split, hml_mode="eval",
                data_root=args.data_dir or None,
            )
            dataset.w_vectorizer = w_vec
            gt_batches = []
            it = BatchIterator(dataset, args.eval_batch_size, seed=0, infinite=False)
            for i, b in enumerate(it):
                if (i + 1) * args.eval_batch_size > args.eval_num_samples:
                    break
                gt_batches.append(b)
            cache["gt_batches"] = gt_batches
            cache["gen"] = MotionGenerator(
                _sampling_copy(model), Schedule.create(args.noise_schedule, args.diffusion_steps),
                GenerationConfig(guidance_scale=args.gen_guidance_param), args.dataset,
            )
            cache["wrapper"] = EvaluatorWrapper(args.dataset, checkpoints_dir=evaluator_dir,
                                                device=device)
        gt_batches, gen = cache["gt_batches"], cache["gen"]
        _load_sampling_weights(gen.model, state)

        def embed(texts):
            if text_embedder is None:
                return {"text_embed": np.zeros((len(texts), model.config.text_dim), np.float32)}
            return text_embedder(texts)

        summary = evaluation(
            cache["wrapper"],
            gt_loader_fn=lambda: iter(gt_batches),
            eval_motion_loader_fns={
                "vald": lambda rep: GeneratedMotionLoader(gen, gt_batches, embed, seed=rep)
            },
            config=EvalConfig(replication_times=args.eval_rep_times),
        )
        flat = {}
        for metric, d in summary.items():
            if not isinstance(d, dict):  # the comparable / degraded_reasons stamps
                continue
            for name, v in d.items():
                mean = np.asarray(v["mean"]).ravel()
                flat[f"{metric}_{name}"] = float(mean[0]) if mean.size else float("nan")
        return flat

    return eval_fn


def make_get_xyz():
    """features [B, T, 150] -> the smpl joints [B, T, 24, 3] without the
    translation (rot2xyz, no skinning), in the features' dtype and device."""
    from ..smpl import Rot2XYZConfig, SMPLModel, rot2xyz

    smpl_model = SMPLModel.load()
    r2x_cfg = Rot2XYZConfig(jointstype="smpl", vertstrans=False)

    def get_xyz(feats):
        return rot2xyz(smpl_model, feats.reshape(feats.shape[0], feats.shape[1], 25, 6), r2x_cfg)

    return get_xyz


def make_a2m_eval_during_training(args, model, dataset, num_frames, device):
    """An action-dataset eval pass per checkpoint (mdm_tpu/cli/train.py:
    322-375; reference train/training_loop.py:275-286): accuracy / FID /
    diversity / multimodality through the frozen GRU (HumanAct12) or STGCN
    (UESTC) classifier, ``eval_rep_times`` seeds over ``eval_num_samples``
    clips each, at guidance 1 (training_loop.py:277), from the EMA weights
    when the run keeps them; flattened Eval-group scalars, with
    ``eval_comparable`` 0 when the classifier is a random init. The sampling
    copy of the model and the classifier are built once."""
    from ..diffusion import Schedule
    from ..eval.a2m_setup import build_feature_and_classifier, make_a2m_loaders_factory
    from ..eval.harness_a2m import A2MEvalConfig, A2MEvaluation, evaluate_multi_seed
    from ..sampling import GenerationConfig, MotionGenerator

    num_actions = getattr(dataset, "num_actions", 1)
    feature_input, clf, degraded = build_feature_and_classifier(
        args.dataset, num_actions, num_frames, model.config.input_feats,
        chunk=args.eval_batch_size, device=device)
    max_batches = max(1, args.eval_num_samples // max(1, args.eval_batch_size))
    gen = MotionGenerator(_sampling_copy(model),
                          Schedule.create(args.noise_schedule, args.diffusion_steps),
                          GenerationConfig(guidance_scale=1.0), args.dataset)
    ev = A2MEvaluation(clf, config=A2MEvalConfig(num_classes=num_actions))

    def eval_fn(state, step):
        _load_sampling_weights(gen.model, state)
        make_loaders = make_a2m_loaders_factory(dataset, gen, args.eval_batch_size, num_frames,
                                                feature_input, max_batches=max_batches)
        summary = evaluate_multi_seed(make_loaders, ev, num_seeds=args.eval_rep_times)
        flat = {k: float(v["mean"]) for k, v in summary.items()}
        if degraded:
            flat["eval_comparable"] = 0.0
        return flat

    return eval_fn


def _sampling_copy(model):
    """A second model of the same config for sampling with the EMA weights
    while the trained one keeps training."""
    device = next(model.parameters()).device
    copy = type(model)(model.config).to(device)
    copy.load_state_dict(model.state_dict())
    return copy


def _load_sampling_weights(sampler_model, state):
    """The trained weights, then the EMA ones where the run keeps them."""
    with torch.no_grad():
        sampler_model.load_state_dict(state.model.state_dict())
        if state.ema_params is not None:
            for name, p in sampler_model.named_parameters():
                p.copy_(state.ema_params[name])


def make_gen_during_training(args, model, data, text_embedder, device):
    """Render a few samples per checkpoint (reference training_loop.py:366-382),
    from the EMA weights when the run keeps them."""
    from ..diffusion import Schedule
    from ..models.mdm import Conditioning
    from ..sampling import GenerationConfig, MotionGenerator

    sampler_model = _sampling_copy(model)
    sched = Schedule.create(args.noise_schedule, args.diffusion_steps)
    gen = MotionGenerator(
        sampler_model, sched,
        GenerationConfig(guidance_scale=args.gen_guidance_param), args.dataset,
    )

    def gen_fn(state, step):
        B = args.gen_num_samples
        T = 196 if args.dataset in ("humanml", "kit") else args.num_frames
        _load_sampling_weights(sampler_model, state)
        batch = next(iter(data))
        texts = batch.get("text", ["sample"] * B)[:B]
        cond_kw = {"frames_mask": torch.ones((B, T), dtype=torch.bool, device=device)}
        if model.config.cond_mode == "text":
            if text_embedder is not None:
                cond_kw.update({k: torch.as_tensor(v).to(device)
                                for k, v in text_embedder(texts).items()})
            else:
                cond_kw["text_embed"] = torch.zeros((B, model.config.text_dim), device=device)
        elif "action" in batch:
            cond_kw["action"] = torch.as_tensor(batch["action"][:B]).to(device)
        paths = []
        generator = torch.Generator(device).manual_seed(step)
        for rep in range(max(1, args.gen_num_repetitions)):
            out = gen.generate(Conditioning(**cond_kw), B, T, generator)
            if os.environ.get("MDM_TPU_NO_RENDER") or "joints" not in out:
                continue
            try:
                from ..visualize.plot_script import plot_3d_motion

                path = os.path.join(args.save_dir, f"gen_step{step:09d}_rep{rep}.mp4")
                paths.append(plot_3d_motion(path, out["joints"][0].float().cpu().numpy(),
                                            title=str(texts[0]), dataset=args.dataset))
            except Exception as e:
                print(f"gen_during_training render failed: {e}")
        return paths or None

    return gen_fn


def batch_to_conditioning(batch, model_config):
    """Host batch dict (numpy arrays or tensors) -> Conditioning of CPU
    tensors (static shapes)."""
    from ..models.mdm import Conditioning

    kw = {}
    if "text_embed" in batch:
        kw["text_embed"] = torch.as_tensor(batch["text_embed"])
        if "text_tokens_mask" in batch:
            kw["text_tokens_mask"] = torch.as_tensor(batch["text_tokens_mask"])
    elif model_config.cond_mode == "text":
        # no tokenizer assets: zero embedding (smoke/dev mode)
        kw["text_embed"] = torch.zeros((batch["x"].shape[0], model_config.text_dim))
    for name in ("action", "prefix", "target_cond", "target_validity"):
        # target_validity may come without target_cond: the step then
        # extracts the GT targets (make_train_step(target_cond_fn=...)).
        if name in batch:
            kw[name] = torch.as_tensor(batch[name])
    return Conditioning(frames_mask=torch.as_tensor(batch["mask"]), **kw)


class WrappedBatches:
    """Adapts loader batches to train-step inputs on ``device`` (the copy
    non-blocking from pinned memory on the card); forwards `iter_from` so
    TrainLoop can fast-forward the stream on resume (bit-exact resume)."""

    def __init__(self, data, model_config, device, goal_modifier=None):
        from ..data.loader import pinned_put

        self.data = data
        self.model_config = model_config
        self.goal_modifier = goal_modifier
        self._put = pinned_put(device)

    def _wrap(self, batch):
        if self.goal_modifier is not None:
            batch = self.goal_modifier(batch)
        return self._put({
            "x": torch.as_tensor(batch["x"]),
            "mask": torch.as_tensor(batch["mask"]),
            "cond": batch_to_conditioning(batch, self.model_config),
        })

    def __iter__(self):
        return (self._wrap(b) for b in self.data)

    def iter_from(self, start_step: int):
        if hasattr(self.data, "iter_from"):
            inner = self.data.iter_from(start_step)
        else:
            inner = iter(self.data)
        return (self._wrap(b) for b in inner)


def wrap_batches(data, model_config, device, goal_modifier=None):
    return WrappedBatches(data, model_config, device, goal_modifier)


if __name__ == "__main__":
    main()
