"""Training for the T2M baseline generator (CompV6).

Counterpart of mdm_tpu/eval/train_t2m_generator.py: the reference's
``CompTrainerV6`` training path (data_loaders/humanml/networks/
trainers.py:211-746), the text-to-motion VAE seq2seq of Guo et al. whose
weights ``cli.eval_humanml --t2m_baseline_path`` scores beside MDM.
eval/t2m_generator.py holds the inference loop and the converters; this
module trains the generator from scratch on a user's own tree.

Parameters live in mdm_tpu's comp_v6 tree (flax layout, numpy arrays):
``init_comp_v6_params`` draws it, ``save_comp_v6_params`` writes it, the
port's ``load_comp_v6`` reads it and mdm_tpu's generator takes it as
``np.load(path).item()``. ``comp_v6_modules`` holds the
tree on a device for training: the movement encoder, the movement decoder
and the text biGRU as eval/networks.py modules, the posterior, the prior,
the decoder and the attention as nested ``nn.ParameterDict``s read by
t2m_generator's functions.

As in mdm_tpu (and the reference):

- The ``mov_len`` movements run as a Python loop of posterior, prior,
  decoder and teacher forcing; the step (forward, losses, backward, the
  clip per network, Adam) runs in float32 with TF32 off and cuDNN's
  deterministic algorithms (``networks.f32_math``).
- The movement targets, the first movement input and every teacher-forced
  next input are detached (trainers.py:291-294, 365-368): no gradient into
  ``mov_enc`` and none through the movement chain; backpropagation through
  time runs only through the GRU states and the attention over the words.
- ``mov_enc`` is frozen and in eval mode (trainers.py:530, 606-613);
  ``mov_dec`` trains at ``lr * 0.1``.
- The losses (trainers.py:452-472): SmoothL1 on motions and movements, KL
  (posterior || prior) summed over z and divided by ``mov_len * B``; the
  total keeps the reference's swapped lambda names.
- The curriculum (schedule_len 10 -> 49, trainers.py:616-746) is host code:
  sub-epochs per length with early stopping on the validation loss.

Randomness: ``init_comp_v6_params`` and the step's reparameterisation noise
draw from explicit ``torch.Generator``s (a step also takes its noise
injected, the seam the CPU tests hold the port to mdm_tpu by, since
``jax.random`` cannot be replayed); the teacher-forcing coin and the
curriculum batches draw from numpy generators exactly as mdm_tpu's do.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, Iterable, Mapping, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from .networks import f32_math, flax_params
from .t2m_generator import (
    _swap_deconvs,
    att_layer,
    init_hidden,
    network_modules,
    positional_table,
    prior_step,
    vae_decoder_step,
)
from .train_evaluators import _clip_per_network

TRAINABLE = ("text_enc", "seq_post", "seq_pri", "att_layer", "seq_dec",
             "mov_dec")


@dataclass(frozen=True)
class CompV6TrainConfig:
    """Hyperparameters of the Comp_v6_KLD01 stage.

    The reference repo ships the trainer but not its option parser (those
    live in the upstream text-to-motion repo); the dims below are the
    published Comp_v6_KLD01 architecture already pinned by
    ``t2m_generator.DEFAULTS``, and the lambdas follow the checkpoint's
    naming (KLD01 => lambda_kld = 0.01).
    """

    lr: float = 2e-4
    grad_clip: float = 0.5          # clip_grad_norm_(net, 0.5) per network
    unit_length: int = 4
    lambda_rec_mov: float = 1.0
    lambda_rec_mot: float = 1.0
    lambda_kld: float = 0.01
    tf_ratio: float = 0.4
    dim_pose: int = 263
    dim_word: int = 300
    dim_pos_ohot: int = 15
    dim_text_hidden: int = 512
    dim_att_vec: int = 512
    dim_z: int = 128
    dim_pri_hidden: int = 1024
    dim_dec_hidden: int = 1024
    dim_movement_latent: int = 512
    dim_movement_hidden: int = 512
    n_layers_pri: int = 1
    n_layers_dec: int = 1
    # curriculum (trainers.py:616-746)
    schedule_start: int = 10        # 6 for KIT
    schedule_end: int = 49
    max_sub_epoch: int = 50
    early_stop_count: int = 3


# ---------------------------------------------------------------------------
# Scratch initialization (mdm_tpu's laws, drawn from a torch.Generator)
# ---------------------------------------------------------------------------

def _numpy(t: torch.Tensor) -> np.ndarray:
    return t.numpy().astype(np.float32)


def _xavier_normal(g: torch.Generator, shape):
    fan_in, fan_out = shape[0], shape[-1]
    if len(shape) == 3:  # [k, in, out] conv kernels
        fan_in, fan_out = shape[0] * shape[1], shape[0] * shape[2]
    std = float(np.sqrt(2.0 / (fan_in + fan_out)))
    return _numpy(torch.randn(shape, generator=g) * std)


def _uniform(g: torch.Generator, shape, bound: float):
    return _numpy((torch.rand(shape, generator=g) * 2.0 - 1.0) * bound)


def _lin_init(g, d_in, d_out, bias=True):
    """init_weight (modules.py:27-32): xavier-normal W, zero bias."""
    p = {"kernel": _xavier_normal(g, (d_in, d_out))}
    if bias:
        p["bias"] = np.zeros((d_out,), np.float32)
    return p


def _ln_init(d):
    return {"scale": np.ones((d,), np.float32), "bias": np.zeros((d,), np.float32)}


def _gru_cell_init(g, d_in, d_h):
    """torch nn.GRUCell default: all U(-1/sqrt(H), 1/sqrt(H))."""
    bound = 1.0 / float(np.sqrt(d_h))
    return {"w_ih": _uniform(g, (d_in, 3 * d_h), bound),
            "w_hh": _uniform(g, (d_h, 3 * d_h), bound),
            "b_ih": _uniform(g, (3 * d_h,), bound), "b_hh": _uniform(g, (3 * d_h,), bound)}


def _text_decoder_init(g, text_size, d_in, d_out, d_h, n_layers):
    """TextDecoder (modules.py:188-230): emb/z2init/mu/logvar xavier."""
    p = {
        "emb": {"fc": _lin_init(g, d_in, d_h), "ln": _ln_init(d_h)},
        "z2init": _lin_init(g, text_size, d_h * n_layers),
        "mu_net": _lin_init(g, d_h, d_out),
        "logvar_net": _lin_init(g, d_h, d_out),
    }
    for i in range(n_layers):
        p[f"gru_{i}"] = _gru_cell_init(g, d_h, d_h)
    return p


def _vae_decoder_init(g, text_size, d_in, d_out, d_h, n_layers):
    """TextVAEDecoder (modules.py:123-185)."""
    p = {
        "emb": {"fc": _lin_init(g, d_in, d_h), "ln": _ln_init(d_h)},
        "z2init": _lin_init(g, text_size, d_h * n_layers),
        "out_fc1": _lin_init(g, d_h, d_h),
        "out_ln": _ln_init(d_h),
        "out_fc2": _lin_init(g, d_h, d_out),
    }
    for i in range(n_layers):
        p[f"gru_{i}"] = _gru_cell_init(g, d_h, d_h)
    return p


def _conv_init(g, k, d_in, d_out):
    # torch xavier on a conv weight [out, in, k]: fan_in = in*k,
    # fan_out = out*k (the _xavier_normal 3-D branch).
    return {"kernel": _xavier_normal(g, (k, d_in, d_out)),
            "bias": np.zeros((d_out,), np.float32)}


def _tree_numpy(tree: Mapping) -> Dict:
    return {k: _tree_numpy(v) if isinstance(v, Mapping) else np.asarray(v, np.float32)
            for k, v in tree.items()}


def init_comp_v6_params(
    generator: torch.Generator,
    cfg: CompV6TrainConfig = CompV6TrainConfig(),
    mov_enc: Optional[Mapping] = None,
    mov_dec: Optional[Mapping] = None,
) -> Dict:
    """Fresh CompV6 params in mdm_tpu's tree (t2m_generator layout, so the
    result feeds ``CompV6`` / ``T2MBaselineGenerator`` directly), drawn in
    a fixed order from ``generator`` (a CPU ``torch.Generator``).

    ``mov_enc``/``mov_dec`` accept pre-trained decomposition-stage params
    (the reference trains the movement autoencoder first and loads it here;
    see ``movement_params_from_flax`` for the decomp stage's output).
    """
    g = generator
    text_size = 2 * cfg.dim_text_hidden
    ml = cfg.dim_movement_latent
    th = cfg.dim_text_hidden
    gru = {}
    for s in ("f", "b"):  # torch nn.GRU default uniform (modules.py:274)
        gru.update({f"{n}_{s}": v for n, v in _gru_cell_init(g, th, th).items()})
    gru["hidden"] = _numpy(torch.randn((2, 1, th), generator=g))  # learned (modules.py:282)
    params = {
        "text_enc": {"pos_emb": _lin_init(g, cfg.dim_pos_ohot, cfg.dim_word),
                     "input_emb": _lin_init(g, cfg.dim_word, th), "gru": gru},
        "seq_post": _text_decoder_init(g, text_size, 2 * ml + cfg.dim_att_vec, cfg.dim_z,
                                       cfg.dim_pri_hidden, cfg.n_layers_pri),
        "seq_pri": _text_decoder_init(g, text_size, ml + cfg.dim_att_vec, cfg.dim_z,
                                      cfg.dim_pri_hidden, cfg.n_layers_pri),
        "seq_dec": _vae_decoder_init(g, text_size, ml + cfg.dim_att_vec + cfg.dim_z, ml,
                                     cfg.dim_dec_hidden, cfg.n_layers_dec),
        "att_layer": {"w_q": _lin_init(g, cfg.dim_dec_hidden, cfg.dim_att_vec),
                      "w_k": _lin_init(g, text_size, cfg.dim_att_vec, bias=False),
                      "w_v": _lin_init(g, text_size, cfg.dim_att_vec)},
    }
    if mov_enc is not None:
        params["mov_enc"] = _tree_numpy(mov_enc)
    else:
        params["mov_enc"] = {
            "conv1": _conv_init(g, 4, cfg.dim_pose - 4, cfg.dim_movement_hidden),
            "conv2": _conv_init(g, 4, cfg.dim_movement_hidden, ml),
            "out_net": _lin_init(g, ml, ml),
        }
    if mov_dec is not None:
        params["mov_dec"] = _tree_numpy(mov_dec)
    else:
        params["mov_dec"] = {
            "deconv1": _conv_init(g, 4, ml, cfg.dim_movement_hidden),
            "deconv2": _conv_init(g, 4, cfg.dim_movement_hidden, cfg.dim_pose),
            "out_net": _lin_init(g, cfg.dim_pose, cfg.dim_pose),
        }
    return params


def movement_params_from_flax(enc_params: Mapping, dec_params: Mapping):
    """The decomp stage's flax params (eval/networks.py
    MovementConvEncoder/Decoder, ``cli.train_evaluators --stage decomp``)
    -> the comp_v6 tree's ``mov_enc`` / ``mov_dec``.

    flax Conv kernels are [k, in, out], as the comp_v6 tree keeps them;
    flax ConvTranspose (``transpose_kernel=True``) stores [k, out, in],
    the tree [k, in, out]: the feature axes swap."""
    enc = {k: _tree_numpy(enc_params[k]) for k in ("conv1", "conv2", "out_net")}
    dec = _swap_deconvs({k: _tree_numpy(dec_params[k]) for k in ("deconv1", "deconv2", "out_net")})
    return enc, dec


# ---------------------------------------------------------------------------
# The tree on a device
# ---------------------------------------------------------------------------

def _param_tree(tree: Mapping, device) -> nn.Module:
    """A nested dict of arrays -> nested ``nn.ModuleDict``s whose leaves'
    dicts are ``nn.ParameterDict``s (t2m_generator's functions index both
    like dicts)."""
    if all(isinstance(v, Mapping) for v in tree.values()):
        return nn.ModuleDict({k: _param_tree(v, device) for k, v in tree.items()})
    return nn.ParameterDict({k: nn.Parameter(torch.as_tensor(np.array(v, np.float32)).to(device))
                             for k, v in tree.items()})


def _tree_of(module: nn.Module) -> Dict:
    if isinstance(module, nn.ParameterDict):
        return {k: v.detach().cpu().numpy().copy() for k, v in module.items()}
    return {k: _tree_of(v) for k, v in module.items()}


def comp_v6_modules(params: Mapping, device="cuda") -> nn.ModuleDict:
    """The comp_v6 tree on ``device`` for training: ``mov_enc`` frozen in
    eval mode, the six ``TRAINABLE`` networks in train mode."""
    mods = network_modules(params, device)
    out = nn.ModuleDict({**mods, **{k: _param_tree(params[k], device)
                                    for k in ("seq_post", "seq_pri", "seq_dec", "att_layer")}})
    out.train()
    out["mov_enc"].eval().requires_grad_(False)
    return out


def comp_v6_tree(params: nn.ModuleDict) -> Dict:
    """``comp_v6_modules``' networks -> mdm_tpu's comp_v6 tree (numpy)."""
    tree = {k: _tree_of(params[k]) for k in ("seq_post", "seq_pri", "seq_dec", "att_layer")}
    tree.update(mov_enc=flax_params(params["mov_enc"]), text_enc=flax_params(params["text_enc"]),
                mov_dec=_swap_deconvs(flax_params(params["mov_dec"])))
    return tree


# ---------------------------------------------------------------------------
# Forward + losses (CompTrainerV6.forward / backward_G)
# ---------------------------------------------------------------------------

def comp_v6_forward(
    params: Mapping,
    word_embs: torch.Tensor,    # [B, L, dim_word]
    pos_onehot: torch.Tensor,   # [B, L, dim_pos_ohot]
    cap_lens: torch.Tensor,     # [B]
    motions: torch.Tensor,      # [B, mov_len*unit, dim_pose] normalized
    m_lens: torch.Tensor,       # [B] true lengths (>= mov_len*unit)
    teacher_force: float,       # 0 or 1 (one draw per batch)
    eps_post: torch.Tensor,     # [mov_len, B, dim_z]
    eps_pri: torch.Tensor,      # [mov_len, B, dim_z]
    unit_length: int = 4,
    use_prior_z: bool = False,  # eval_mode (trainers.py:352-355)
):
    """One training forward (trainers.py:277-380) over ``comp_v6_modules``'
    networks. Returns (fake_motions, fake_movements, movements, mus/logvars
    stacked [mov_len, B, dim_z]).

    Attention parity quirk: the reference trains BATCHED, and its AttLayer
    has no padding mask: pad_packed_sequence truncates word_hids to
    max(cap_lens) and shorter samples' zero keys still win softmax weight
    e^0 (modules.py:246-261). The mask stops at the batch's longest
    caption, not at each sample's length as the inference path's does.
    """
    B, T, D = motions.shape
    device = motions.device
    mov_len = T // unit_length
    n_pri = sum(1 for k in params["seq_pri"] if k.startswith("gru_"))
    n_dec = sum(1 for k in params["seq_dec"] if k.startswith("gru_"))
    pe_pri = torch.as_tensor(positional_table(params["seq_pri"]["gru_0"]["w_hh"].shape[0]),
                             device=device)
    pe_dec = torch.as_tensor(positional_table(params["seq_dec"]["gru_0"]["w_hh"].shape[0]),
                             device=device)
    cap_lens, m_lens = cap_lens.to(device).long(), m_lens.to(device).long()

    # Movement targets and the first input, detached (trainers.py:291).
    with torch.no_grad():
        movements = params["mov_enc"](motions[..., :-4])
        zeros_unit = torch.zeros((B, unit_length, D - 4), dtype=motions.dtype, device=device)
        mov_in = params["mov_enc"](zeros_unit)[:, 0]

    word_hids, hidden = params["text_enc"](word_embs, pos_onehot, cap_lens)
    h_pos = init_hidden(params["seq_post"], hidden, n_pri)
    h_pri = init_hidden(params["seq_pri"], hidden, n_pri)
    h_dec = init_hidden(params["seq_dec"], hidden, n_dec)

    mov_units = m_lens // unit_length
    tf = float(teacher_force)
    batch_att_len = cap_lens.max().expand(B)
    fake_movs, mus_pos, lvs_pos, mus_pri, lvs_pri = [], [], [], [], []
    for i in range(mov_len):
        mov_tgt = movements[:, i]
        att_vec, _ = att_layer(params["att_layer"], h_dec[-1], word_hids, batch_att_len)
        tta = mov_units - i
        z_pos, mu_pos, lv_pos, h_pos = prior_step(
            params["seq_post"], pe_pri, torch.cat([mov_in, mov_tgt, att_vec], dim=-1), h_pos,
            tta, eps_post[i])
        z_pri, mu_pri, lv_pri, h_pri = prior_step(
            params["seq_pri"], pe_pri, torch.cat([mov_in, att_vec], dim=-1), h_pri, tta,
            eps_pri[i])
        z = z_pri if use_prior_z else z_pos
        fake_mov, h_dec = vae_decoder_step(
            params["seq_dec"], pe_dec, torch.cat([mov_in, att_vec, z], dim=-1), h_dec, tta)
        # Teacher forcing, both branches detached (trainers.py:365-368).
        mov_in = (tf * mov_tgt + (1.0 - tf) * fake_mov).detach()
        for acc, v in zip((fake_movs, mus_pos, lvs_pos, mus_pri, lvs_pri),
                          (fake_mov, mu_pos, lv_pos, mu_pri, lv_pri)):
            acc.append(v)

    fake_movements = torch.stack(fake_movs, dim=1)  # [B, mov_len, latent]
    # Training decode has no length masking (trainers.py:374): every sample
    # in a curriculum batch is exactly mov_len movements long.
    fake_motions = params["mov_dec"](fake_movements)
    stats = tuple(torch.stack(s, dim=0) for s in (mus_pos, lvs_pos, mus_pri, lvs_pri))
    return fake_motions, fake_movements, movements, stats


def smooth_l1(pred, target):
    """torch.nn.SmoothL1Loss default (beta=1, mean reduction)."""
    return F.smooth_l1_loss(pred, target, beta=1.0)


def kl_post_pri(mu1, lv1, mu2, lv2):
    """CompTrainerV6.kl_criterion (trainers.py:261-268): KL(post || pri)
    summed over z and divided by the number of rows (mov_len * B)."""
    kld = (0.5 * (lv2 - lv1)
           + (torch.exp(lv1) + (mu1 - mu2) ** 2) / (2.0 * torch.exp(lv2)) - 0.5)
    rows = mu1.shape[0] * mu1.shape[1]
    return torch.sum(kld) / rows


def comp_v6_losses(fake_motions, fake_movements, motions, movements, stats,
                   cfg: CompV6TrainConfig):
    """backward_G (trainers.py:452-460) incl. the swapped-lambda quirk."""
    mu_pos, lv_pos, mu_pri, lv_pri = stats
    loss_mot_rec = smooth_l1(fake_motions, motions)
    loss_mov_rec = smooth_l1(fake_movements, movements)
    loss_kld = kl_post_pri(mu_pos, lv_pos, mu_pri, lv_pri)
    loss_gen = (loss_mot_rec * cfg.lambda_rec_mov
                + loss_mov_rec * cfg.lambda_rec_mot
                + loss_kld * cfg.lambda_kld)
    return loss_gen, {"loss_gen": loss_gen, "loss_mot_rec": loss_mot_rec,
                      "loss_mov_rec": loss_mov_rec, "loss_kld": loss_kld}


# ---------------------------------------------------------------------------
# The train step
# ---------------------------------------------------------------------------

def _device_of(params: nn.Module) -> torch.device:
    return next(params.parameters()).device


def make_comp_v6_step(cfg: CompV6TrainConfig = CompV6TrainConfig()):
    """Returns (init_opt, step, val_step).

    ``init_opt(params)``: ``torch.optim.Adam`` (optax.adam's defaults) over
    the six ``TRAINABLE`` networks of ``comp_v6_modules``, ``mov_dec`` in a
    group of its own at ``lr * 0.1`` (trainers.py:607-614).

    ``step(params, opt, batch, generator, teacher_force, eps=None)`` ->
    (params, opt, logs): the reparameterisation noise ``eps = (eps_post,
    eps_pri)`` [mov_len, B, dim_z] each is drawn from ``generator`` (on the
    networks' device) unless given; the per-network clip at
    ``cfg.grad_clip`` before Adam; the logs stay on the device. batch =
    dict(word_embs, pos_onehot, cap_lens, motions, m_lens), moved to the
    networks' device.

    ``val_step(params, batch, eps=None)``: the losses at teacher forcing 0,
    the noise from a generator seeded 0 (mdm_tpu's fixed ``PRNGKey(0)``:
    the reference's validation forward samples too, trainers.py:705-711).
    """

    def init_opt(params: nn.ModuleDict) -> torch.optim.Adam:
        main = [p for k in TRAINABLE if k != "mov_dec" for p in params[k].parameters()]
        return torch.optim.Adam(
            [{"params": main, "lr": cfg.lr},
             {"params": list(params["mov_dec"].parameters()), "lr": cfg.lr * 0.1}],
            betas=(0.9, 0.999), eps=1e-8)

    def split_eps(generator, mov_len, B, device):
        shape = (mov_len, B, cfg.dim_z)
        return (torch.randn(shape, generator=generator, device=device),
                torch.randn(shape, generator=generator, device=device))

    def prepare(params, batch, generator, eps):
        device = _device_of(params)
        batch = {k: torch.as_tensor(v).to(device, non_blocking=True) for k, v in batch.items()}
        if eps is None:
            mov_len = batch["motions"].shape[1] // cfg.unit_length
            eps = split_eps(generator, mov_len, batch["motions"].shape[0], device)
        return batch, eps

    def loss_fn(params, batch, teacher_force, eps_post, eps_pri):
        fake_motions, fake_movements, movements, stats = comp_v6_forward(
            params, batch["word_embs"], batch["pos_onehot"], batch["cap_lens"],
            batch["motions"], batch["m_lens"], teacher_force, eps_post, eps_pri,
            cfg.unit_length)
        return comp_v6_losses(fake_motions, fake_movements, batch["motions"], movements,
                              stats, cfg)

    @f32_math()
    def step(params, opt, batch, generator=None, teacher_force=0.0, eps=None):
        batch, eps = prepare(params, batch, generator, eps)
        loss, logs = loss_fn(params, batch, teacher_force, *eps)
        opt.zero_grad(set_to_none=True)
        loss.backward()
        # clip_grad_norm_(net, 0.5) per network (trainers.py:251-254).
        _clip_per_network({k: params[k] for k in TRAINABLE}, cfg.grad_clip)
        opt.step()
        return params, opt, {k: v.detach() for k, v in logs.items()}

    @f32_math()
    @torch.no_grad()
    def val_step(params, batch, eps=None):
        device = _device_of(params)
        batch, eps = prepare(params, batch, torch.Generator(device).manual_seed(0), eps)
        _, logs = loss_fn(params, batch, 0.0, *eps)
        return logs

    return init_opt, step, val_step


# ---------------------------------------------------------------------------
# Curriculum runner (CompTrainerV6.train, trainers.py:604-746)
# ---------------------------------------------------------------------------

def train_comp_v6(
    params: nn.ModuleDict,
    make_batches: Callable[[int, str], Iterable[Dict]],
    cfg: CompV6TrainConfig = CompV6TrainConfig(),
    generator: Optional[torch.Generator] = None,
    rng: Optional[np.random.Generator] = None,
    log: Callable = print,
    on_length_done: Optional[Callable[[int, nn.ModuleDict], None]] = None,
) -> nn.ModuleDict:
    """Scheduled-length curriculum over ``comp_v6_modules``' networks: for
    each schedule_len from ``cfg.schedule_start`` to ``cfg.schedule_end``,
    run sub-epochs with early stopping on the validation loss (min tracked
    per length; stop after ``early_stop_count`` non-improvements or a 0.1
    regression, trainers.py:731-739). The noise comes from ``generator``
    (on the networks' device; seeded 0 when None), the teacher-forcing coin
    from the numpy ``rng``.

    ``make_batches(schedule_len, split)`` yields batch dicts whose motions
    are exactly ``schedule_len * unit_length`` frames (split is 'train' or
    'val').
    """
    if generator is None:
        generator = torch.Generator(_device_of(params)).manual_seed(0)
    if rng is None:
        rng = np.random.default_rng(0)
    init_opt, step, val_step = make_comp_v6_step(cfg)
    opt = init_opt(params)
    it = 0
    for schedule_len in range(cfg.schedule_start, cfg.schedule_end + 1):
        min_val = np.inf
        stop_cnt = 0
        for sub_epoch in range(cfg.max_sub_epoch):
            logs = None
            for batch in make_batches(schedule_len, "train"):
                tf = 1.0 if rng.random() < cfg.tf_ratio else 0.0
                params, opt, logs = step(params, opt, batch, generator, tf)
                it += 1
            if logs is None:  # no clip long enough for this length
                break
            val_losses = [val_step(params, b)["loss_gen"]
                          for b in make_batches(schedule_len, "val")]
            # Reference divides the sum by len(val_loader)+1 (trainers.py:
            # 716-719): the early-stop thresholds are absolute, so the
            # divisor is part of the protocol.
            val = (float(np.sum(torch.stack(val_losses).cpu().numpy().astype(np.float64)))
                   / (len(val_losses) + 1) if val_losses else float("nan"))
            log(f"sl={schedule_len} sub_epoch={sub_epoch} it={it} "
                f"train_loss={float(logs['loss_gen']):.5f} val={val:.5f}")
            if not np.isfinite(val):
                break
            if val < min_val:
                min_val = val
                stop_cnt = 0
            elif stop_cnt < cfg.early_stop_count:
                stop_cnt += 1
            else:
                break
            if val - min_val >= 0.1:
                break
        if on_length_done is not None:
            on_length_done(schedule_len, params)
    return params


def make_curriculum_batches(
    train_ds,
    val_ds,
    batch_size: int,
    cfg: CompV6TrainConfig = CompV6TrainConfig(),
    seed: int = 0,
    max_batches: int = 0,
) -> Callable[[int, str], Iterable[Dict]]:
    """Curriculum batch source over HumanMLDataset clips, mirroring the
    reference's ``Text2MotionDatasetBaseline`` (dataset.py:381-534), with
    mdm_tpu's numpy draws in mdm_tpu's order (the batches are equal):

    - a pointer over the length-sorted clips admits only clips with
      ``length >= schedule_len * unit_length`` (``reset_max_len``, :458-462);
    - the coin2 single/double crop picks a unit-aligned source length
      ``m_length >= max_length`` (:497-516); the model consumes the exact
      ``max_length``-frame ``tgt_motion`` crop while ``m_lens`` carries the
      source length (the trainer's tta countdown, trainers.py:330);
    - z-normalization with the dataset's (eval-stat) mean/std (:520-523);
    - batches sorted by cap_len descending (collate_fn, dataset.py:17-19).

    Batches are CPU tensors (the step moves them). ``max_batches`` (0 = no
    cap) bounds batches per (length, split) pass for smoke runs. Datasets
    may lack a ``w_vectorizer``; word features are then zeros (same
    degraded mode as the other CLI stages).
    """
    unit = cfg.unit_length
    rng = np.random.default_rng(seed)

    def one_item(ds, clip, max_len):
        opt = ds.opt
        entry = clip.texts[int(rng.integers(len(clip.texts)))]
        tokens = entry.tokens
        if len(tokens) < opt.max_text_len:
            tokens = ["sos/OTHER"] + tokens + ["eos/OTHER"]
            sent_len = len(tokens)
            tokens = tokens + ["unk/OTHER"] * (opt.max_text_len + 2 - sent_len)
        else:
            tokens = ["sos/OTHER"] + tokens[: opt.max_text_len] + ["eos/OTHER"]
            sent_len = len(tokens)
        if ds.w_vectorizer is not None:
            embs, pos = zip(*(ds.w_vectorizer[t] for t in tokens))
            word_embs = np.stack(embs).astype(np.float32)
            pos_oh = np.stack(pos).astype(np.float32)
        else:
            word_embs = np.zeros((len(tokens), cfg.dim_word), np.float32)
            pos_oh = np.zeros((len(tokens), cfg.dim_pos_ohot), np.float32)

        m_length = clip.length
        len_gap = (m_length - max_len) // unit
        coin2 = ("single" if unit >= 10
                 else ["single", "single", "double"][int(rng.integers(3))])
        if len_gap == 0 or (len_gap == 1 and coin2 == "double"):
            m_length = max_len
            s_idx = 0
        else:
            m_length = max_len + unit * (len_gap - (coin2 == "double"))
            s_idx = int(rng.integers(clip.length - m_length + 1))
        tgt = (clip.motion[s_idx: s_idx + max_len] - ds.mean) / ds.std
        return word_embs, pos_oh, sent_len, tgt.astype(np.float32), m_length

    def make_batches(schedule_len: int, split: str):
        ds = train_ds if split == "train" else val_ds
        max_len = schedule_len * unit
        lengths = np.asarray([c.length for c in ds.clips])
        ptr = int(np.searchsorted(lengths, max_len))
        idxs = np.arange(ptr, len(ds.clips))
        rng.shuffle(idxs)
        built = 0
        for start in range(0, len(idxs) - batch_size + 1, batch_size):
            items = [one_item(ds, ds.clips[i], max_len)
                     for i in idxs[start: start + batch_size]]
            items.sort(key=lambda it: it[2], reverse=True)
            yield {
                "word_embs": torch.from_numpy(np.stack([it[0] for it in items])),
                "pos_onehot": torch.from_numpy(np.stack([it[1] for it in items])),
                "cap_lens": torch.as_tensor([it[2] for it in items], dtype=torch.int64),
                "motions": torch.from_numpy(np.stack([it[3] for it in items])),
                "m_lens": torch.as_tensor([it[4] for it in items], dtype=torch.int64),
            }
            built += 1
            if max_batches and built >= max_batches:
                return

    return make_batches


def save_comp_v6_params(path: str, params: nn.ModuleDict) -> str:
    """Persist ``comp_v6_modules``' networks in mdm_tpu's comp_v6 npy
    layout (a pickled dict of numpy arrays): the port's ``load_comp_v6``
    reads it, and mdm_tpu's generator takes ``np.load(path).item()``."""
    np.save(path, comp_v6_tree(params))
    return path
