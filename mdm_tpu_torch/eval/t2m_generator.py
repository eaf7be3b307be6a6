"""The original T2M (Guo et al. 2022) baseline generator, inference-only.

Counterpart of mdm_tpu/eval/t2m_generator.py: the ``CompV6`` VAE generator
the eval harness can score alongside MDM (reference
``data_loaders/humanml/networks/trainers.py:382-451`` ``CompTrainerV6.
generate``, built from ``modules.py:123-310`` and driven by
``motion_loaders/comp_v6_model_dataset.py:53-121``).

As in mdm_tpu, the whole generation runs over a fixed-shape batch: the
biGRU text encoding, the movement-by-movement attention / prior / decoder
recurrence (``mov_len`` steps for every sample, masked), and the
transposed-conv upsampler with the latents beyond each sample's length
zeroed before each layer, so the valid frames equal a per-sample
exact-length run. The movement encoder and decoder and the text biGRU are
eval/networks.py's modules; the prior and decoder GRU-cell stacks and the
attention are functions over mdm_tpu's parameter tree (flax layout:
kernels [in, out]), ``CompV6`` holds both on the generator's device.
Weights come from mdm_tpu's comp_v6 ``.npy`` tree or from the reference's
``.tar`` checkpoints (its module names: the three modules load their state
dicts, the rest is converted by ``convert_comp_v6``, into the same tree).
"""
from __future__ import annotations

from typing import Dict, Mapping, Optional

import numpy as np
import torch
import torch.nn.functional as F

from .networks import (
    MotionLenEstimatorBiGRU,
    MovementConvDecoder,
    MovementConvEncoder,
    TextEncoderBiGRU,
    f32_math,
    flax_params,
    load_flax_params,
)


def _leaky(x, slope=0.2):
    return F.leaky_relu(x, slope)


def tree_to_torch(tree, device, dtype=torch.float32):
    """A parameter tree of arrays -> the same tree of tensors on ``device``."""
    if isinstance(tree, Mapping):
        return {k: tree_to_torch(v, device, dtype) for k, v in tree.items()}
    return torch.as_tensor(np.asarray(tree)).to(device, dtype)


# ---------------------------------------------------------------------------
# Primitive cells
# ---------------------------------------------------------------------------

def gru_cell(p: Mapping, x: torch.Tensor, h: torch.Tensor) -> torch.Tensor:
    """torch.nn.GRUCell step (gate order r,z,n)."""
    gx = x @ p["w_ih"] + p["b_ih"]
    gh = h @ p["w_hh"] + p["b_hh"]
    xr, xz, xn = gx.chunk(3, dim=-1)
    hr, hz, hn = gh.chunk(3, dim=-1)
    r = torch.sigmoid(xr + hr)
    z = torch.sigmoid(xz + hz)
    n = torch.tanh(xn + r * hn)
    return (1 - z) * n + z * h


def _linear(p: Mapping, x: torch.Tensor) -> torch.Tensor:
    y = x @ p["kernel"]
    if "bias" in p:
        y = y + p["bias"]
    return y


def _layernorm(p: Mapping, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    return F.layer_norm(x, x.shape[-1:], p["scale"], p["bias"], eps)


def _emb_block(p: Mapping, x: torch.Tensor) -> torch.Tensor:
    """Linear -> LayerNorm -> LeakyReLU(0.2) (reference modules.py:130-133)."""
    return _leaky(_layernorm(p["ln"], _linear(p["fc"], x)))


def positional_table(d_model: int, max_len: int = 300) -> np.ndarray:
    """Sinusoidal table of reference modules.py:62-77 (PositionalEncoding)."""
    pe = np.zeros((max_len, d_model), np.float32)
    position = np.arange(max_len, dtype=np.float32)[:, None]
    div_term = np.exp(np.arange(0, d_model, 2, dtype=np.float32)
                      * (-np.log(10000.0) / d_model))
    pe[:, 0::2] = np.sin(position * div_term)
    pe[:, 1::2] = np.cos(position * div_term)
    return pe


# ---------------------------------------------------------------------------
# Sub-networks (reference modules.py)
# ---------------------------------------------------------------------------

def att_layer(p: Mapping, query, key_mat, valid_len=None):
    """AttLayer (modules.py:232-266): single-query attention over word hids,
    the softmax masked to t < cap_len (the reference's batch-1 runs see only
    the packed valid positions)."""
    dim = p["w_q"]["kernel"].shape[1]
    q = _linear(p["w_q"], query)            # [B, V]
    keys = _linear(p["w_k"], key_mat)       # [B, L, V]
    vals = _linear(p["w_v"], key_mat)       # [B, L, V]
    logits = torch.einsum("blv,bv->bl", keys, q) / float(np.sqrt(dim))
    if valid_len is not None:
        t = torch.arange(key_mat.shape[1], device=key_mat.device)[None, :]
        logits = logits.masked_fill(t >= valid_len[:, None], float("-inf"))
    w = torch.softmax(logits, dim=1)
    return torch.einsum("blv,bl->bv", vals, w), w


def init_hidden(p: Mapping, latent: torch.Tensor, n_layers: int) -> torch.Tensor:
    """z2init + split (modules.py:167-170, :211-216) -> [n_layers, B, H]."""
    return torch.stack(_linear(p["z2init"], latent).chunk(n_layers, dim=-1), dim=0)


def prior_step(p: Mapping, pe, inputs, hidden, tta, eps):
    """TextDecoder step (modules.py:218-230): GRUCell stack -> (z, mu, logvar).

    The reference feeds the SAME embedded input to every layer of this
    stack (modules.py:225-227), unlike TextVAEDecoder which chains them."""
    x = _emb_block(p["emb"], inputs) + pe[tta.clamp(0, pe.shape[0] - 1)]
    new_hidden = [gru_cell(p[f"gru_{i}"], x, hidden[i]) for i in range(hidden.shape[0])]
    h = new_hidden[-1]
    mu = _linear(p["mu_net"], h)
    logvar = _linear(p["logvar_net"], h)
    z = mu + torch.exp(0.5 * logvar) * eps
    return z, mu, logvar, torch.stack(new_hidden, dim=0)


def vae_decoder_step(p: Mapping, pe, inputs, hidden, tta):
    """TextVAEDecoder step (modules.py:172-186): GRUCell stack -> movement."""
    x = _emb_block(p["emb"], inputs) + pe[tta.clamp(0, pe.shape[0] - 1)]
    new_hidden = []
    for i in range(hidden.shape[0]):
        x = gru_cell(p[f"gru_{i}"], x, hidden[i])
        new_hidden.append(x)
    out = _leaky(_layernorm(p["out_ln"], _linear(p["out_fc1"], x)))
    return _linear(p["out_fc2"], out), torch.stack(new_hidden, dim=0)


# ---------------------------------------------------------------------------
# Full generator (CompTrainerV6.generate, trainers.py:382-451)
# ---------------------------------------------------------------------------

# Comp_v6_KLD01 hyperparameters (the published T2M baseline config).
DEFAULTS = dict(
    dim_word=300, dim_pos_ohot=15, dim_text_hidden=512, dim_att_vec=512,
    dim_z=128, dim_pri_hidden=1024, dim_dec_hidden=1024,
    dim_movement_latent=512, unit_length=4,
    n_layers_pri=1, n_layers_dec=1,
)


def _swap_deconvs(tree: Mapping) -> Dict:
    """mdm_tpu's comp_v6 tree keeps the movement decoder's transposed-conv
    kernels [k, in, out]; networks' bridge reads flax ConvTranspose
    (transpose_kernel=True)'s [k, out, in]. The swap is its own inverse."""
    return {k: dict(v, kernel=np.ascontiguousarray(np.swapaxes(np.asarray(v["kernel"]), 1, 2)))
            if k.startswith("deconv") else v for k, v in tree.items()}


def _kernel(tree: Mapping, name: str):
    return np.shape(tree[name]["kernel"])


class CompV6:
    """The generator's networks on ``device`` from a comp_v6 tree, sized
    from its shapes: the movement encoder and decoder and the text biGRU
    as eval/networks.py modules, the prior, the decoder and the attention
    as tensor trees."""

    def __init__(self, params: Mapping, device="cuda"):
        enc, dec, text = params["mov_enc"], params["mov_dec"], params["text_enc"]
        self.mov_enc = MovementConvEncoder(*_kernel(enc, "conv1")[1:], _kernel(enc, "conv2")[2])
        self.mov_dec = MovementConvDecoder(_kernel(dec, "deconv1")[1], *_kernel(dec, "deconv2")[1:])
        self.text_enc = TextEncoderBiGRU(*_kernel(text, "pos_emb")[::-1],
                                         _kernel(text, "input_emb")[1])
        for m, tree in ((self.mov_enc, enc), (self.mov_dec, _swap_deconvs(dec)),
                        (self.text_enc, text)):
            load_flax_params(m, tree).to(device).eval()
        self.seq_pri, self.seq_dec, self.att_layer = (
            tree_to_torch(params[k], device) for k in ("seq_pri", "seq_dec", "att_layer"))


@torch.inference_mode()
def t2m_generate(
    nets: CompV6,
    word_embs: torch.Tensor,    # [B, L, 300]
    pos_onehot: torch.Tensor,   # [B, L, 15]
    cap_lens: torch.Tensor,     # [B]
    m_lens: torch.Tensor,       # [B] frame counts (multiples of unit_length)
    mov_len: int,               # number of movement steps to run
    eps: Optional[torch.Tensor] = None,  # [mov_len, B, dim_z]; None = zeros
    unit_length: int = 4,
    dim_pose: int = 263,
):
    """Generate motions [B, mov_len*unit_length, dim_pose]; frames beyond
    each sample's m_len are zero. ``nets`` lie on the inputs' device."""
    B = word_embs.shape[0]
    device = word_embs.device
    n_pri = sum(1 for k in nets.seq_pri if k.startswith("gru_"))
    n_dec = sum(1 for k in nets.seq_dec if k.startswith("gru_"))
    dim_z = nets.seq_pri["mu_net"]["kernel"].shape[1]
    pe_pri = torch.as_tensor(positional_table(nets.seq_pri["gru_0"]["w_hh"].shape[0]),
                             device=device)
    pe_dec = torch.as_tensor(positional_table(nets.seq_dec["gru_0"]["w_hh"].shape[0]),
                             device=device)
    if eps is None:
        eps = torch.zeros((mov_len, B, dim_z), dtype=word_embs.dtype, device=device)
    cap_lens, m_lens = cap_lens.to(device).long(), m_lens.to(device).long()

    # Initial movement latent: the encoder applied to one unit of zeros
    # (trainers.py:390-394).
    zeros_unit = torch.zeros((B, unit_length, dim_pose - 4), dtype=word_embs.dtype, device=device)
    mov_in = nets.mov_enc(zeros_unit)[:, 0]

    word_hids, hidden = nets.text_enc(word_embs, pos_onehot, cap_lens)
    h_pri = init_hidden(nets.seq_pri, hidden, n_pri)
    h_dec = init_hidden(nets.seq_dec, hidden, n_dec)

    mov_units = m_lens // unit_length
    movements = []
    for i in range(mov_len):
        att_vec, _ = att_layer(nets.att_layer, h_dec[-1], word_hids, cap_lens)
        tta = mov_units - i
        z, _, _, h_pri = prior_step(nets.seq_pri, pe_pri,
                                    torch.cat([mov_in, att_vec], dim=-1), h_pri, tta, eps[i])
        mov_in, h_dec = vae_decoder_step(nets.seq_dec, pe_dec,
                                         torch.cat([mov_in, att_vec, z], dim=-1), h_dec, tta)
        movements.append(mov_in)
    motions = nets.mov_dec(torch.stack(movements, dim=1), mov_units)
    t = torch.arange(motions.shape[1], device=device)[None, :, None]
    return torch.where(t < m_lens[:, None, None], motions, 0.0)


# ---------------------------------------------------------------------------
# Torch checkpoint conversion (trainers.py:553-600 save/load format)
# ---------------------------------------------------------------------------

def _t(w):
    return np.ascontiguousarray(np.asarray(w, np.float32).T)


def _lin(sd, p, bias=True):
    out = {"kernel": _t(sd[f"{p}.weight"])}
    if bias:
        out["bias"] = np.asarray(sd[f"{p}.bias"], np.float32)
    return out


def _ln(sd, p):
    return {"scale": np.asarray(sd[f"{p}.weight"], np.float32),
            "bias": np.asarray(sd[f"{p}.bias"], np.float32)}


def _gru_cells(sd, prefix, n_layers):
    out = {}
    for i in range(n_layers):
        out[f"gru_{i}"] = {
            "w_ih": _t(sd[f"{prefix}.{i}.weight_ih"]),
            "w_hh": _t(sd[f"{prefix}.{i}.weight_hh"]),
            "b_ih": np.asarray(sd[f"{prefix}.{i}.bias_ih"], np.float32),
            "b_hh": np.asarray(sd[f"{prefix}.{i}.bias_hh"], np.float32),
        }
    return out


def convert_prior(sd: Mapping, n_layers: int = 1) -> Dict:
    return {
        "emb": {"fc": _lin(sd, "emb.0"), "ln": _ln(sd, "emb.1")},
        "z2init": _lin(sd, "z2init"),
        "mu_net": _lin(sd, "mu_net"),
        "logvar_net": _lin(sd, "logvar_net"),
        **_gru_cells(sd, "gru", n_layers),
    }


def convert_vae_decoder(sd: Mapping, n_layers: int = 1) -> Dict:
    return {
        "emb": {"fc": _lin(sd, "emb.0"), "ln": _ln(sd, "emb.1")},
        "z2init": _lin(sd, "z2init"),
        "out_fc1": _lin(sd, "output.0"),
        "out_ln": _ln(sd, "output.1"),
        "out_fc2": _lin(sd, "output.3"),
        **_gru_cells(sd, "gru", n_layers),
    }


def convert_att_layer(sd: Mapping) -> Dict:
    return {
        "w_q": _lin(sd, "W_q"),
        "w_k": _lin(sd, "W_k", bias=False),
        "w_v": _lin(sd, "W_v"),
    }


def _reference_modules(state: Mapping) -> Dict:
    """The movement encoder and decoder and the text biGRU of a
    CompTrainerV6 checkpoint, sized from its state dicts and loaded under
    the reference's names."""
    enc, dec, text = state["mov_enc"], state["mov_dec"], state["text_enc"]
    mods = {"mov_enc": MovementConvEncoder(enc["main.0.weight"].shape[1],
                                           enc["main.0.weight"].shape[0],
                                           enc["main.3.weight"].shape[0]),
            "mov_dec": MovementConvDecoder(*dec["main.0.weight"].shape[:2],
                                           dec["main.2.weight"].shape[1]),
            "text_enc": TextEncoderBiGRU(*text["pos_emb.weight"].shape,
                                         text["input_emb.weight"].shape[0])}
    for name, m in mods.items():
        m.load_state_dict({k: torch.as_tensor(np.asarray(v)) for k, v in state[name].items()})
    return mods


def convert_comp_v6(state: Mapping, n_layers_pri: int = 1, n_layers_dec: int = 1) -> Dict:
    """Convert a CompTrainerV6 checkpoint dict (trainers.py:553-579 keys)."""
    out = {name: flax_params(m) for name, m in _reference_modules(state).items()}
    out["mov_dec"] = _swap_deconvs(out["mov_dec"])
    out.update(seq_pri=convert_prior(state["seq_pri"], n_layers_pri),
               seq_dec=convert_vae_decoder(state["seq_dec"], n_layers_dec),
               att_layer=convert_att_layer(state["att_layer"]))
    # Training checkpoints carry the posterior too (trainers.py:560).
    if "seq_post" in state:
        out["seq_post"] = convert_prior(state["seq_post"], n_layers_pri)
    return out


def _is_npy(path: str) -> bool:
    return path.endswith(".npy")


def load_comp_v6(path: str) -> Dict:
    """A comp_v6 parameter tree: the reference's torch ``.tar`` checkpoint,
    converted, or mdm_tpu's ``.npy`` (``save_comp_v6_params``), as is."""
    if _is_npy(path):
        return np.load(path, allow_pickle=True).item()
    state = torch.load(path, map_location="cpu", weights_only=False)
    sds = {k: {kk: vv.numpy() for kk, vv in v.items()}
           for k, v in state.items() if isinstance(v, dict) and k in (
               "text_enc", "seq_pri", "seq_post", "seq_dec", "att_layer",
               "mov_enc", "mov_dec")}
    return convert_comp_v6(sds)


def load_len_estimator(path: str) -> Dict:
    """The length estimator's flax-layout params: from the reference's
    ``length_est_bigru/model/latest.tar`` (comp_v6_model_dataset.py:41-47;
    its state dict under the reference names) or from
    ``cli.train_evaluators --stage length``'s ``.npy``."""
    from .train_evaluators import load_evaluator_params

    if _is_npy(path):
        return {"params": load_evaluator_params(path)["estimator"]}
    sd = torch.load(path, map_location="cpu", weights_only=False)["estimator"]
    word_size, pos_size = sd["pos_emb.weight"].shape
    est = MotionLenEstimatorBiGRU(word_size, pos_size, sd["input_emb.weight"].shape[0],
                                  sd["output.9.weight"].shape[0], sd["output.0.weight"].shape[0])
    est.load_state_dict(sd)
    return {"params": flax_params(est)}


# ---------------------------------------------------------------------------
# Generated-dataset loaders (CompV6GeneratedDataset equivalent)
# ---------------------------------------------------------------------------

def sample_movement_lengths(probs: np.ndarray, rng, min_mov_length: int = 10):
    """Per-sample length draw with the reference's retry rule
    (comp_v6_model_dataset.py:90-96): up to 3 multinomial draws, accept the
    first >= min_mov_length, else keep the third regardless. Clamped to >= 1:
    a 0 draw would make the reference crash (torch.cat of zero movement
    chunks), it just never happens with the trained estimator."""
    out = []
    for p in probs:
        p = np.asarray(p, np.float64)
        p = p / p.sum()
        m = 0
        for _ in range(3):
            m = int(rng.choice(len(p), p=p))
            if m >= min_mov_length:
                break
        out.append(max(m, 1))
    return np.asarray(out, np.int32)


class T2MBaselineGenerator:
    """Holds the generator's networks (``CompV6``) and the length estimator
    on ``device``. Built ONCE; the per-replication loaders below share it."""

    def __init__(
        self,
        gen_params: Mapping,
        len_est_params,
        unit_length: int = 4,
        dim_pose: int = 263,
        max_motion_length: int = 196,
        min_mov_length: int = 10,  # 10 for t2m, 6 for kit
        len_est_kwargs: Optional[Dict] = None,  # override module dims
        device="cuda",
    ):
        self.device = torch.device(device)
        self.nets = CompV6(gen_params, self.device)
        self.unit_length = unit_length
        self.dim_pose = dim_pose
        self.min_mov_length = min_mov_length
        self.mov_len = max_motion_length // unit_length
        self.dim_z = self.nets.seq_pri["mu_net"]["kernel"].shape[1]
        if len_est_kwargs is None:  # sized from the weights
            p = len_est_params.get("params", len_est_params)
            pos_size, word_size = np.shape(p["pos_emb"]["kernel"])
            len_est_kwargs = dict(word_size=int(word_size), pos_size=int(pos_size),
                                  hidden_size=int(np.shape(p["input_emb"]["kernel"])[1]),
                                  output_size=int(np.shape(p["out"]["kernel"])[1]),
                                  nd=int(np.shape(p["fc1"]["kernel"])[1]))
        self.estimator = load_flax_params(MotionLenEstimatorBiGRU(**len_est_kwargs),
                                          len_est_params).to(self.device).eval()

    @f32_math()
    def gen_batch(self, batch, rng, generator: torch.Generator, repeats: int = 1):
        """Sample lengths from the estimator, then generate; returns
        [(x, m_lens)] * repeats, x on the device. The noise comes from
        ``generator`` (on the device), the lengths from the numpy ``rng``."""
        from .harness import _text_features

        # Same zero-GloVe fallback as the metric path: without a vectorizer
        # the whole eval is already stamped "comparable": false.
        wf, pf, sl, _ = _text_features(batch)
        w, p = (torch.as_tensor(np.asarray(a, np.float32)).to(self.device) for a in (wf, pf))
        cl = torch.as_tensor(np.asarray(sl, np.int64)).to(self.device)
        with torch.inference_mode():
            logits = self.estimator(w, p, cl).cpu().numpy()
        probs = np.exp(logits - logits.max(-1, keepdims=True))
        outs = []
        for _ in range(repeats):
            m_lens = sample_movement_lengths(probs, rng, self.min_mov_length) * self.unit_length
            eps = torch.randn((self.mov_len, w.shape[0], self.dim_z), generator=generator,
                              device=self.device)
            x = t2m_generate(self.nets, w, p, cl, torch.as_tensor(m_lens), self.mov_len,
                             eps=eps, unit_length=self.unit_length, dim_pose=self.dim_pose)
            outs.append((x, m_lens))
        return outs


class T2MBaselineLoader:
    """Runs the T2M baseline generator over eval prompts and yields
    harness-ready batches (the reference CompV6GeneratedDataset,
    comp_v6_model_dataset.py:53-147, batched instead of item-by-item).

    Motion lengths are drawn from the frozen length estimator's softmax;
    generated features are already in the evaluator-stats space (the T2M
    generator trains on the same normalization the evaluator uses, so the
    reference applies no renorm either).
    """

    def __init__(self, generator: T2MBaselineGenerator, gt_batches, seed: int = 0):
        self.generator = generator
        self.gt_batches = gt_batches
        self.seed = seed

    def __iter__(self):
        rng = np.random.default_rng(self.seed)
        gen = torch.Generator(self.generator.device).manual_seed(self.seed)
        for batch in self.gt_batches:
            x, m_lens = self.generator.gen_batch(batch, rng, gen, 1)[0]
            out = {"x": x, "lengths": m_lens}
            for k in ("word_embeddings", "pos_one_hots", "sent_lens"):
                if k in batch:
                    out[k] = batch[k]
            yield out


class T2MBaselineMMLoader(T2MBaselineLoader):
    """Multimodality variant: N repeats of the same prompt, each with its
    own sampled length and noise (comp_v6_model_dataset.py:86-116)."""

    def __init__(self, generator, gt_batches, seed: int = 0,
                 mm_num_samples: int = 10, mm_num_repeats: int = 10):
        super().__init__(generator, gt_batches, seed)
        self.mm_num_samples = mm_num_samples
        self.mm_num_repeats = mm_num_repeats

    def __iter__(self):
        rng = np.random.default_rng(self.seed + 7919)
        gen = torch.Generator(self.generator.device).manual_seed(self.seed + 7919)
        # MM prompts are drawn uniformly WITHOUT replacement over the whole
        # eval stream (reference comp_v6_model_dataset.py:64-65 mm_idxs =
        # np.random.choice over the full dataset), not one per head batch —
        # head-biased sampling would skew the MultiModality statistic.
        batches = list(self.gt_batches)
        sizes = [len(b["lengths"]) for b in batches]
        total = int(np.sum(sizes))
        n_mm = min(self.mm_num_samples, total)
        flat = np.sort(rng.choice(total, size=n_mm, replace=False))
        starts = np.cumsum([0] + sizes[:-1])
        for f in flat:
            b_i = int(np.searchsorted(starts, f, side="right")) - 1
            idx = int(f - starts[b_i])
            batch = batches[b_i]
            one = {
                k: batch[k][idx: idx + 1]
                for k in ("word_embeddings", "pos_one_hots", "sent_lens")
            }
            outs = self.generator.gen_batch(one, rng, gen, self.mm_num_repeats)
            yield {
                "x": torch.cat([x for x, _ in outs], dim=0),
                "lengths": np.concatenate([l for _, l in outs], axis=0),
            }
