"""Frozen T2M evaluator networks in PyTorch, and the bridge to mdm_tpu's
flax layout.

Counterpart of mdm_tpu/eval/networks.py: the strided-conv movement encoder
and decoder and the bidirectional-GRU text/motion encoders with learned
initial hidden states (reference data_loaders/humanml/networks/
modules.py:79-438), plus the motion-length estimator. Parameter names are
the reference's, so its ``finest.tar`` state dicts load with
``load_state_dict``; ``load_flax_params`` / ``flax_params`` move weights
to and from mdm_tpu's flax layout (the ``finest.npy`` format of both
packages).

Variable-length handling, as in mdm_tpu: no ``pack_padded_sequence``, which
needs the lengths on the host (a sync per call on the card). The forward
GRU runs over the padded sequence and is read at ``len - 1``; the backward
GRU runs over each row's reversed *valid* prefix, gathered on the device.
Two unidirectional ``nn.GRU`` calls (cuDNN on the card) hold the two
directions; ``_BiGRUCore`` maps the reference's bidirectional names
(``weight_ih_l0``, ``weight_ih_l0_reverse``, ...) onto them when loading.
"""
from __future__ import annotations

import contextlib
import copy
from typing import Dict, List, Mapping, Optional, Tuple

import numpy as np
import torch
from torch import nn

# (flax path, tensor, layout): "T" a transposed 2-D kernel, "k" a conv kernel
# stored [k, ., .] in flax (torch [., ., k]), "k2" a 2-D conv kernel (flax
# [kh, kw, in, out], torch [out, in, kh, kw]), "" the same array.
Layout = List[Tuple[Tuple[str, ...], torch.Tensor, str]]


def _dense(path, lin: nn.Linear) -> Layout:
    return [(path + ("kernel",), lin.weight, "T"), (path + ("bias",), lin.bias, "")]


def _conv(path, conv: nn.Module) -> Layout:
    # Conv1d [out, in, k] <-> flax Conv [k, in, out]; ConvTranspose1d
    # [in, out, k] <-> flax ConvTranspose(transpose_kernel=True) [k, out, in]
    return [(path + ("kernel",), conv.weight, "k"), (path + ("bias",), conv.bias, "")]


def _ln(path, ln: nn.LayerNorm) -> Layout:
    return [(path + ("scale",), ln.weight, ""), (path + ("bias",), ln.bias, "")]


def _bigru(path, gru: "_BiGRUCore", hidden: nn.Parameter) -> Layout:
    out = [(path + ("hidden",), hidden, "")]
    for sfx, rnn in (("f", gru.f), ("b", gru.b)):
        out += [(path + (f"w_ih_{sfx}",), rnn.weight_ih_l0, "T"),
                (path + (f"w_hh_{sfx}",), rnn.weight_hh_l0, "T"),
                (path + (f"b_ih_{sfx}",), rnn.bias_ih_l0, ""),
                (path + (f"b_hh_{sfx}",), rnn.bias_hh_l0, "")]
    return out


def _to_torch_layout(a: np.ndarray, kind: str) -> np.ndarray:
    if kind == "T":
        return a.T
    if kind == "k":
        return np.transpose(a, (2, 1, 0))
    if kind == "k2":
        return np.transpose(a, (3, 2, 0, 1))
    return a


def _to_flax_layout(a: np.ndarray, kind: str) -> np.ndarray:
    return np.transpose(a, (2, 3, 1, 0)) if kind == "k2" else _to_torch_layout(a, kind)


def load_flax_params(module: nn.Module, params: Mapping) -> nn.Module:
    """Copy mdm_tpu's flax parameters (``{"params": {...}}`` or the inner
    dict) into ``module`` in place and return it."""
    tree = params.get("params", params)
    with torch.no_grad():
        for path, t, kind in module.flax_layout():
            node = tree
            for k in path:
                node = node[k]
            a = _to_torch_layout(np.asarray(node, np.float32), kind)
            if tuple(a.shape) != tuple(t.shape):
                raise ValueError(f"{'/'.join(path)}: flax shape {np.shape(node)} does not fit "
                                 f"{type(module).__name__}'s {tuple(t.shape)}")
            t.copy_(torch.from_numpy(np.array(a, np.float32)))
    return module


def flax_params(module: nn.Module) -> Dict:
    """``module``'s parameters in mdm_tpu's flax layout (nested dicts of
    float32 numpy arrays, without the outer ``"params"``)."""
    tree: Dict = {}
    for path, t, kind in module.flax_layout():
        node = tree
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = np.ascontiguousarray(_to_flax_layout(t.detach().float().cpu().numpy(),
                                                              kind))
    return tree


@contextlib.contextmanager
def f32_math():
    """Convolutions, GRUs and products in full float32 inside, whatever the
    process allows outside (cuDNN takes TF32 by default): the evaluators,
    their training and the T2M baseline compute what mdm_tpu's do only at
    f32. Also a decorator."""
    saved = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved


# The standard deviation of a unit normal truncated to [-2, 2] (flax's
# truncated-normal variance scaling divides by it).
_TRUNC_STD = 0.87962566103423978


def _lecun_normal_(w: torch.Tensor, fan_in: int):
    std = (1.0 / fan_in) ** 0.5 / _TRUNC_STD
    nn.init.trunc_normal_(w, std=std, a=-2 * std, b=2 * std)


def reset_seeded(module: nn.Module, seed: int) -> nn.Module:
    """Re-draw ``module``'s parameters from ``seed`` with mdm_tpu's
    initialisers (flax's defaults: lecun-normal kernels over the flax
    kernel's fan-in, zero biases, LayerNorm ones and zeros; the learned GRU
    states N(0, 1)), on the CPU, and copy them to the module's device; the
    global generator is restored. A module with parameters of its own kind
    sets them in its ``init_flax_()``."""
    fresh = copy.deepcopy(module).cpu()
    with torch.random.fork_rng(devices=[]), torch.no_grad():
        torch.manual_seed(seed)
        for m in fresh.modules():
            if isinstance(m, nn.Linear):
                _lecun_normal_(m.weight, m.in_features)
            elif isinstance(m, nn.Conv1d):
                _lecun_normal_(m.weight, m.in_channels * m.kernel_size[0])
            elif isinstance(m, nn.Conv2d):
                _lecun_normal_(m.weight, m.in_channels * m.kernel_size[0] * m.kernel_size[1])
            elif isinstance(m, nn.ConvTranspose1d):  # flax's kernel [k, out, in]
                _lecun_normal_(m.weight, m.out_channels * m.kernel_size[0])
            elif isinstance(m, nn.GRU):
                for k in range(m.num_layers):
                    _lecun_normal_(getattr(m, f"weight_ih_l{k}"),
                                   m.input_size if k == 0 else m.hidden_size)
                    _lecun_normal_(getattr(m, f"weight_hh_l{k}"), m.hidden_size)
            elif isinstance(m, nn.LayerNorm):
                m.weight.fill_(1.0)
            elif hasattr(m, "init_flax_"):
                m.init_flax_()
            for name, p in m.named_parameters(recurse=False):
                if name.startswith("bias"):
                    p.zero_()
                elif name == "hidden":
                    p.normal_()
    module.load_state_dict(fresh.state_dict())
    return module


class MovementConvEncoder(nn.Module):
    """[B, T, input_size] -> [B, T//4, output_size] (two stride-2 convs).
    ``main.1``/``main.4`` hold the reference's Dropout(0.2), which mdm_tpu's
    encoder leaves out; identities keep the reference's indices."""

    def __init__(self, input_size: int, hidden_size: int = 512, output_size: int = 512):
        super().__init__()
        self.main = nn.Sequential(
            nn.Conv1d(input_size, hidden_size, 4, 2, 1), nn.Identity(), nn.LeakyReLU(0.2),
            nn.Conv1d(hidden_size, output_size, 4, 2, 1), nn.Identity(), nn.LeakyReLU(0.2))
        self.out_net = nn.Linear(output_size, output_size)
        self.hidden_size, self.output_size = hidden_size, output_size

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.out_net(self.main(x.transpose(1, 2)).transpose(1, 2))

    def flax_layout(self) -> Layout:
        return (_conv(("conv1",), self.main[0]) + _conv(("conv2",), self.main[3])
                + _dense(("out_net",), self.out_net))


class MovementConvDecoder(nn.Module):
    """[B, T//4, input_size] -> [B, T, output_size] (two stride-2 transposed
    convs + linear head; reference modules.py:101-120). Trained by the
    decomposition stage of the evaluator-training pipeline."""

    def __init__(self, input_size: int, hidden_size: int = 512, output_size: int = 263):
        super().__init__()
        self.main = nn.Sequential(
            nn.ConvTranspose1d(input_size, hidden_size, 4, 2, 1), nn.LeakyReLU(0.2),
            nn.ConvTranspose1d(hidden_size, output_size, 4, 2, 1), nn.LeakyReLU(0.2))
        self.out_net = nn.Linear(output_size, output_size)
        self.output_size = output_size

    def forward(self, x: torch.Tensor, valid_len: Optional[torch.Tensor] = None) -> torch.Tensor:
        """With ``valid_len`` [B] (steps of ``x``), the activations past each
        row's length are zeroed before each layer, so a row's valid frames
        equal its run at its exact length (the T2M baseline's batches)."""
        h = x.transpose(1, 2)
        if valid_len is None:
            return self.out_net(self.main(h).transpose(1, 2))
        for i in (0, 2):
            t = torch.arange(h.shape[2], device=h.device)
            h = torch.where(t[None, None, :] < valid_len[:, None, None], h, 0.0)
            h = self.main[i + 1](self.main[i](h))
            valid_len = 2 * valid_len
        return self.out_net(h.transpose(1, 2))

    def flax_layout(self) -> Layout:
        return (_conv(("deconv1",), self.main[0]) + _conv(("deconv2",), self.main[2])
                + _dense(("out_net",), self.out_net))


# The reference's bidirectional nn.GRU names -> the two directions here.
_REFERENCE_GRU = {f"{w}_l0{r}": f"{d}.{w}_l0"
                  for w in ("weight_ih", "weight_hh", "bias_ih", "bias_hh")
                  for r, d in (("", "f"), ("_reverse", "b"))}


class _BiGRUCore(nn.Module):
    """Bidirectional GRU over padded [B, T, I]; returns [h_fw_last,
    h_bw_last] [B, 2H]. The learned initial state [2, 1, H] is the parent's
    ``hidden`` parameter (the reference keeps it there)."""

    def __init__(self, input_size: int, hidden_size: int):
        super().__init__()
        self.f = nn.GRU(input_size, hidden_size, batch_first=True)
        self.b = nn.GRU(input_size, hidden_size, batch_first=True)
        self.hidden_size = hidden_size

    def _load_from_state_dict(self, state_dict, prefix, *args, **kwargs):
        for ref, ours in _REFERENCE_GRU.items():
            if prefix + ref in state_dict:
                state_dict[prefix + ours] = state_dict.pop(prefix + ref)
        super()._load_from_state_dict(state_dict, prefix, *args, **kwargs)

    def directions(self, x: torch.Tensor, lengths: torch.Tensor, h0: torch.Tensor):
        """(hs_f, hs_b) [B, T, H]: the forward GRU over the padded sequence,
        the backward one over each row's reversed *valid* prefix (packing
        semantics); both hold a row's last state at ``lengths - 1``."""
        B, T, _ = x.shape
        H = self.hidden_size
        hs_f, _ = self.f(x, h0[0:1].expand(1, B, H).contiguous())
        t = torch.arange(T, device=x.device)
        rev = (lengths[:, None] - 1 - t[None, :]).clamp(0, T - 1)
        x_rev = torch.gather(x, 1, rev[..., None].expand(B, T, x.shape[-1]))
        hs_b, _ = self.b(x_rev, h0[1:2].expand(1, B, H).contiguous())
        return hs_f, hs_b

    def forward(self, x: torch.Tensor, lengths: torch.Tensor, h0: torch.Tensor) -> torch.Tensor:
        lengths = lengths.to(x.device, torch.long)
        hs_f, hs_b = self.directions(x, lengths, h0)
        rows, last = torch.arange(x.shape[0], device=x.device), lengths - 1
        return torch.cat([hs_f[rows, last], hs_b[rows, last]], dim=-1)


class OutputNet(nn.Sequential):
    """Linear -> LayerNorm -> LeakyReLU(0.2) -> Linear (the reference's
    ``output_net`` Sequential: indices 0, 1, 3)."""

    def __init__(self, input_size: int, hidden_size: int, output_size: int):
        super().__init__(nn.Linear(input_size, hidden_size), nn.LayerNorm(hidden_size, eps=1e-5),
                         nn.LeakyReLU(0.2), nn.Linear(hidden_size, output_size))

    def flax_layout_at(self, path) -> Layout:
        return (_dense(path + ("fc1",), self[0]) + _ln(path + ("ln",), self[1])
                + _dense(path + ("fc2",), self[3]))


class TextEncoderBiGRUCo(nn.Module):
    def __init__(self, word_size: int = 300, pos_size: int = 15, hidden_size: int = 512,
                 output_size: int = 512):
        super().__init__()
        self.pos_emb = nn.Linear(pos_size, word_size)
        self.input_emb = nn.Linear(word_size, hidden_size)
        self.gru = _BiGRUCore(hidden_size, hidden_size)
        self.output_net = OutputNet(2 * hidden_size, hidden_size, output_size)
        self.hidden = nn.Parameter(torch.randn(2, 1, hidden_size))

    def forward(self, word_embs, pos_onehot, cap_lens):
        inputs = self.input_emb(word_embs + self.pos_emb(pos_onehot))
        return self.output_net(self.gru(inputs, cap_lens, self.hidden))

    def flax_layout(self) -> Layout:
        return (_dense(("pos_emb",), self.pos_emb) + _dense(("input_emb",), self.input_emb)
                + _bigru(("gru",), self.gru, self.hidden)
                + self.output_net.flax_layout_at(("output_net",)))


class TextEncoderBiGRU(nn.Module):
    """The T2M baseline's text encoder (reference modules.py:267-310):
    per-token hiddens [B, T, 2H] (zero past ``cap_lens``; the backward half
    flipped as the reference leaves it, so position t holds the backward
    state after t + 1 steps) and the last state [B, 2H]."""

    def __init__(self, word_size: int = 300, pos_size: int = 15, hidden_size: int = 512):
        super().__init__()
        self.pos_emb = nn.Linear(pos_size, word_size)
        self.input_emb = nn.Linear(word_size, hidden_size)
        self.gru = _BiGRUCore(hidden_size, hidden_size)
        self.hidden = nn.Parameter(torch.randn(2, 1, hidden_size))

    def forward(self, word_embs, pos_onehot, cap_lens):
        inputs = self.input_emb(word_embs + self.pos_emb(pos_onehot))
        cap_lens = cap_lens.to(inputs.device, torch.long)
        hs = torch.cat(self.gru.directions(inputs, cap_lens, self.hidden), dim=-1)
        t = torch.arange(hs.shape[1], device=hs.device)
        word_hids = torch.where((t[None, :] < cap_lens[:, None])[..., None], hs, 0.0)
        return word_hids, hs[torch.arange(hs.shape[0], device=hs.device), cap_lens - 1]

    def flax_layout(self) -> Layout:
        return (_dense(("pos_emb",), self.pos_emb) + _dense(("input_emb",), self.input_emb)
                + _bigru(("gru",), self.gru, self.hidden))


class MotionEncoderBiGRUCo(nn.Module):
    def __init__(self, input_size: int = 512, hidden_size: int = 1024, output_size: int = 512):
        super().__init__()
        self.input_emb = nn.Linear(input_size, hidden_size)
        self.gru = _BiGRUCore(hidden_size, hidden_size)
        self.output_net = OutputNet(2 * hidden_size, hidden_size, output_size)
        self.hidden = nn.Parameter(torch.randn(2, 1, hidden_size))
        self.input_size = input_size

    def forward(self, inputs, m_lens):
        return self.output_net(self.gru(self.input_emb(inputs), m_lens, self.hidden))

    def flax_layout(self) -> Layout:
        return (_dense(("input_emb",), self.input_emb) + _bigru(("gru",), self.gru, self.hidden)
                + self.output_net.flax_layout_at(("output_net",)))


class MotionLenEstimatorBiGRU(nn.Module):
    """Sentence -> motion-length distribution (reference modules.py:389+).

    Used by the T2M pipeline to sample generation lengths from text.
    Output is logits over length buckets (units of unit_length frames)."""

    def __init__(self, word_size: int = 300, pos_size: int = 15, hidden_size: int = 512,
                 output_size: int = 50, nd: int = 512):
        super().__init__()
        self.pos_emb = nn.Linear(pos_size, word_size)
        self.input_emb = nn.Linear(word_size, hidden_size)
        self.gru = _BiGRUCore(hidden_size, hidden_size)
        self.output = nn.Sequential(
            nn.Linear(2 * hidden_size, nd), nn.LayerNorm(nd, eps=1e-5), nn.LeakyReLU(0.2),
            nn.Linear(nd, nd // 2), nn.LayerNorm(nd // 2, eps=1e-5), nn.LeakyReLU(0.2),
            nn.Linear(nd // 2, nd // 4), nn.LayerNorm(nd // 4, eps=1e-5), nn.LeakyReLU(0.2),
            nn.Linear(nd // 4, output_size))
        self.hidden = nn.Parameter(torch.randn(2, 1, hidden_size))

    def forward(self, word_embs, pos_onehot, cap_lens):
        inputs = self.input_emb(word_embs + self.pos_emb(pos_onehot))
        return self.output(self.gru(inputs, cap_lens, self.hidden))

    def flax_layout(self) -> Layout:
        o = self.output
        return (_dense(("pos_emb",), self.pos_emb) + _dense(("input_emb",), self.input_emb)
                + _bigru(("gru",), self.gru, self.hidden)
                + _dense(("fc1",), o[0]) + _ln(("ln1",), o[1])
                + _dense(("fc2",), o[3]) + _ln(("ln2",), o[4])
                + _dense(("fc3",), o[6]) + _ln(("ln3",), o[7]) + _dense(("out",), o[9]))
