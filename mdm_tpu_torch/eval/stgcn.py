"""ST-GCN action classifier (frozen batch norms, inference mode).

Counterpart of mdm_tpu/eval/stgcn.py (reference
eval/a2m/recognition/models/stgcn.py and its unconstrained twin): the
frozen feature/classifier network of the UESTC and unconstrained
protocols. The input is mdm_tpu's [N, T, V, C]; inside, the blocks run
NCHW ([N, C, T, V]) convolutions, and ``flax_layout`` transposes the
kernels to and from mdm_tpu's NHWC ones. The graph convolution is one
einsum over the K-partitioned adjacency.

The batch norms are frozen: y = (x - mean) / sqrt(var + eps) * g + b. As in
mdm_tpu, where they are flax *params*, their mean and variance are
``nn.Parameter``s, so the classifier trainer's Adam moves them as it moves
mdm_tpu's. Names are the reference's (``data_bn``, ``st_gcn_networks.{i}.
gcn.conv``, ``.tcn.{0,2,3}``, ``.residual.{0,1}``, ``edge_importance.{i}``,
``fcn``): ``convert_stgcn`` gives a reference state dict the shape this
module loads.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Mapping, Tuple

import numpy as np
import torch
from torch import nn

from .networks import Layout, _dense

# SMPL kinematic parents (public model constant) — replaces the reference's
# kintree pkl load for the 'smpl'/'smpl_noglobal' layouts.
SMPL_PARENTS = np.array(
    [-1, 0, 0, 0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 9, 9, 12, 13, 14, 16, 17, 18, 19, 20, 21]
)


def _get_edges(layout: str) -> Tuple[int, List[Tuple[int, int]], int]:
    # The reference carries two 'openpose' graphs: the classic 18-node
    # skeleton and the modified 15-node one of its unconstrained eval (the
    # "modi_struct" checkpoints); they are named apart here, as in mdm_tpu.
    if layout == "openpose":
        num_node = 18
        neighbor = [(4, 3), (3, 2), (7, 6), (6, 5), (13, 12), (12, 11), (10, 9),
                    (9, 8), (11, 5), (8, 2), (5, 1), (2, 1), (0, 1), (15, 0),
                    (14, 0), (17, 15), (16, 14)]
        center = 1
    elif layout == "openpose_modi15":
        num_node = 15
        neighbor = [(4, 3), (3, 2), (2, 1),
                    (7, 6), (6, 5), (5, 1),
                    (1, 0),
                    (14, 13), (13, 12), (12, 8),
                    (11, 10), (10, 9), (9, 8),
                    (8, 1)]
        center = 1
    elif layout == "smpl":
        num_node = 24
        neighbor = [(j, int(SMPL_PARENTS[j])) for j in range(1, 24)]
        center = 0
    elif layout == "smpl_noglobal":
        num_node = 23
        neighbor = [
            (j - 1, int(SMPL_PARENTS[j]) - 1)
            for j in range(1, 24)
            if j != 0 and SMPL_PARENTS[j] != 0
        ]
        center = 0
    else:
        raise NotImplementedError(layout)
    edges = [(i, i) for i in range(num_node)] + neighbor
    return num_node, edges, center


def _hop_distance(num_node, edges, max_hop=1):
    A = np.zeros((num_node, num_node))
    for i, j in edges:
        A[j, i] = 1
        A[i, j] = 1
    hop_dis = np.full((num_node, num_node), np.inf)
    transfer = [np.linalg.matrix_power(A, d) for d in range(max_hop + 1)]
    arrive = np.stack(transfer) > 0
    for d in range(max_hop, -1, -1):
        hop_dis[arrive[d]] = d
    return hop_dis


def _normalize_digraph(A):
    Dl = A.sum(0)
    Dn = np.zeros_like(A)
    for i in range(A.shape[0]):
        if Dl[i] > 0:
            Dn[i, i] = Dl[i] ** -1
    return A @ Dn


def build_graph_adjacency(
    layout: str = "smpl", strategy: str = "spatial", max_hop: int = 1, dilation: int = 1
) -> np.ndarray:
    """Partitioned adjacency [K, V, V] (reference stgcnutils/graph.py)."""
    num_node, edges, center = _get_edges(layout)
    hop_dis = _hop_distance(num_node, edges, max_hop)
    valid_hop = range(0, max_hop + 1, dilation)
    adjacency = np.zeros((num_node, num_node))
    for hop in valid_hop:
        adjacency[hop_dis == hop] = 1
    norm_adj = _normalize_digraph(adjacency)

    if strategy == "uniform":
        return norm_adj[None]
    if strategy == "distance":
        A = np.zeros((len(list(valid_hop)), num_node, num_node))
        for i, hop in enumerate(valid_hop):
            A[i][hop_dis == hop] = norm_adj[hop_dis == hop]
        return A
    if strategy == "spatial":
        A = []
        for hop in valid_hop:
            a_root = np.zeros((num_node, num_node))
            a_close = np.zeros((num_node, num_node))
            a_further = np.zeros((num_node, num_node))
            for i in range(num_node):
                for j in range(num_node):
                    if hop_dis[j, i] == hop:
                        if hop_dis[j, center] == hop_dis[i, center]:
                            a_root[j, i] = norm_adj[j, i]
                        elif hop_dis[j, center] > hop_dis[i, center]:
                            a_close[j, i] = norm_adj[j, i]
                        else:
                            a_further[j, i] = norm_adj[j, i]
            if hop == 0:
                A.append(a_root)
            else:
                A.append(a_root + a_close)
                A.append(a_further)
        return np.stack(A)
    raise NotImplementedError(strategy)


class FrozenBN(nn.Module):
    """Inference-mode batch norm over dimension ``dim``, every statistic a
    parameter: y = (x - running_mean) * rsqrt(running_var + eps) * weight + bias."""

    def __init__(self, features: int, dim: int = 1, eps: float = 1e-5):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.running_mean = nn.Parameter(torch.zeros(features))
        self.running_var = nn.Parameter(torch.ones(features))
        self.dim, self.eps = dim, eps

    def init_flax_(self):
        """flax's initialisers for mdm_tpu's _FrozenBN (networks.reset_seeded)."""
        for p, v in ((self.weight, 1.0), (self.bias, 0.0), (self.running_mean, 0.0),
                     (self.running_var, 1.0)):
            p.fill_(v)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        shape = [1] * x.ndim
        shape[self.dim] = -1
        v = lambda p: p.view(shape)  # noqa: E731
        return (x - v(self.running_mean)) * torch.rsqrt(v(self.running_var) + self.eps) \
            * v(self.weight) + v(self.bias)

    def flax_layout_at(self, path) -> Layout:
        return [(path + ("scale",), self.weight, ""), (path + ("bias",), self.bias, ""),
                (path + ("mean",), self.running_mean, ""), (path + ("var",), self.running_var, "")]


def _conv2d(path, conv: nn.Conv2d) -> Layout:
    return [(path + ("kernel",), conv.weight, "k2"), (path + ("bias",), conv.bias, "")]


class _GraphConv(nn.Module):
    """1x1 conv to K x C_out channels (the reference's ConvTemporalGraphical)."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int):
        super().__init__()
        self.conv = nn.Conv2d(in_channels, out_channels * kernel_size, 1)


class STGCNBlock(nn.Module):
    """[N, C_in, T, V] -> [N, C_out, T / stride, V]: graph conv, then BN ->
    ReLU -> temporal (k x 1) conv -> BN, plus the residual, ReLU."""

    def __init__(self, in_channels: int, out_channels: int, spatial_kernel: int,
                 temporal_kernel: int = 9, stride: int = 1, residual: bool = True):
        super().__init__()
        pad = (temporal_kernel - 1) // 2
        self.gcn = _GraphConv(in_channels, out_channels, spatial_kernel)
        self.tcn = nn.Sequential(
            FrozenBN(out_channels), nn.ReLU(),
            nn.Conv2d(out_channels, out_channels, (temporal_kernel, 1), (stride, 1), (pad, 0)),
            FrozenBN(out_channels))
        if not residual:
            self.res_mode = "none"
        elif in_channels == out_channels and stride == 1:
            self.res_mode = "identity"
        else:
            self.res_mode = "conv"
            self.residual = nn.Sequential(
                nn.Conv2d(in_channels, out_channels, 1, (stride, 1)), FrozenBN(out_channels))
        self.K = spatial_kernel

    def forward(self, x: torch.Tensor, A: torch.Tensor) -> torch.Tensor:
        res = (self.residual(x) if self.res_mode == "conv"
               else x if self.res_mode == "identity" else 0.0)
        h = self.gcn.conv(x)  # [N, K*C, T, V]
        N, KC, T, V = h.shape
        h = torch.einsum("nkctv,kvw->nctw", h.view(N, self.K, KC // self.K, T, V), A)
        return torch.relu(self.tcn(h) + res)

    def flax_layout_at(self, path) -> Layout:
        out = (_conv2d(path + ("gcn_conv",), self.gcn.conv)
               + self.tcn[0].flax_layout_at(path + ("tcn_bn1",))
               + _conv2d(path + ("tcn_conv",), self.tcn[2])
               + self.tcn[3].flax_layout_at(path + ("tcn_bn2",)))
        if self.res_mode == "conv":
            out += (_conv2d(path + ("res_conv",), self.residual[0])
                    + self.residual[1].flax_layout_at(path + ("res_bn",)))
        return out


@dataclass(frozen=True)
class STGCNConfig:
    in_channels: int = 6
    num_class: int = 40
    layout: str = "smpl"
    strategy: str = "spatial"
    edge_importance: bool = True
    channels: Tuple[Tuple[int, int], ...] = (
        (64, 1), (64, 1), (64, 1), (64, 1), (128, 2),
        (128, 1), (128, 1), (256, 2), (256, 1), (256, 1),
    )


class STGCN(nn.Module):
    """x [N, T, V, C] -> dict(features [N, 256], yhat [N, num_class])."""

    def __init__(self, config: STGCNConfig = STGCNConfig()):
        super().__init__()
        self.config = cfg = config
        A = torch.tensor(build_graph_adjacency(cfg.layout, cfg.strategy), dtype=torch.float32)
        self.register_buffer("A", A, persistent=False)
        K, V, _ = A.shape
        # data_bn over V*C features: the reference flattens [N, M, V, C, T]
        # to (N*M, V*C, T), V-major, as the [N, T, V*C] reshape here.
        self.data_bn = FrozenBN(V * cfg.in_channels, dim=-1)
        blocks, c_in = [], cfg.in_channels
        for i, (c_out, stride) in enumerate(cfg.channels):
            blocks.append(STGCNBlock(c_in, c_out, K, stride=stride, residual=i != 0))
            c_in = c_out
        self.st_gcn_networks = nn.ModuleList(blocks)
        if cfg.edge_importance:
            self.edge_importance = nn.ParameterList(
                [nn.Parameter(torch.ones(K, V, V)) for _ in cfg.channels])
        self.fcn = nn.Linear(c_in, cfg.num_class)

    def init_flax_(self):
        if self.config.edge_importance:
            for p in self.edge_importance:
                p.fill_(1.0)

    def forward(self, x: torch.Tensor) -> Dict[str, torch.Tensor]:
        N, T, V, C = x.shape
        h = self.data_bn(x.reshape(N, T, V * C)).reshape(N, T, V, C).permute(0, 3, 1, 2)
        for i, block in enumerate(self.st_gcn_networks):
            A = self.A * self.edge_importance[i] if self.config.edge_importance else self.A
            h = block(h, A)
        feat = h.mean(dim=(2, 3))  # global average pool -> [N, 256]
        return {"features": feat, "yhat": self.fcn(feat)}

    def flax_layout(self) -> Layout:
        out = self.data_bn.flax_layout_at(("data_bn",))
        for i, block in enumerate(self.st_gcn_networks):
            out += block.flax_layout_at((f"st_gcn_{i}",))
            if self.config.edge_importance:
                out.append(((f"edge_importance_{i}",), self.edge_importance[i], ""))
        return out + _dense(("fcn",), self.fcn)


def convert_stgcn(sd: Mapping, config: STGCNConfig) -> Dict[str, torch.Tensor]:
    """The reference STGCN's state dict -> the state dict this module loads:
    its 1x1 ``fcn`` conv as the linear layer, the graph buffer ``A`` and the
    batch norms' ``num_batches_tracked`` left out."""
    out = {}
    for k, v in sd.items():
        if k == "A" or k.endswith("num_batches_tracked"):
            continue
        v = np.asarray(v, np.float32)
        out[k] = torch.as_tensor(v[..., 0, 0] if k == "fcn.weight" else v)
    if not config.edge_importance:
        out = {k: v for k, v in out.items() if not k.startswith("edge_importance")}
    return out
