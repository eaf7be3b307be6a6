"""Differentiable SMPL linear blend skinning in PyTorch.

Counterpart of mdm_tpu/smpl/lbs.py (reference model/smpl.py:64-97, the
smplx dependency): shape blend shapes, pose blend shapes, the kinematic
chain's rigid transforms and LBS skinning, differentiable end to end so the
rcxyz / velocity / foot-contact losses run inside the train step.

The model loads from the standard ``SMPL_NEUTRAL.pkl`` (the same asset
contract as the reference and mdm_tpu) and the SPIN ``J_regressor_extra.npy``.

Only what the asked outputs need is computed. Under ``jax.jit`` XLA drops
the skinning when only the ``smpl`` joints are read; eager PyTorch would
compute it all: the pose blend shapes ``[N, 207] @ [207, 6890 * 3]``, the
blended per-vertex transforms and the vertices. The ``smpl`` joints depend
only on the rest joints and the kinematic chain, so ``lbs(...,
outputs=("smpl",))`` returns them without any vertex tensor; vertices and
the mesh keypoints are computed for ``vertices``, ``joints``, ``a2m``,
``a2mpl`` and ``vibe`` only. The rest joints come from the regressor
applied to the template and the shape directions once per model, device
and dtype (``J v_template + (J shapedirs) betas``, the same sum as
``J (v_template + shapedirs betas)`` in another order).

Torch raises on a gather out of range where JAX clamps: a model smaller
than SMPL that asks for the mesh keypoints brings its own
``extra_vertex_ids``.
"""
from __future__ import annotations

import os
import pickle
from dataclasses import dataclass, field
from typing import Dict, Iterable, Optional

import numpy as np
import torch

# Extra keypoints picked directly from the mesh (smplx VertexJointSelector
# constants for the SMPL topology): 5 face + 6 feet + 10 fingertips.
EXTRA_VERTEX_IDS = np.array(
    [
        332, 6260, 2800, 4071, 583,  # nose, reye, leye, rear, lear
        3216, 3226, 3387, 6617, 6624, 6787,  # L/R big toe, small toe, heel
        2746, 2319, 2445, 2556, 2673,  # left finger tips (thumb..pinky)
        6191, 5782, 5905, 6016, 6133,  # right finger tips
    ],
    dtype=np.int32,
)

# Joint-set index maps (reference model/smpl.py:11-60).
ACTION2MOTION_JOINTS = np.array(
    [8, 1, 2, 3, 4, 5, 6, 7, 0, 9, 10, 11, 12, 13, 14, 21, 24, 38], dtype=np.int32
)
JOINT_MAP = {
    "OP Nose": 24, "OP Neck": 12, "OP RShoulder": 17, "OP RElbow": 19,
    "OP RWrist": 21, "OP LShoulder": 16, "OP LElbow": 18, "OP LWrist": 20,
    "OP MidHip": 0, "OP RHip": 2, "OP RKnee": 5, "OP RAnkle": 8,
    "OP LHip": 1, "OP LKnee": 4, "OP LAnkle": 7, "OP REye": 25,
    "OP LEye": 26, "OP REar": 27, "OP LEar": 28, "OP LBigToe": 29,
    "OP LSmallToe": 30, "OP LHeel": 31, "OP RBigToe": 32, "OP RSmallToe": 33,
    "OP RHeel": 34, "Right Ankle": 8, "Right Knee": 5, "Right Hip": 45,
    "Left Hip": 46, "Left Knee": 4, "Left Ankle": 7, "Right Wrist": 21,
    "Right Elbow": 19, "Right Shoulder": 17, "Left Shoulder": 16,
    "Left Elbow": 18, "Left Wrist": 20, "Neck (LSP)": 47,
    "Top of Head (LSP)": 48, "Pelvis (MPII)": 49, "Thorax (MPII)": 50,
    "Spine (H36M)": 51, "Jaw (H36M)": 52, "Head (H36M)": 53, "Nose": 24,
    "Left Eye": 26, "Right Eye": 25, "Left Ear": 28, "Right Ear": 27,
}
JOINT_NAMES = [
    "OP Nose", "OP Neck", "OP RShoulder", "OP RElbow", "OP RWrist",
    "OP LShoulder", "OP LElbow", "OP LWrist", "OP MidHip", "OP RHip",
    "OP RKnee", "OP RAnkle", "OP LHip", "OP LKnee", "OP LAnkle", "OP REye",
    "OP LEye", "OP REar", "OP LEar", "OP LBigToe", "OP LSmallToe", "OP LHeel",
    "OP RBigToe", "OP RSmallToe", "OP RHeel", "Right Ankle", "Right Knee",
    "Right Hip", "Left Hip", "Left Knee", "Left Ankle", "Right Wrist",
    "Right Elbow", "Right Shoulder", "Left Shoulder", "Left Elbow",
    "Left Wrist", "Neck (LSP)", "Top of Head (LSP)", "Pelvis (MPII)",
    "Thorax (MPII)", "Spine (H36M)", "Jaw (H36M)", "Head (H36M)", "Nose",
    "Left Eye", "Right Eye", "Left Ear", "Right Ear",
]
JOINTSTYPE_ROOT = {"a2m": 0, "smpl": 0, "a2mpl": 0, "vibe": 8}

VIBE_INDEXES = np.array([JOINT_MAP[n] for n in JOINT_NAMES], dtype=np.int32)
A2M_INDEXES = VIBE_INDEXES[ACTION2MOTION_JOINTS]
SMPL_INDEXES = np.arange(24, dtype=np.int32)
A2MPL_INDEXES = np.unique(np.r_[SMPL_INDEXES, A2M_INDEXES]).astype(np.int32)
JOINT_SET_INDEXES: Dict[str, np.ndarray] = {
    "vibe": VIBE_INDEXES, "a2m": A2M_INDEXES, "smpl": SMPL_INDEXES,
    "a2mpl": A2MPL_INDEXES,
}
OUTPUTS = ("vertices", "joints", *JOINT_SET_INDEXES)


def _root_to_minus1(parents: np.ndarray) -> np.ndarray:
    parents = parents.copy()
    parents[0] = -1
    return parents


@dataclass(frozen=True)
class SMPLModel:
    """Static SMPL model arrays (host numpy); ``tensors`` holds their copies
    on a device."""

    v_template: np.ndarray  # [V, 3]
    shapedirs: np.ndarray  # [V, 3, n_betas]
    posedirs: np.ndarray  # [(J-1)*9, V*3]
    j_regressor: np.ndarray  # [J, V]
    parents: np.ndarray  # [J]
    lbs_weights: np.ndarray  # [V, J]
    faces: Optional[np.ndarray] = None  # [F, 3]
    j_regressor_extra: Optional[np.ndarray] = None  # [9, V]
    extra_vertex_ids: Optional[np.ndarray] = None  # defaults to EXTRA_VERTEX_IDS
    _tensors: Dict = field(default_factory=dict, init=False, repr=False, compare=False)

    @property
    def num_joints(self) -> int:
        return self.j_regressor.shape[0]

    @property
    def num_betas(self) -> int:
        return self.shapedirs.shape[-1]

    @classmethod
    def load(
        cls,
        model_path: str = "body_models/smpl/SMPL_NEUTRAL.pkl",
        extra_regressor_path: Optional[str] = "body_models/smpl/J_regressor_extra.npy",
        num_betas: int = 10,
    ) -> "SMPLModel":
        """The pickle as mdm_tpu reads it (mdm_tpu/smpl/lbs.py:110-146);
        a missing file raises FileNotFoundError."""
        with open(model_path, "rb") as f:
            data = pickle.load(f, encoding="latin1")

        def dense(x):
            if hasattr(x, "toarray"):
                x = x.toarray()
            return np.asarray(x, dtype=np.float64)

        extra = None
        if extra_regressor_path and os.path.exists(extra_regressor_path):
            extra = np.asarray(np.load(extra_regressor_path), dtype=np.float32)

        posedirs = dense(data["posedirs"])  # [V, 3, 207]
        V = posedirs.shape[0]
        posedirs = posedirs.reshape(V * 3, -1).T  # [207, V*3]

        return cls(
            v_template=dense(data["v_template"]).astype(np.float32),
            shapedirs=dense(data["shapedirs"])[..., :num_betas].astype(np.float32),
            posedirs=posedirs.astype(np.float32),
            j_regressor=dense(data["J_regressor"]).astype(np.float32),
            # kintree_table is uint32 with 2**32-1 as the root sentinel: the
            # root is set to -1 explicitly (smplx convention).
            parents=_root_to_minus1(np.asarray(data["kintree_table"][0], np.int64))
            if "kintree_table" in data
            else np.asarray(data["parents"], dtype=np.int64),
            lbs_weights=dense(data["weights"]).astype(np.float32),
            faces=np.asarray(data.get("f"), dtype=np.int32) if "f" in data else None,
            j_regressor_extra=extra,
        )

    def tensors(self, device, dtype) -> Dict[str, torch.Tensor]:
        """The model's arrays as ``dtype`` tensors on ``device``, made once
        per (device, dtype): the skinning arrays, and the regressor applied
        to the template (``j_template`` [J, 3]) and to the shape directions
        (``j_shapedirs`` [J, 3, n_betas]), in float64 before the cast."""
        key = (str(torch.device(device)), dtype)
        if key not in self._tensors:
            jr = self.j_regressor.astype(np.float64)
            arrays = {
                "v_template": self.v_template, "shapedirs": self.shapedirs,
                "posedirs": self.posedirs, "lbs_weights": self.lbs_weights,
                "j_template": jr @ self.v_template.astype(np.float64),
                "j_shapedirs": np.einsum("jv,vkl->jkl", jr, self.shapedirs.astype(np.float64)),
            }
            if self.j_regressor_extra is not None:
                arrays["j_regressor_extra"] = self.j_regressor_extra
            ids = EXTRA_VERTEX_IDS if self.extra_vertex_ids is None else self.extra_vertex_ids
            out = {k: torch.as_tensor(np.asarray(v)).to(device=device, dtype=dtype)
                   for k, v in arrays.items()}
            out["extra_vertex_ids"] = torch.as_tensor(np.asarray(ids, np.int64), device=device)
            self._tensors[key] = out
        return self._tensors[key]


def _rigid_transforms(rot_mats: torch.Tensor, joints: torch.Tensor, parents: np.ndarray):
    """Global joint transforms of the kinematic chain: rot_mats [B, J, 3, 3],
    rest joints [B, J, 3] -> (posed joints [B, J, 3], transforms [B, J, 4,
    4]). The chain is a Python loop of J - 1 batched 4x4 products."""
    J = joints.shape[1]
    parents = [int(p) for p in parents]
    rel_joints = torch.cat([joints[:, :1], joints[:, 1:] - joints[:, parents[1:]]], dim=1)
    top = torch.cat([rot_mats, rel_joints[..., None]], dim=-1)  # [B, J, 3, 4]
    # The bottom row [0, 0, 0, 1] made on the device: a tensor built from a
    # host list would be a blocking copy, a host sync in every step.
    tfs = torch.nn.functional.pad(top, (0, 0, 0, 1))  # [B, J, 4, 4]
    tfs[..., 3, 3] = 1.0
    chain = [tfs[:, 0]]
    for j in range(1, J):
        chain.append(chain[parents[j]] @ tfs[:, j])
    transforms = torch.stack(chain, dim=1)
    return transforms[..., :3, 3], transforms


def _skin(m: Dict[str, torch.Tensor], betas: torch.Tensor, rot_mats: torch.Tensor,
          joints_rest: torch.Tensor, transforms: torch.Tensor) -> torch.Tensor:
    """Vertices [B, V, 3]: shape and pose blend shapes, then each vertex
    moved by its weighted sum of the joints' transforms relative to the rest
    pose (only their top three rows, [B, V, 3, 4])."""
    B = betas.shape[0]
    v_shaped = m["v_template"][None] + torch.einsum("bl,vkl->bvk", betas, m["shapedirs"])
    ident = torch.eye(3, dtype=betas.dtype, device=betas.device)
    pose_feature = (rot_mats[:, 1:] - ident).reshape(B, -1)  # [B, (J-1)*9]
    v_posed = v_shaped + (pose_feature @ m["posedirs"]).reshape(B, -1, 3)
    R = transforms[..., :3, :3]
    t = transforms[..., :3, 3] - torch.einsum("bjik,bjk->bji", R, joints_rest)
    rel = torch.cat([R, t[..., None]], dim=-1)  # [B, J, 3, 4]
    T = torch.einsum("vj,bjik->bvik", m["lbs_weights"], rel)  # [B, V, 3, 4]
    return torch.einsum("bvik,bvk->bvi", T[..., :3], v_posed) + T[..., 3]


def lbs(
    model: SMPLModel,
    betas: torch.Tensor,  # [B, n_betas]
    global_orient: torch.Tensor,  # [B, 3, 3]
    body_pose: torch.Tensor,  # [B, J-1, 3, 3]
    transl: Optional[torch.Tensor] = None,  # [B, 3]
    outputs: Optional[Iterable[str]] = None,
) -> Dict[str, torch.Tensor]:
    """SMPL forward in ``betas``' dtype and device: a dict of the asked
    ``outputs`` (names of ``OUTPUTS``; None asks for all): ``vertices`` [B,
    V, 3], ``joints`` (24 + 21 keypoints, + 9 regressed with the extra
    regressor) and each joint set the joints reach. ``smpl`` alone runs no
    skinning."""
    want = set(OUTPUTS if outputs is None else outputs)
    if want - set(OUTPUTS):
        raise ValueError(f"unknown SMPL outputs {sorted(want - set(OUTPUTS))}; known: {OUTPUTS}")
    m = model.tensors(betas.device, betas.dtype)
    rot_mats = torch.cat([global_orient[:, None], body_pose], dim=1)  # [B, J, 3, 3]
    joints_rest = m["j_template"] + torch.einsum("bl,jkl->bjk", betas, m["j_shapedirs"])
    posed_joints, transforms = _rigid_transforms(rot_mats, joints_rest, model.parents)
    if transl is not None:
        posed_joints = posed_joints + transl[:, None]
    if want <= {"smpl"}:
        return {"smpl": posed_joints[:, :len(SMPL_INDEXES)]} if want else {}

    vertices = _skin(m, betas, rot_mats, joints_rest, transforms)
    if transl is not None:
        vertices = vertices + transl[:, None]
    # Joint sets: 24 smpl + 21 mesh keypoints (+ 9 extra regressed).
    all_joints = torch.cat([posed_joints, vertices[:, m["extra_vertex_ids"]]], dim=1)
    if "j_regressor_extra" in m:
        extra = torch.einsum("jv,bvk->bjk", m["j_regressor_extra"], vertices)
        all_joints = torch.cat([all_joints, extra], dim=1)  # [B, 54, 3]
    out = {"vertices": vertices, "joints": all_joints}
    for name, idx in JOINT_SET_INDEXES.items():
        if idx.max() < all_joints.shape[1]:
            out[name] = all_joints[:, torch.as_tensor(idx, device=vertices.device).long()]
    return {k: v for k, v in out.items() if k in want}
