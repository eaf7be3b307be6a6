"""Action-to-motion datasets (HumanAct12, UESTC), host pipeline.

Counterpart of mdm_tpu/data/a2m.py (reference data_loaders/a2m/{dataset,
humanact12poses,uestc}.py) with numpy and an explicit RNG. Pose sequences
are axis-angle [T, 24, 3]; representations (rotvec/rotmat/rotquat/rot6d)
are converted on access, the root translation appended as a 25th "joint"
row (first 3 dims), and clips padded/sampled to a fixed frame count: the
model sees [B, T, 25*6] for rot6d.

The conversions run on CPU tensors through core/rotations, with the sines,
cosines and arctangents of the angles taken from the C library's
single-precision ``sinf``/``cosf``/``atan2f``: mdm_tpu's conversion on its
CPU backend reaches the same functions, so both packages give the same
features bit for bit (torch's vectorised sin and cos differ from them in
the last bit).
"""
from __future__ import annotations

import ctypes
import ctypes.util
import functools
import os
import pickle
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from ..core import rotations as R

HUMANACT12_ACTIONS = {
    0: "warm_up", 1: "walk", 2: "run", 3: "jump", 4: "drink",
    5: "lift_dumbbell", 6: "sit", 7: "eat", 8: "turn steering wheel",
    9: "phone", 10: "boxing", 11: "throw",
}


@functools.lru_cache(maxsize=None)
def _libm(name: str, nargs: int):
    """The C library's single-precision ``name`` as an elementwise numpy
    function of ``nargs`` arguments."""
    lib = ctypes.CDLL(ctypes.util.find_library("m"))
    fn = getattr(lib, name)
    fn.restype = ctypes.c_float
    fn.argtypes = [ctypes.c_float] * nargs
    return np.frompyfunc(fn, nargs, 1)


def _f32_call(name: str, *args: torch.Tensor) -> torch.Tensor:
    out = _libm(name, len(args))(*(a.numpy() for a in args))
    return torch.from_numpy(np.asarray(out, dtype=np.float32).reshape(args[0].shape))


def _tensor(x: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.array(x, dtype=np.float32))  # a copy: x may be read-only


def _axis_angle_to_quaternion(aa: torch.Tensor) -> torch.Tensor:
    """rotations.axis_angle_to_quaternion with the C library's trig."""
    angles = torch.linalg.vector_norm(aa, dim=-1, keepdim=True)
    half = angles * 0.5
    return torch.cat([_f32_call("cosf", half),
                      aa * R.sin_half_over_angle(angles, _f32_call("sinf", half))], dim=-1)


def _axis_angle_to_matrix(aa: np.ndarray) -> np.ndarray:
    return R.quaternion_to_matrix(_axis_angle_to_quaternion(_tensor(aa))).numpy()


def _matrix_to_axis_angle(matrix: np.ndarray) -> np.ndarray:
    """rotations.matrix_to_axis_angle with the C library's trig."""
    q = R.matrix_to_quaternion(_tensor(matrix))
    half = _f32_call("atan2f", torch.linalg.vector_norm(q[..., 1:], dim=-1, keepdim=True),
                     q[..., :1].contiguous())
    return (q[..., 1:] / R.sin_half_over_angle(2.0 * half, _f32_call("sinf", half))).numpy()


def _to_rep(pose_rotvec: np.ndarray, pose_rep: str) -> np.ndarray:
    """axis-angle [T, J, 3] -> chosen representation [T, J, F]."""
    if pose_rep == "rotvec":
        return np.asarray(pose_rotvec, dtype=np.float32)
    q = _axis_angle_to_quaternion(_tensor(pose_rotvec))
    if pose_rep == "rotmat":
        out = R.quaternion_to_matrix(q).reshape(pose_rotvec.shape[:2] + (9,))
    elif pose_rep == "rotquat":
        out = q
    elif pose_rep == "rot6d":
        out = R.matrix_to_rotation_6d(R.quaternion_to_matrix(q))
    else:
        raise ValueError(pose_rep)
    return out.numpy().astype(np.float32, copy=False)


@dataclass
class A2MConfig:
    num_frames: int = 60
    sampling: str = "conseq"  # conseq | random_conseq | random
    sampling_step: int = 1
    pose_rep: str = "rot6d"
    translation: bool = True
    glob: bool = True
    max_len: int = -1
    min_len: int = -1
    align_pose_frontview: bool = False


class ActionMotionDataset:
    """Base action dataset; subclasses fill _pose/_joints/_actions lists."""

    dataname = "a2m"

    def __init__(self, config: A2MConfig, split: str = "train"):
        self.config = config
        self.split = split
        self._pose: List[np.ndarray] = []
        self._joints: List[Optional[np.ndarray]] = []
        self._actions: List[int] = []
        self._train: List[int] = []
        self._test: List[int] = []
        self._action_classes: Dict[int, str] = {}
        self.num_actions: int = 0

    # ----------------------------------------------------------- frame picks
    def _frame_indices(self, nframes: int, rng: np.random.Generator) -> np.ndarray:
        cfg = self.config
        num_frames = cfg.num_frames if cfg.num_frames != -1 else cfg.max_len
        if cfg.num_frames == -1 and (cfg.max_len == -1 or nframes <= cfg.max_len):
            return np.arange(nframes)
        if num_frames > nframes:
            pad = (nframes - 1) * np.ones(num_frames - nframes, dtype=int)
            return np.concatenate([np.arange(nframes), pad])
        if cfg.sampling in ("conseq", "random_conseq"):
            step_max = (nframes - 1) // (num_frames - 1)
            if cfg.sampling == "conseq":
                step = (
                    step_max
                    if cfg.sampling_step == -1 or cfg.sampling_step * (num_frames - 1) >= nframes
                    else cfg.sampling_step
                )
            else:
                step = int(rng.integers(1, step_max + 1))
            lastone = step * (num_frames - 1)
            shift_max = nframes - lastone - 1
            shift = int(rng.integers(0, max(shift_max, 1)))
            return shift + np.arange(0, lastone + 1, step)
        if cfg.sampling == "random":
            return np.sort(rng.choice(nframes, num_frames, replace=False))
        raise ValueError(cfg.sampling)

    # --------------------------------------------------------------- access
    def _pose_features(self, idx: int, frame_ix: np.ndarray) -> np.ndarray:
        cfg = self.config
        pose = self._pose[idx][frame_ix].reshape(len(frame_ix), -1, 3).copy()
        if not cfg.glob:
            pose = pose[:, 1:]

        trans = None
        if cfg.translation:
            if self._joints[idx] is not None:
                joints = self._joints[idx][frame_ix]
                joints = joints - joints[0, 0]
                trans = joints[:, 0].copy()
            else:
                trans = np.zeros((len(frame_ix), 3), np.float32)

        if cfg.align_pose_frontview:
            first = _axis_angle_to_matrix(pose[0, 0])
            roots = _axis_angle_to_matrix(pose[:, 0])
            aligned = first.T @ roots
            pose[:, 0] = _matrix_to_axis_angle(aligned)
            if trans is not None:
                trans = (first.T @ trans.T).T

        feats = _to_rep(pose, cfg.pose_rep)  # [T, J, F]
        if cfg.translation:
            pad = np.zeros((feats.shape[0], 1, feats.shape[2]), np.float32)
            pad[:, 0, :3] = trans
            feats = np.concatenate([feats, pad], axis=1)
        return feats  # [T, J(+1), F]

    def indices(self) -> List[int]:
        return self._train if self.split == "train" else self._test

    def __len__(self) -> int:
        return len(self.indices())

    def sample(self, item: int, rng: np.random.Generator) -> Dict:
        idx = self.indices()[item]
        nframes = len(self._pose[idx])
        frame_ix = self._frame_indices(nframes, rng)
        feats = self._pose_features(idx, frame_ix)  # [T, J, F]
        T, J, F = feats.shape
        action = int(self._actions[idx])
        return {
            "motion": feats.reshape(T, J * F),
            "length": T,
            "original_length": T,
            "action": action,
            "action_text": self._action_classes[action],
            "key": str(idx),
        }


class HumanAct12(ActionMotionDataset):
    """humanact12poses.pkl: {'poses': [T,72] rotvec, 'joints3D', 'y'}."""

    dataname = "humanact12"

    def __init__(self, config: A2MConfig, datapath="dataset/HumanAct12Poses", split="train"):
        super().__init__(config, split)
        with open(os.path.join(datapath, "humanact12poses.pkl"), "rb") as f:
            data = pickle.load(f)
        self._pose = [np.asarray(p, np.float32) for p in data["poses"]]
        self._joints = [np.asarray(j, np.float32) for j in data["joints3D"]]
        self._actions = [int(y) for y in data["y"]]
        self.num_actions = 12
        self._action_classes = HUMANACT12_ACTIONS
        self._train = list(range(len(self._pose)))  # train-only dataset
        self._test = list(range(len(self._pose)))


def solve_camera_depth(cam_s, cam_pos, joints, img_size=540, flength=500) -> float:
    """Depth that best maps the orthographic crop camera to perspective
    (reference uestc.py:14-23)."""
    target = (cam_s * (joints[:, :2] + cam_pos) + 1) * 0.5 * img_size
    height3d = np.linalg.norm(joints[:, :2].max(axis=0) - joints[:, :2].min(axis=0))
    height2d = np.linalg.norm(target.max(axis=0) - target.min(axis=0))
    return float(flength * (height3d / height2d))


def trans_from_vibe(orig_cam: np.ndarray, joints3d: np.ndarray, use_z=True) -> np.ndarray:
    """Global translation trajectory from VIBE's orig_cam [T, 4] (sx, sy,
    tx, ty) + joints (reference get_trans_from_vibe, uestc.py:26-49)."""
    trans = []
    for t in range(len(joints3d)):
        cam = orig_cam[t]
        z = solve_camera_depth(cam[0], cam[2:4], joints3d[t]) if use_z else 0.0
        trans.append([cam[2], cam[3], z])
    trans = np.asarray(trans)
    return trans - trans[0]


def uestc_action_classes(datapath: str = "dataset/uestc"):
    """index -> action-name map from info/action_classes.txt (reference
    uestc.py:40-74), with an action_{i} fallback when the file is absent.
    Shared by the dataset and the generate CLI's name resolution."""
    classes_path = os.path.join(datapath, "info", "action_classes.txt")
    if os.path.exists(classes_path):
        with open(classes_path) as f:
            return {i: line.strip() for i, line in enumerate(f) if line.strip()}
    return {i: f"action_{i}" for i in range(UESTC.NUM_ACTIONS)}


class UESTC(ActionMotionDataset):
    """UESTC VIBE-estimated poses: 40 actions, 118 subjects (51 train).

    Mirror of reference uestc.py:50-226: vibe_cache_refined.pkl (pose /
    joints3d / orig_cam per video), names.txt (`aA_dV_pS_cC_color.avi`),
    8 views rotated to frontview for side-2 cameras, global translation
    recovered from the crop camera, num_frames*3/4 min-length filter.
    """

    dataname = "uestc"
    NUM_ACTIONS = 40
    TRAIN_SUBJECTS = [
        1, 2, 6, 12, 13, 16, 21, 24, 28, 29, 30, 31, 33, 35, 39, 41, 42, 45,
        47, 50, 52, 54, 55, 57, 59, 61, 63, 64, 67, 69, 70, 71, 73, 77, 81,
        84, 86, 87, 88, 90, 91, 93, 96, 99, 102, 103, 104, 107, 108, 112, 113,
    ]

    @staticmethod
    def parse_name(video: str):
        spl = video.split("_")
        return (int(spl[0][1:]), int(spl[1][1:]), int(spl[2][1:]), int(spl[3][1:]))

    def __init__(self, config: A2MConfig, datapath="dataset/uestc", split="train",
                 view="all"):
        import pickle as pkl

        super().__init__(config, split)
        with open(os.path.join(datapath, "info", "names.txt")) as f:
            videos = [line.strip() for line in f if line.strip()]
        with open(os.path.join(datapath, "info", "num_frames_min.txt")) as f:
            num_frames_video = np.asarray([int(s) for s in f.read().split()])

        with open(os.path.join(datapath, "vibe_cache_refined.pkl"), "rb") as f:
            vibe = pkl.load(f)
        self._pose = [np.asarray(p, np.float32) for p in vibe["pose"]]
        joints3d = [np.asarray(j, np.float32) for j in vibe["joints3d"]]
        num_frames_video = np.minimum(
            num_frames_video, [len(p) for p in self._pose]
        ).astype(int)

        # View rotation matrices about y (45-degree increments).
        def rot_for(v):
            theta = -v * np.pi / 4
            return _axis_angle_to_matrix(np.asarray([0.0, theta, 0.0], np.float32))

        rotations = {v: rot_for(v) for v in range(8)}

        self.num_actions = self.NUM_ACTIONS
        self._action_classes = uestc_action_classes(datapath)

        for index, video in enumerate(videos):
            action, vview, subject, side = self.parse_name(video)
            if view == "frontview" and side != 1:
                continue
            globtrans = trans_from_vibe(
                np.asarray(vibe["orig_cam"][index]), joints3d[index]
            ) if "orig_cam" in vibe else np.zeros((len(joints3d[index]), 3), np.float32)
            if side != 1:
                if vview == 8:
                    continue
                rot = rotations[vview]
                glob = _axis_angle_to_matrix(self._pose[index][:, :3])
                self._pose[index][:, :3] = _matrix_to_axis_angle(
                    (torch.from_numpy(rot) @ torch.from_numpy(glob)).numpy()
                )
                joints3d[index] = joints3d[index] @ rot.T
                globtrans = globtrans @ rot.T
            joints3d[index] = joints3d[index] + globtrans[:, None]

            self._joints.append(joints3d[index])
            self._actions.append(action)
            if subject in self.TRAIN_SUBJECTS:
                self._train.append(len(self._joints) - 1)
            else:
                self._test.append(len(self._joints) - 1)

        # pose list must align with the joints/actions list we kept
        kept = len(self._joints)
        if kept != len(self._pose):
            # rebuild pose list for kept entries only (frontview filtering)
            new_pose = []
            j = 0
            for index, video in enumerate(videos):
                action, vview, subject, side = self.parse_name(video)
                if view == "frontview" and side != 1:
                    continue
                if side != 1 and vview == 8:
                    continue
                new_pose.append(self._pose[index])
                j += 1
            self._pose = new_pose

        # Min-length filter on the train split (reference uestc.py:168-178).
        if config.num_frames > 0:
            threshold = config.num_frames * 3 / 4
            ok = {i for i in range(len(self._pose)) if len(self._pose[i]) >= threshold}
            self._train = sorted(set(self._train) & ok)
