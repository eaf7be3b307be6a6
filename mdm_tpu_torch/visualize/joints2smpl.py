"""Fit SMPL parameters to xyz joints (the mesh export path).

Counterpart of mdm_tpu/visualize/joints2smpl.py, which redesigns the
reference's SMPLify-3D (visualize/simplify_loc2rot.py: 150 LBFGS iterations
with a GMM pose prior) as Adam over a rot6d pose, translation and shape,
all frames at once. Here the same loss and the same optimiser arithmetic
run on the port's SMPL layer (smpl/lbs.py): ``optax.adam`` (moments, bias
corrections, ``m / (sqrt(v) + eps)``) under ``optax.cosine_decay_schedule(lr,
iterations, alpha=0.02)``, written out rather than ``torch.optim.Adam``,
whose update is ordered differently. Each iteration's loss reads only the
``smpl`` joints, which ``lbs`` computes without skinning; the vertices are
skinned once, after the fit.

Outputs the reference's artifacts: per-frame thetas (rot6d [T, 25, 6] with
the translation row), vertices, ``.obj`` files (``NpyToObj``) and the
HumanIK-style JSON (``motions2hik``).
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, Optional

import numpy as np
import torch

from ..core import rotations as R
from ..smpl import SMPLModel, lbs

@dataclass
class FitConfig:
    iterations: int = 150
    lr: float = 0.02
    pose_reg: float = 1e-3  # pull toward the rest pose (the L2 fallback without the GMM)
    shape_reg: float = 1e-2
    joints_category: str = "AMASS"
    # GMM pose prior (reference smplify.py:67-69, customloss.py:128-188).
    # 'auto': with gmm_08.pkl when it is found, else the L2 fallback; True:
    # require it; False: never.
    use_gmm_prior: str | bool = "auto"
    # reference body_fitting_loss_3d weights (customloss.py:132-135 and the
    # smplify.py:229-233 call: joint 600, pose-preserve 5)
    joint_loss_weight: float = 600.0
    pose_prior_weight: float = 4.78 * 1.5
    shape_prior_weight: float = 5.0
    angle_prior_weight: float = 15.2
    gmof_sigma: float = 100.0
    smooth_weight: float = 0.1  # temporal smoothness (mdm_tpu's; the reference fits per frame)
    lr_decay: bool = True  # cosine-decay the Adam lr to 2% over the run
    # One betas vector per frame, as SMPLify3D batches frames (smplify.py:141-143);
    # the default keeps one body shape per sequence.
    per_frame_betas: bool = False


def _resolve_prior(config: FitConfig):
    from .prior import MaxMixturePrior, find_gmm_asset

    if config.use_gmm_prior is False:
        return None
    path = find_gmm_asset()
    if path is None:
        if config.use_gmm_prior is True:
            raise FileNotFoundError("use_gmm_prior=True but gmm_08.pkl was not found "
                                    "(set $MDM_TPU_GMM_PRIOR)")
        return None
    return MaxMixturePrior.load(path)


def _safe_matrix_to_axis_angle(m: torch.Tensor) -> torch.Tensor:
    """matrix -> axis-angle with finite gradients at the identity: the log
    map through the skew part s (|s| = sin theta) and atan2(|s|, cos theta),
    where theta / |s| -> 1 as theta -> 0 (the quaternion route takes sqrt(0)
    there, the fit's starting pose). Not valid near theta = pi, which the
    fit's per-joint rotations do not reach."""
    s = 0.5 * torch.stack([m[..., 2, 1] - m[..., 1, 2], m[..., 0, 2] - m[..., 2, 0],
                           m[..., 1, 0] - m[..., 0, 1]], dim=-1)
    c = 0.5 * (m[..., 0, 0] + m[..., 1, 1] + m[..., 2, 2] - 1.0)
    n = torch.sqrt((s * s).sum(dim=-1, keepdim=True) + 1e-12)
    return s * (torch.atan2(n, c[..., None]) / n)


def cosine_decay(lr: float, decay_steps: int, alpha: float, count: int) -> float:
    """optax.cosine_decay_schedule(lr, decay_steps, alpha) at ``count``."""
    t = min(count, decay_steps)
    return lr * ((1.0 - alpha) * 0.5 * (1.0 + math.cos(math.pi * t / decay_steps)) + alpha)


class OptaxAdam:
    """optax.adam(b1=0.9, b2=0.999, eps=1e-8) on a list of tensors, updated
    in place: mu = (1 - b1) g + b1 mu, nu = (1 - b2) g^2 + b2 nu, count += 1,
    p += -lr(count before) * (mu / (1 - b1^count)) / (sqrt(nu / (1 -
    b2^count)) + eps)."""

    def __init__(self, params, schedule, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8):
        self.params, self.schedule = params, schedule
        self.b1, self.b2, self.eps = b1, b2, eps
        self.mu = [torch.zeros_like(p) for p in params]
        self.nu = [torch.zeros_like(p) for p in params]
        self.count = 0

    @torch.no_grad()
    def step(self, grads) -> None:
        lr = self.schedule(self.count)
        self.count += 1
        c1 = float(np.float32(1.0) - np.float32(self.b1) ** np.float32(self.count))
        c2 = float(np.float32(1.0) - np.float32(self.b2) ** np.float32(self.count))
        for p, g, mu, nu in zip(self.params, grads, self.mu, self.nu):
            mu.mul_(self.b1).add_(g, alpha=1.0 - self.b1)
            nu.mul_(self.b2).add_(g * g, alpha=1.0 - self.b2)
            p.add_((mu / c1) / (torch.sqrt(nu / c2) + self.eps), alpha=-lr)


def fit_smpl(model: SMPLModel, target_joints: np.ndarray, config: FitConfig = FitConfig(),
             init_thetas: Optional[np.ndarray] = None, device="cuda") -> Dict[str, np.ndarray]:
    """SMPL pose (rot6d), translation and shape fitted to ``target_joints``
    [T, J<=24, 3] on ``device``, every frame at once. Returns host arrays:
    ``thetas`` [T, 25, 6] (the last row the root translation from frame 0),
    ``betas``, ``transl``, ``vertices`` [T, V, 3], ``joints`` and ``losses``
    [iterations] (each iteration's loss before its update)."""
    T, J, _ = target_joints.shape
    f32 = dict(dtype=torch.float32, device=device)
    target = torch.as_tensor(np.asarray(target_joints, np.float32)).to(device)
    prior = _resolve_prior(config)

    ident6 = torch.tensor([1.0, 0, 0, 0, 1.0, 0], **f32).expand(T, 24, 6)
    # a copy: the fit updates it in place, and the caller's array stays as it was
    pose6d = (torch.tensor(np.asarray(init_thetas, np.float32), device=device)
              if init_thetas is not None else ident6.clone())
    betas = torch.zeros((T, model.num_betas) if config.per_frame_betas else (model.num_betas,),
                        **f32)
    transl = target[:, 0].clone()
    params = [pose6d.requires_grad_(), betas.requires_grad_(), transl.requires_grad_()]

    def smpl(p, outputs):
        rots = R.rotation_6d_to_matrix(p[0])  # [T, 24, 3, 3]
        return lbs(model, p[1].expand(T, model.num_betas), rots[:, 0], rots[:, 1:],
                   transl=p[2], outputs=outputs)

    def loss_fn(p):
        pose, b = p[0], p[1]
        # the humanml joints are the first 22 SMPL body joints, in order
        pred = smpl(p, ("smpl",))["smpl"][:, :J]
        smooth = ((pose[1:] - pose[:-1]) ** 2).mean() if T > 1 else 0.0
        if prior is not None:
            # The reference's body_fitting_loss_3d (customloss.py:128-188),
            # per frame then summed: GMoF joints, GMM pose NLL, the knee and
            # elbow angle prior, the shape prior; the 6d -> axis-angle
            # conversion gives the prior the 69-d body pose the reference
            # optimises directly.
            from .prior import angle_prior, gmof

            body_aa = _safe_matrix_to_axis_angle(
                R.rotation_6d_to_matrix(pose[:, 1:])).reshape(T, 69)
            joint_loss = config.joint_loss_weight ** 2 * gmof(pred - target,
                                                              config.gmof_sigma).sum(dim=(-2, -1))
            pose_prior = config.pose_prior_weight ** 2 * prior(body_aa)
            angle = config.angle_prior_weight ** 2 * angle_prior(body_aa).sum(dim=-1)
            shape = config.shape_prior_weight ** 2 * (b ** 2).sum()
            total = (joint_loss + pose_prior + angle).sum() + shape
            # normalised by the joint weight: Adam sees O(1) magnitudes and
            # the smoothness term keeps its scale against the fallback's
            return total / (config.joint_loss_weight ** 2 * T) + config.smooth_weight * smooth
        return (((pred - target) ** 2).mean()
                + config.pose_reg * ((pose[:, 1:] - ident6[:, 1:]) ** 2).mean()
                + config.shape_reg * (b ** 2).sum() + config.smooth_weight * smooth)

    schedule = ((lambda n: cosine_decay(config.lr, config.iterations, 0.02, n))
                if config.lr_decay else (lambda n: config.lr))
    adam = OptaxAdam(params, schedule)
    losses = []
    for _ in range(config.iterations):
        loss = loss_fn(params)
        adam.step(torch.autograd.grad(loss, params))
        losses.append(loss.detach())

    with torch.no_grad():
        out = smpl(params, ("vertices", "joints"))
    transl = params[2].detach().cpu().numpy()
    trans_row = np.zeros((T, 1, 6), np.float32)
    trans_row[:, 0, :3] = transl - transl[:1]
    return {
        "thetas": np.concatenate([params[0].detach().cpu().numpy(), trans_row], axis=1),
        "betas": params[1].detach().cpu().numpy(),
        "transl": transl,
        "vertices": out["vertices"].cpu().numpy(),
        "joints": out["joints"].cpu().numpy(),
        "losses": (torch.stack(losses).cpu().numpy() if losses
                   else np.zeros((0,), np.float32)),
    }


class NpyToObj:
    """results.npy -> per-frame .obj meshes (reference visualize/vis_utils.py)."""

    def __init__(self, npy_path: str, sample_idx: int = 0, rep_idx: int = 0,
                 model: Optional[SMPLModel] = None, fit_config: FitConfig = FitConfig(),
                 device="cuda"):
        data = np.load(npy_path, allow_pickle=True).item()
        n = data["num_samples"]
        motion = data["motion"][rep_idx * n + sample_idx]  # [T, J, 3]
        self.model = model or SMPLModel.load()
        self.fit = fit_smpl(self.model, motion, fit_config, device=device)
        self.faces = self.model.faces
        self.vertices = self.fit["vertices"]
        self.num_frames = len(self.vertices)

    def save_obj(self, path: str, frame: int) -> str:
        verts = self.vertices[frame]
        with open(path, "w") as f:
            for v in verts:
                f.write(f"v {v[0]:.6f} {v[1]:.6f} {v[2]:.6f}\n")
            if self.faces is not None:
                for tri in self.faces + 1:
                    f.write(f"f {tri[0]} {tri[1]} {tri[2]}\n")
        return path

    def save_npy(self, path: str) -> str:
        np.save(path, {"thetas": self.fit["thetas"], "betas": self.fit["betas"],
                       "transl": self.fit["transl"]})
        return path


HIK_JOINT_MAP = [
    "Hips", "LeftUpLeg", "RightUpLeg", "Spine", "LeftLeg", "RightLeg",
    "Spine1", "LeftFoot", "RightFoot", "Spine2", "LeftToeBase",
    "RightToeBase", "Neck", "LeftShoulder", "RightShoulder", "Head",
    "LeftArm", "RightArm", "LeftForeArm", "RightForeArm", "LeftHand",
    "RightHand",
]


def motions2hik(motions: np.ndarray, model: Optional[SMPLModel] = None,
                fit_config: FitConfig = FitConfig(), device="cuda") -> dict:
    """Model output -> the HumanIK-style JSON dict (Maya / MotionBuilder) of
    the reference's visualize/motions2hik.py:40-103: ``motions`` [nreps, T,
    J, 3] xyz joints are fitted to rotations on ``device`` first; [nreps, T,
    25, 6] rot6d thetas are converted directly. Returns {'joint_map',
    'thetas' [nreps, T, J, 3] degrees, 'root_translation'}."""
    thetas_all, trans_all = [], []
    for rep in motions:
        if rep.shape[-1] == 3:  # xyz joints -> fit
            model = model or SMPLModel.load()
            thetas6d = fit_smpl(model, rep, fit_config, device=device)["thetas"]
        else:
            thetas6d = rep
        thetas_all.append(motions_to_euler(thetas6d[:, :-1]))  # without the translation row
        trans_all.append(thetas6d[:, -1, :3])
    return {"joint_map": HIK_JOINT_MAP, "thetas": np.stack(thetas_all).tolist(),
            "root_translation": np.stack(trans_all).tolist()}


def motions_to_euler(thetas6d: np.ndarray, order: str = "XYZ") -> np.ndarray:
    """rot6d thetas [T, J, 6] -> euler angles in degrees [T, J, 3]."""
    mats = R.rotation_6d_to_matrix(torch.as_tensor(np.asarray(thetas6d, np.float32)))
    return np.degrees(R.matrix_to_euler_angles(mats, order).numpy())
