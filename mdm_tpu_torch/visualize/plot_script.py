"""Stick-figure motion rendering (host matplotlib; a copy of
mdm_tpu/visualize/plot_script.py).

Capability mirror of the reference plot_3d_motion (data_loaders/humanml/
utils/plot_script.py:28-147): 3D animated skeleton with per-dataset scaling,
ground plane following the root trajectory, blue=GT / orange=generated color
scheme. Saves mp4 when ffmpeg is present, else an animated gif via pillow.
"""
from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np

from ..core.skeleton import KIT_KINEMATIC_CHAINS, T2M_KINEMATIC_CHAINS

DATASET_SCALE = {"humanml": 1.3, "kit": 0.003 * 1.3, "humanact12": 1.0, "uestc": 1.0}

COLORS_ORANGE = ["#DD5A37", "#D69E00", "#B75A39", "#FF6D00", "#DDB50E"]
COLORS_BLUE = ["#4D84AA", "#5B9965", "#61CEB9", "#34C1E2", "#80B79A"]


def _chains_for(dataset: str, njoints: int) -> List[List[int]]:
    if dataset == "kit" or njoints == 21:
        return [list(c) for c in KIT_KINEMATIC_CHAINS]
    if njoints == 22:
        return [list(c) for c in T2M_KINEMATIC_CHAINS]
    # a2m (24/25 joints): SMPL chains
    smpl_parents = [-1, 0, 0, 0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 9, 9, 12, 13, 14, 16, 17, 18, 19, 20, 21]
    chains = []
    for leaf in [10, 11, 15, 22, 23]:
        chain = [leaf]
        while smpl_parents[chain[-1]] >= 0:
            chain.append(smpl_parents[chain[-1]])
        chains.append(chain[::-1])
    return chains


def plot_3d_motion(
    save_path: str,
    joints: np.ndarray,  # [T, J, 3]
    title: str = "",
    dataset: str = "humanml",
    fps: float = 20,
    figsize=(3, 3),
    radius: float = 3.0,
    gt_frames: Sequence[int] = (),
    kinematic_tree: Optional[List[List[int]]] = None,
):
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    from matplotlib.animation import FFMpegWriter, FuncAnimation, PillowWriter
    from mpl_toolkits.mplot3d.art3d import Poly3DCollection  # noqa: F401

    data = np.asarray(joints, dtype=np.float64).copy()
    data *= DATASET_SCALE.get(dataset, 1.0)
    T, J, _ = data.shape
    chains = kinematic_tree or _chains_for(dataset, J)

    # Normalize: put on floor, track root trajectory on XZ.
    data[..., 1] -= data[..., 1].min()
    trajec = data[:, 0, [0, 2]].copy()
    data[..., 0] -= data[:, 0:1, 0]
    data[..., 2] -= data[:, 0:1, 2]

    title_lines = "\n".join(
        [title[i : i + 40] for i in range(0, len(title), 40)][:3]
    )

    fig = plt.figure(figsize=figsize)
    ax = fig.add_subplot(111, projection="3d")

    def update(index):
        ax.clear()
        ax.set_xlim3d([-radius / 2, radius / 2])
        ax.set_ylim3d([0, radius])
        ax.set_zlim3d([0, radius])
        ax.grid(False)
        ax.set_axis_off()
        ax.view_init(elev=120, azim=-90)
        ax.dist = 7.5
        fig.suptitle(title_lines, fontsize=8)

        # ground plane corners follow the trajectory
        minx, maxx = -radius / 2 - trajec[index, 0], radius / 2 - trajec[index, 0]
        minz, maxz = -trajec[index, 1], radius - trajec[index, 1]
        verts = np.array(
            [[minx, 0, minz], [minx, 0, maxz], [maxx, 0, maxz], [maxx, 0, minz]]
        )
        ax.add_collection3d(
            Poly3DCollection([verts], facecolors=(0.5, 0.5, 0.5, 0.5))
        )

        colors = COLORS_BLUE if index in gt_frames else COLORS_ORANGE
        for i, (chain, color) in enumerate(zip(chains, colors * 2)):
            lw = 4.0 if i < 5 else 2.0
            ax.plot3D(
                data[index, chain, 0], data[index, chain, 1], data[index, chain, 2],
                linewidth=lw, color=color,
            )

    anim = FuncAnimation(fig, update, frames=T, interval=1000 / fps, repeat=False)
    try:
        anim.save(save_path, writer=FFMpegWriter(fps=fps))
    except Exception:
        gif = save_path.rsplit(".", 1)[0] + ".gif"
        anim.save(gif, writer=PillowWriter(fps=min(fps, 10)))
        save_path = gif
    plt.close(fig)
    return save_path


def save_multiple_samples(paths: List[str], out_path: str, fps: float = 20):
    """Tile per-sample videos into one grid video (needs ffmpeg)."""
    import shutil
    import subprocess

    if shutil.which("ffmpeg") is None or len(paths) < 2:
        return None
    n = len(paths)
    inputs = []
    for p in paths:
        inputs += ["-i", p]
    filter_ = f"hstack=inputs={n}"
    subprocess.run(
        ["ffmpeg", "-y", *inputs, "-filter_complex", filter_, out_path],
        check=False, capture_output=True,
    )
    return out_path


def plot_3d_motion_grid(
    save_path: str,
    motions: List[np.ndarray],  # row-major [T, J, 3] per cell
    titles: List[str],
    ncols: int,
    dataset: str = "humanml",
    fps: float = 20,
    radius: float = 3.0,
    gt_frames: Sequence[int] = (),
):
    """One tiled animation of samples x repetitions (the reference's
    moviepy `clips_array` grid, sample/generate.py:253-280 — `sample-all` /
    `samples_XX_to_YY.mp4`). Rendered directly as a multi-axes matplotlib
    animation instead of compositing per-sample video files, so it needs
    neither moviepy nor ffmpeg (pillow-gif fallback like plot_3d_motion).

    Shorter motions should be pre-frozen by the caller (reference
    generate.py:236-238 duplicates the last frame); cells render
    min(T_cell, index) frames by holding the final pose.
    """
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    from matplotlib.animation import FFMpegWriter, FuncAnimation, PillowWriter
    from mpl_toolkits.mplot3d.art3d import Poly3DCollection  # noqa: F401

    n = len(motions)
    nrows = (n + ncols - 1) // ncols
    scale = DATASET_SCALE.get(dataset, 1.0)
    prepped = []
    for m in motions:
        data = np.asarray(m, dtype=np.float64).copy() * scale
        data[..., 1] -= data[..., 1].min()
        trajec = data[:, 0, [0, 2]].copy()
        data[..., 0] -= data[:, 0:1, 0]
        data[..., 2] -= data[:, 0:1, 2]
        prepped.append((data, trajec))
    chains = _chains_for(dataset, motions[0].shape[1])
    total_frames = max(d.shape[0] for d, _ in prepped)

    fig = plt.figure(figsize=(3 * ncols, 3 * nrows))
    axes = [
        fig.add_subplot(nrows, ncols, i + 1, projection="3d") for i in range(n)
    ]

    def update(index):
        for cell, (ax, (data, trajec)) in enumerate(zip(axes, prepped)):
            idx = min(index, data.shape[0] - 1)
            ax.clear()
            ax.set_xlim3d([-radius / 2, radius / 2])
            ax.set_ylim3d([0, radius])
            ax.set_zlim3d([0, radius])
            ax.grid(False)
            ax.set_axis_off()
            ax.view_init(elev=120, azim=-90)
            ax.dist = 7.5
            t = titles[cell] if cell < len(titles) else ""
            ax.set_title("\n".join([t[i: i + 30] for i in range(0, len(t), 30)][:2]),
                         fontsize=7)
            minx, maxx = -radius / 2 - trajec[idx, 0], radius / 2 - trajec[idx, 0]
            minz, maxz = -trajec[idx, 1], radius - trajec[idx, 1]
            verts = np.array(
                [[minx, 0, minz], [minx, 0, maxz], [maxx, 0, maxz], [maxx, 0, minz]]
            )
            ax.add_collection3d(
                Poly3DCollection([verts], facecolors=(0.5, 0.5, 0.5, 0.5))
            )
            colors = COLORS_BLUE if idx in gt_frames else COLORS_ORANGE
            for i, (chain, color) in enumerate(zip(chains, colors * 2)):
                lw = 4.0 if i < 5 else 2.0
                ax.plot3D(
                    data[idx, chain, 0], data[idx, chain, 1], data[idx, chain, 2],
                    linewidth=lw, color=color,
                )

    anim = FuncAnimation(
        fig, update, frames=total_frames, interval=1000 / fps, repeat=False
    )
    try:
        anim.save(save_path, writer=FFMpegWriter(fps=fps))
    except Exception:
        gif = save_path.rsplit(".", 1)[0] + ".gif"
        anim.save(gif, writer=PillowWriter(fps=min(fps, 10)))
        save_path = gif
    plt.close(fig)
    return save_path
