"""Mesh export: results.npy -> SMPL fit -> per-frame .obj files.

Counterpart of mdm_tpu/cli/render_mesh.py (reference visualize/render_mesh.py
and vis_utils.npy2obj):

    python -m mdm_tpu_torch.cli.render_mesh --input_path save/run/results.npy

Fits one sample of one repetition with ``visualize.joints2smpl.fit_smpl`` on
``--device`` (a CUDA index, default 0, or ``cpu``) and writes
``smpl_params.npy`` and ``frame{i:03d}.obj``. Needs the SMPL model asset
(``body_models/smpl/SMPL_NEUTRAL.pkl`` under the working directory).
"""
from __future__ import annotations

import argparse
import os


def main(argv=None):
    from ..utils.parser import _device_arg, select_device
    from ..visualize.joints2smpl import FitConfig, NpyToObj

    p = argparse.ArgumentParser()
    p.add_argument("--input_path", required=True, help="results.npy from generate")
    p.add_argument("--sample_idx", default=0, type=int)
    p.add_argument("--rep_idx", default=0, type=int)
    p.add_argument("--iterations", default=150, type=int)
    p.add_argument("--out_dir", default="", type=str)
    p.add_argument("--device", default=0, type=_device_arg,
                   help="CUDA device index (default 0), or 'cpu'")
    args = p.parse_args(argv)
    device = select_device(args)

    out_dir = args.out_dir or os.path.join(
        os.path.dirname(args.input_path),
        f"{os.path.basename(args.input_path).replace('.npy', '')}"
        f"_obj_s{args.sample_idx}_r{args.rep_idx}")
    os.makedirs(out_dir, exist_ok=True)

    converter = NpyToObj(args.input_path, args.sample_idx, args.rep_idx,
                         fit_config=FitConfig(iterations=args.iterations), device=device)
    converter.save_npy(os.path.join(out_dir, "smpl_params.npy"))
    for frame in range(converter.num_frames):
        converter.save_obj(os.path.join(out_dir, f"frame{frame:03d}.obj"), frame)
    print(f"wrote {converter.num_frames} obj frames to {out_dir}")
    return converter


if __name__ == "__main__":
    main()
