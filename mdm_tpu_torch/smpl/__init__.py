"""Differentiable SMPL body model and rotation->xyz decoding (counterpart of
mdm_tpu/smpl)."""
from .lbs import (  # noqa: F401
    JOINT_MAP,
    JOINT_NAMES,
    JOINT_SET_INDEXES,
    JOINTSTYPE_ROOT,
    SMPLModel,
    lbs,
)
from .rot2xyz import JOINTSTYPES, Rot2XYZConfig, rot2xyz  # noqa: F401
