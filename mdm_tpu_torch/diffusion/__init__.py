from .gaussian import (  # noqa: F401
    apply_inpainting,
    extract,
    mean_flat,
    p_mean_variance,
    q_posterior_mean_variance,
    q_sample,
    sum_flat,
)
from .losses import LossConfig, masked_l2, training_losses  # noqa: F401
from .samplers import SamplerConfig, p_sample_loop  # noqa: F401
from .schedule import MeanType, Schedule, VarType, named_beta_schedule, space_timesteps  # noqa: F401
