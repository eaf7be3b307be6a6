from .gaussian import (  # noqa: F401
    apply_inpainting,
    extract,
    p_mean_variance,
    q_posterior_mean_variance,
    q_sample,
)
from .samplers import SamplerConfig, p_sample_loop  # noqa: F401
from .schedule import MeanType, Schedule, VarType, named_beta_schedule, space_timesteps  # noqa: F401
