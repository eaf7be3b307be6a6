from .gaussian import (  # noqa: F401
    apply_inpainting,
    condition_mean,
    condition_score,
    extract,
    mean_flat,
    p_mean_variance,
    predict_eps_from_xstart,
    predict_xstart_from_eps,
    predict_xstart_from_xprev,
    q_mean_variance,
    q_posterior_mean_variance,
    q_sample,
    sum_flat,
)
from .losses import LossConfig, masked_l2, training_losses  # noqa: F401
from .samplers import (  # noqa: F401
    SAMPLERS,
    SamplerConfig,
    ddim_reverse_sample_loop,
    ddim_sample_loop,
    dpmpp_2m_sample_loop,
    p_sample_loop,
    plms_sample_loop,
)
from .schedule import MeanType, Schedule, VarType, named_beta_schedule, space_timesteps  # noqa: F401
