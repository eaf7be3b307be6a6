"""Training on one device or data-parallel: the train step, AdamW + EMA
state, the loop, checkpoints and goal conditioning (counterpart of
mdm_tpu/train)."""
from .checkpoints import (  # noqa: F401
    find_resume_checkpoint,
    load_args,
    restore_checkpoint,
    restore_params_only,
    restore_pytree_numpy,
    save_args,
    save_checkpoint,
)
from .goal_cond import (  # noqa: F401
    goal_cond_modifier,
    make_target_cond_fn,
    make_target_loss_builder,
)
from .loop import LoopConfig, TrainLoop  # noqa: F401
from .state import (  # noqa: F401
    OptimConfig,
    TrainState,
    apply_gradients,
    create_train_state,
    make_optimizer,
)
from .train_step import TrainStepConfig, make_train_step, quartile_metrics, step_key  # noqa: F401
