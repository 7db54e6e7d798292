from .optim import adam  # noqa: F401
from .state import TrainState, create_train_state, punet_l2_reg  # noqa: F401
from .steps import (  # noqa: F401
    make_mean_teacher_step,
    make_mean_teacher_val_step,
    make_punet_val_step,
    make_supervised_punet_step,
)
