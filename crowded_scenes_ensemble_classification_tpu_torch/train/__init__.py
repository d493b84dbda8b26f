"""Training: the steps, the epoch loop, the Keras optimizers, callbacks and
checkpoints (counterpart of the JAX package's `train/`, without the
multi-member and wire-fed steps)."""

from .callbacks import (  # noqa: F401
    EarlyStopping,
    LRPolicy,
    ReduceLROnPlateau,
    StepDecayEvery4,
    lr_policy_for,
)
from .checkpoints import (  # noqa: F401
    best_exists,
    full_exists,
    restore_best,
    restore_full,
    save_best,
    save_full,
)
from .engine import (  # noqa: F401
    evaluate_model,
    fit,
    make_eval_step,
    make_resident_eval_step,
    make_resident_train_step,
    make_train_step,
    store_history,
)
from .state import (  # noqa: F401
    TrainState,
    get_learning_rate,
    keras_adam,
    keras_sgd,
    make_optimizer,
    set_learning_rate,
)
