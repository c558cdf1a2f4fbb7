from streammos_tpu_torch.train.checkpoint import (graft_params, latest_epoch,
                                                 load_model_state, restore,
                                                 save)
from streammos_tpu_torch.train.optim import (Optimizer, TSEnsemble,
                                             apply_updates, build_optimizer,
                                             build_schedule, freeze_mask,
                                             global_norm)
from streammos_tpu_torch.train.trainer import (TrainState, build_train_model,
                                               create_train_state,
                                               make_eval_step, make_train_step)

__all__ = [
    "Optimizer",
    "TSEnsemble",
    "TrainState",
    "apply_updates",
    "build_optimizer",
    "build_schedule",
    "build_train_model",
    "create_train_state",
    "freeze_mask",
    "global_norm",
    "graft_params",
    "latest_epoch",
    "load_model_state",
    "make_eval_step",
    "make_train_step",
    "restore",
    "save",
]
