from .loops import run_validation, style_gate, train_epoch
from .optim import build_optimizer, clip_gradients, set_lr, step_lr_schedule
from .state import TrainState
from .steps import (dann_step, images_to_float, krn_step, make_dann_train_step,
                    make_krn_eval_step, make_krn_train_step, make_spn_eval_step,
                    make_spn_train_step, make_train_step, spn_pose, spn_step)

__all__ = ["run_validation", "style_gate", "train_epoch", "build_optimizer", "clip_gradients",
           "set_lr", "step_lr_schedule", "TrainState", "dann_step", "images_to_float", "krn_step",
           "make_dann_train_step", "make_krn_eval_step", "make_krn_train_step",
           "make_spn_eval_step", "make_spn_train_step", "make_train_step", "spn_pose",
           "spn_step"]
