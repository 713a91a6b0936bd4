from .losses import LossConfig, compute_loss
from .optim import Optimizer, OptState, make_optimizer
from .schedules import pe_progress, schedule_mult, schedule_phase
from .state import (
    PoseTables,
    RayStore,
    SceneConstants,
    TrainState,
    UPNeRF,
    init_params,
    init_pose_params,
    make_ray_store,
    make_scene_constants,
    make_train_state,
)
from .step import StepConfig, make_eval_render, make_train_step

__all__ = [
    "LossConfig", "OptState", "Optimizer", "PoseTables", "RayStore", "SceneConstants", "StepConfig", "TrainState",
    "UPNeRF", "compute_loss", "init_params", "init_pose_params", "make_optimizer", "make_ray_store",
    "make_eval_render", "make_scene_constants", "make_train_state", "make_train_step", "pe_progress", "schedule_mult", "schedule_phase",
]
