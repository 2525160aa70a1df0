from repro_torch.train.loop import train
from repro_torch.train.step import (
    CompiledTrainStep,
    TrainState,
    compile_train_step,
    init_train_state,
    make_eval_step,
    make_train_step,
)

__all__ = ["CompiledTrainStep", "TrainState", "compile_train_step",
           "init_train_state", "make_eval_step", "make_train_step", "train"]
