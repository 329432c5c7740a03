from repro_torch.train.trainer import TrainState, make_train_step, train_state_init

__all__ = ["TrainState", "make_train_step", "train_state_init"]
