"""Training and serving steps of the port."""
from repro_torch.train.loop import (TrainState, cross_entropy_loss,
                                    init_state, make_train_step, train_step)
