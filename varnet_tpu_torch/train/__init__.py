from .loss import make_loss_fn
from .optim import OptimizerConfig, make_optimizer
from .trainer import TrainResult, make_train_step
