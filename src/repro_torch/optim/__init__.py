from repro_torch.optim.optimizers import Optimizer, adam, momentum, sgd
from repro_torch.optim.schedule import constant, cosine, linear_warmup

__all__ = ["Optimizer", "adam", "momentum", "sgd",
           "constant", "cosine", "linear_warmup"]
