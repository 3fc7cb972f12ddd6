from repro_torch.models.simple import (SimpleConfig, SimpleModel,
                                       params_from_numpy, params_to_numpy)

__all__ = ["SimpleConfig", "SimpleModel", "params_from_numpy",
           "params_to_numpy"]
