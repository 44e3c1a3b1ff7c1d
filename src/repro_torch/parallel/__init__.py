"""Sharding rules and the activation-sharding context of the port (rules
only: executing them across cards waits for DTensor)."""
from repro_torch.parallel.sharding import (batch_sharding, cache_shardings,
                                           data_axes, param_shardings,
                                           state_shardings)
