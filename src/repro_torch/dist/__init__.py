"""Multi-device sharding rules of the port (the JAX package's
``repro.dist``), over ``torch.distributed`` meshes."""
from .sharding import (batch_sharding, constrain_residual,
                       decode_state_shardings, param_shardings, replicated,
                       set_activation_mesh)

__all__ = ["batch_sharding", "constrain_residual", "decode_state_shardings",
           "param_shardings", "replicated", "set_activation_mesh"]
