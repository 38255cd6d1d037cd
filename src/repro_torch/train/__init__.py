"""Training of the port (the JAX package's ``repro.train``): AdamW, the
chunked-CE train step, checkpoints with an AirIndex manifest, and the
fault-tolerant supervisor.  ``compression`` (a cross-pod collective) is
not ported yet (ROADMAP.md, queue 1)."""
from .optimizer import AdamWConfig, adamw_init, adamw_update, opt_state_specs
from .train_step import TrainConfig, loss_fn, make_train_step

__all__ = ["AdamWConfig", "TrainConfig", "adamw_init", "adamw_update",
           "loss_fn", "make_train_step", "opt_state_specs"]
