"""repro_torch.train — the optimizer, its schedule and the train-step
factory (the port of ``repro.train``)."""
from .optimizer import (AdamWConfig, adamw_init, adamw_update,
                        clip_by_global_norm, warmup_cosine)
from .step import (TrainState, make_eval_step, make_init_fn,
                   make_train_step)

__all__ = ["AdamWConfig", "adamw_init", "adamw_update",
           "clip_by_global_norm", "warmup_cosine",
           "TrainState", "make_eval_step", "make_init_fn",
           "make_train_step"]
