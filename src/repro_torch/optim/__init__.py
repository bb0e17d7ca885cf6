from .adam import AdamConfig, adam_update, global_norm, init_opt_state, lr_at

__all__ = ["AdamConfig", "adam_update", "global_norm", "init_opt_state",
           "lr_at"]
