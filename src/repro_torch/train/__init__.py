from .optimizer import AdamWConfig, AdamWState, apply_updates, init_state
from .train_step import make_train_step
