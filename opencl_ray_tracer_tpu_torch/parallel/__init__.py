"""Long renders: the sample-accumulation checkpoint and resume."""

from .checkpoint import load_state, render_checkpointed, save_state

__all__ = ["render_checkpointed", "save_state", "load_state"]
