from .trainer import evaluate, infer, restore_state
from .checkpoint import CheckpointManager
