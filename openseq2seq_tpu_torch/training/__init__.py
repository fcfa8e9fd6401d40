from .trainer import evaluate, infer, restore_state, train
from .checkpoint import CheckpointManager
