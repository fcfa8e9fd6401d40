from .mixed_precision import MixedPrecisionPolicy, get_mp_policy
from .loss_scaler import AutomaticLossScaler, check_grads
from .optimizers import build_optimizer, get_lr_schedule_from_config
