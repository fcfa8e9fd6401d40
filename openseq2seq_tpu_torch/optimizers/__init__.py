from .mixed_precision import MixedPrecisionPolicy, get_mp_policy
