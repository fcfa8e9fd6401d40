"""Applications built on the port's models."""
from .lm_rescorer import NeuralRescorer
from .frame_asr import FrameASR, TransducerFrameASR
