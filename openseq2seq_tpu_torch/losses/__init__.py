from .loss import Loss
from .ctc_loss import CTCLoss
from .cross_entropy_loss import CrossEntropyLoss
from .sequence_loss import (BasicSampledSequenceLoss, BasicSequenceLoss,
                            CrossEntropyWithSmoothing,
                            PaddedCrossEntropyLossWithSmoothing)
from .text2speech_loss import Text2SpeechLoss
from .transducer_loss import TransducerLoss
from .wavenet_loss import WavenetLoss
from .jca_loss import MultiTaskCTCEntropyLoss
