from .model import Model, TrainState
from .encoder_decoder import EncoderDecoderModel
from .image2label import Image2Label
from .speech2text import Speech2Text
from .text2text import Text2Text
from .lstm_lm import LSTMLM
from .text2speech import (Text2Speech, Text2SpeechCentaur,
                          Text2SpeechTacotron, Text2SpeechWavenet)
