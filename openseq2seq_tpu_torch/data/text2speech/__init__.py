from .text2speech import Text2SpeechDataLayer
from .text2speech_wavenet import WavenetDataLayer
