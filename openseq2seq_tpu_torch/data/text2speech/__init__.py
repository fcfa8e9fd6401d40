from .text2speech import Text2SpeechDataLayer
