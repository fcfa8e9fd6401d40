from .data_layer import DataLayer
from .synthetic import SyntheticSpeechDataLayer, SyntheticTextDataLayer
