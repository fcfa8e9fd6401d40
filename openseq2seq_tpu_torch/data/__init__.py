from .data_layer import DataLayer
from .synthetic import (SyntheticLMDataLayer, SyntheticSpeechDataLayer,
                        SyntheticTextDataLayer,
                        SyntheticTTSDataLayer)
