from .data_layer import DataLayer
from .synthetic import (SyntheticImageDataLayer, SyntheticLMDataLayer,
                        SyntheticSpeechDataLayer,
                        SyntheticTextDataLayer,
                        SyntheticTTSDataLayer)
