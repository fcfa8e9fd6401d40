from .decoder import Decoder
from .fc_decoders import FullyConnectedTimeDecoder, FullyConnectedCTCDecoder
from .transformer_decoder import TransformerDecoder
