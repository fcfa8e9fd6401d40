from .decoder import Decoder
from .fc_decoders import FullyConnectedTimeDecoder, FullyConnectedCTCDecoder
