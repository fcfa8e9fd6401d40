from .encoder import Encoder
from .tdnn_encoder import TDNNEncoder
