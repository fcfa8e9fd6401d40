from .encoder import Encoder
from .tdnn_encoder import TDNNEncoder
from .transformer_encoder import TransformerEncoder
