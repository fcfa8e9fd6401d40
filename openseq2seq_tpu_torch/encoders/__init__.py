from .encoder import Encoder
from .cnn_encoder import CNNEncoder
from .ds2_encoder import DeepSpeech2Encoder
from .lm_encoders import LMEncoder
from .resnet_encoder import ResNetEncoder
from .tdnn_encoder import TDNNEncoder
from .transformer_encoder import TransformerEncoder
from .conformer_encoder import ConformerEncoder
from .rnn_encoders import (BidirectionalRNNEncoderWithEmbedding,
                           GNMTLikeEncoderWithEmbedding,
                           GNMTLikeEncoderWithEmbedding_cuDNN,
                           UnidirectionalRNNEncoderWithEmbedding)
from .tacotron2_encoder import Tacotron2Encoder
from .transformer_xl_encoder import TransformerXLEncoder
from .centaur_encoder import CentaurEncoder
from .convs2s_encoder import ConvS2SEncoder
from .wavenet_encoder import WavenetEncoder
from .las_encoder import ListenAttendSpellEncoder
from .gatedconv_encoder import GatedConvEncoder
