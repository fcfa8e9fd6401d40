from .decoder import Decoder
from .fc_decoders import (FullyConnectedCTCDecoder, FullyConnectedDecoder,
                          FullyConnectedSCDecoder, FullyConnectedTimeDecoder)
from .lm_decoders import FakeDecoder
from .transformer_decoder import TransformerDecoder
from .rnn_decoders import (BeamSearchRNNDecoderWithAttention,
                           RNNDecoderWithAttention)
from .tacotron2_decoder import Tacotron2Decoder
from .transducer_decoder import TransducerDecoder
from .centaur_decoder import CentaurDecoder
from .convs2s_decoder import ConvS2SDecoder
from .las_decoder import ListenAttendSpellDecoder
from .jca_decoder import JointCTCAttentionDecoder
