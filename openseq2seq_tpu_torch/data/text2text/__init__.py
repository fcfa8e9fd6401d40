"""The text data layers (the port's copy of
``openseq2seq_tpu/data/text2text/``)."""
from .text2text import ParallelTextDataLayer, SpecialTextTokens
from .text2text import TransformerDataLayer
from .tokenizer import Subtokenizer
from .wordpiece import WordpieceSubtokenizer
