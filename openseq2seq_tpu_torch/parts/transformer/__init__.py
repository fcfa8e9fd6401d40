"""Transformer parts (port of ``openseq2seq_tpu/parts/transformer``)."""
