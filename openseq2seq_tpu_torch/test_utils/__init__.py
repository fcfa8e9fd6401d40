"""Generators of the toy, LibriSpeech-shaped and WMT-shaped corpora that
the speech and NMT recipes and the tests read."""
