"""Generators of the toy and LibriSpeech-shaped corpora that the speech
recipes and the tests read."""
