"""The port's operations: the hand-written kernels' wrappers and their
plain versions, their bounds, and the host featurizer (``features``),
each imported by its module so that the speech data layer's featurizer
processes, which import ``features``, import no torch."""
