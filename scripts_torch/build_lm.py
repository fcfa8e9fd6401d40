#!/usr/bin/env python
"""Build an ARPA n-gram LM from a text corpus for the beam-search
decoders, with the PyTorch port's modules (twin of
``scripts/build_lm.py``; reference `scripts/build_lm.py` +
`scripts/build_6-gram_OpenSLR_lm.sh`, which wrap KenLM; our decoders
consume ARPA directly — see native/ctc_decoder/ngram_lm.cc).

  python scripts_torch/build_lm.py --corpus=librispeech-lm-norm.txt \
      --order=4 --out=lm.arpa [--max_vocab=200000]
"""
from __future__ import annotations

import argparse
import collections
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

from openseq2seq_tpu_torch.ops.arpa_lm import build_arpa  # noqa: E402


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--corpus", required=True,
                        help="one sentence per line, whitespace tokens")
    parser.add_argument("--out", required=True)
    parser.add_argument("--order", type=int, default=3)
    parser.add_argument("--max_vocab", type=int, default=None)
    parser.add_argument("--lowercase", action="store_true")
    parser.add_argument("--binarize", default=None, metavar="OUT_BLM",
                        help="also write the mmap-able binary LM (fast "
                             "load; KenLM-binary analogue — reference "
                             "generate_trie.cpp). Accepts an output "
                             "path; requires the native decoder build.")
    args = parser.parse_args(argv)

    counts = collections.Counter()
    sentences = []
    with open(args.corpus, encoding="utf-8") as f:
        for line in f:
            if args.lowercase:
                line = line.lower()
            toks = line.split()
            if toks:
                sentences.append(toks)
                counts.update(toks)

    if args.max_vocab:
        keep = {w for w, _ in counts.most_common(args.max_vocab)}
        sentences = [[t if t in keep else "<unk>" for t in s]
                     for s in sentences]

    build_arpa(sentences, args.out, order=args.order)
    print("Wrote {}-gram ARPA LM ({} sentences, {} vocab) to {}".format(
        args.order, len(sentences), len(counts), args.out))
    if args.binarize:
        from openseq2seq_tpu_torch.ops import ctc_beam_native
        ctc_beam_native.binarize(args.out, args.binarize)
        print("Wrote binary LM (mmap format) to {}".format(args.binarize))
    return 0


if __name__ == "__main__":
    sys.exit(main())
