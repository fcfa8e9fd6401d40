"""Jasper-10x5's LibriSpeech recipe (``jasper10x5_librispeech.py``) in
infer with the CTC prefix beam on the card, for the PyTorch port: the
value commented in ``example_configs/speech2text/conformer_LibriSpeech.py``
(``on_device_beam_width`` 16, ``on_device_fusion`` with a character
3-gram LM and ``alpha`` 0.5), so that infer decodes in the step with no
host round trip (``ops/ctc_beam_device.py``).

The LM is ``CHAR_LM`` (default ``<LIBRISPEECH_DIR>/char.arpa``), an ARPA
over the 28 characters, as ``ops/ngram_fusion.build_label_lm`` writes it
from transcripts.

  LIBRISPEECH_DIR=<dir> python -m openseq2seq_tpu_torch.run --mode=infer \\
      --config_file=example_configs_torch/speech2text/jasper10x5_beam_librispeech.py \\
      --infer_output_file=out.csv
"""
import copy
import os
import runpy

_JASPER = runpy.run_path(os.path.join(os.path.dirname(os.path.abspath(
    __file__)), "jasper10x5_librispeech.py"))
_DATA = os.environ.get("LIBRISPEECH_DIR", "/data/librispeech")

base_model = _JASPER["base_model"]
base_params = copy.deepcopy(_JASPER["base_params"])
train_params = copy.deepcopy(_JASPER["train_params"])
eval_params = copy.deepcopy(_JASPER["eval_params"])
infer_params = copy.deepcopy(_JASPER["infer_params"])
infer_params["decoder_params"] = {
    "on_device_beam_width": 16,
    "on_device_fusion": {
        "lm_path": os.environ.get("CHAR_LM",
                                  os.path.join(_DATA, "char.arpa")),
        "alpha": 0.5,
    },
}
