"""The port's ``NeuralRescorer`` against the JAX package's, each restoring
its own checkpoint of the same weights, with the LSTM LM of
``example_configs_torch/lm/lstm_toy.py`` and the Transformer-XL of
``txl_tiny.py`` on the cycle corpus: the LM score of each hypothesis
(next-token log-probabilities under the length mask) and the hypothesis
each n-best list chooses, over lengths that pad the batch.

Tolerance: fp32, rtol 1e-5 and atol 1e-5 on the scores (sums of a dozen
log-softmax terms); the choices exact."""
import os
import runpy

import jax
import numpy as np
import pytest

from openseq2seq_tpu.apps.lm_rescorer import NeuralRescorer as JaxRescorer
from openseq2seq_tpu.data.lm import WKTDataLayer as JaxWKT
from openseq2seq_tpu.decoders import FakeDecoder as JaxFakeDecoder
from openseq2seq_tpu.encoders import LMEncoder as JaxLMEncoder
from openseq2seq_tpu.encoders import TransformerXLEncoder as JaxTXL
from openseq2seq_tpu.losses import BasicSequenceLoss as JaxSequenceLoss
from openseq2seq_tpu.models import LSTMLM as JaxLSTMLM
from openseq2seq_tpu.training.checkpoint import \
    CheckpointManager as JaxCheckpointManager
from openseq2seq_tpu_torch.apps import NeuralRescorer
from openseq2seq_tpu_torch.convert import state_dict_from_flax
from openseq2seq_tpu_torch.training import CheckpointManager
from jax_global_state import jax_globals, jax_globals_module  # noqa: F401
from test_torch_text_data import one_thread  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIGS = {"lstm": os.path.join(REPO, "example_configs_torch", "lm",
                                "lstm_toy.py"),
           "txl": os.path.join(REPO, "example_configs_torch", "lm",
                               "txl_tiny.py")}
TEXTS = ["aa bb cc dd", "aa dd bb cc", "ee ff", "gg hh aa bb cc dd ee ff",
         "bb", "qq aa bb"]
NBEST = [[(-1.0, "aa dd bb cc"), (-1.2, "aa bb cc dd"), (-3.0, "dd")],
         [(-0.5, "ee ff gg"), (-0.4, "ee gg ff")], [(0.0, "hh")]]


@pytest.mark.parametrize("lm", ["lstm", "txl"])
def test_rescorer_matches_jax(lm, tmp_path):
    config = runpy.run_path(CONFIGS[lm])
    params = dict(config["base_params"], logdir="")
    params["data_layer_params"] = dict(
        params["data_layer_params"],
        processed_data_folder=str(tmp_path / "processed"))
    jparams = dict(params, encoder=JaxTXL if lm == "txl" else JaxLMEncoder,
                   decoder=JaxFakeDecoder, loss=JaxSequenceLoss,
                   data_layer=JaxWKT)
    jmodel = JaxLSTMLM(jparams, mode="eval")
    batch = next(iter(jmodel.get_data_layer().iterate_one_epoch()))
    jstate = jmodel.init_state(batch)
    weights = jax.tree_util.tree_map(
        lambda a: (0.5 * np.random.RandomState(a.size).randn(*a.shape))
        .astype(np.float32), jax.device_get(jstate.params))
    JaxCheckpointManager(str(tmp_path / "jax")).save(
        jstate.replace(params=weights), 3)
    model = config["base_model"](params, mode="eval", device="cpu")
    state = model.init_state(batch)
    state.module.load_state_dict(state_dict_from_flax({"params": weights}))
    path = CheckpointManager(str(tmp_path / "port")).save(state, 3)

    jrescorer = JaxRescorer(JaxLSTMLM(jparams, mode="eval"),
                            str(tmp_path / "jax" / "checkpoints" / "3"))
    rescorer = NeuralRescorer(
        config["base_model"](params, mode="eval", device="cpu"), path)
    want = np.asarray(jrescorer.lm_scores(TEXTS))
    got = rescorer.lm_scores(TEXTS)
    assert got.shape == (len(TEXTS),) and np.all(got < 0)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    for weight in (0.0, 0.5, 5.0):
        assert rescorer.rescore(NBEST, lm_weight=weight, word_bonus=0.1) \
            == jrescorer.rescore(NBEST, lm_weight=weight, word_bonus=0.1)
    assert rescorer.rescore(NBEST, lm_weight=0.0) == \
        ["aa dd bb cc", "ee gg ff", "hh"]
