"""Serving: ``torch.export`` artifacts of a model's forward, with int8
weights and int8 activations (port of ``openseq2seq_tpu/serving``).

Importing this package registers the custom op through which an
artifact launches the flash attention kernel, and imports no model code:
a reloaded artifact needs nothing else."""
from .export import export_inference_fn, load_exported
from .quantize import (quantize_params_int8, dequantize_params,
                       export_inference_fn_int8, load_exported_int8,
                       calibrate_activations)
from .int8_exec import (calibrate_dense_inputs, int8_apply_fn,
                        make_int8_interceptor)
