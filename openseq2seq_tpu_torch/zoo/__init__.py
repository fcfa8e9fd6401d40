from .jasper import jasper_convnet_layers, jasper_model_params
