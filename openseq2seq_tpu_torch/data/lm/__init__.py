from .lmdata import (Corpus, IMDBDataLayer, SSTDataLayer,
                     TextClassificationDataLayer, WKTDataLayer)
