from .image2label import (CifarDataLayer, ImagenetDataLayer,
                          ImagenetTFRecordDataLayer)
