from .rcnn import GeneralizedRCNN
from .rcnn_uwsod import MRRPUWSODRCNN, UWSODRCNN
from .rcnn_wsl import MultiInputRCNN
from .rcnn_wsl_single import GeneralizedRCNNWSL

__all__ = ["GeneralizedRCNN", "MRRPUWSODRCNN", "UWSODRCNN", "MultiInputRCNN",
           "GeneralizedRCNNWSL"]
