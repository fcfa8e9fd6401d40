from .ctc import ctc_loss, ctc_greedy_decode
from .ctc_cuda import ctc_loss_cuda
