from .loss import Loss
from .ctc_loss import CTCLoss
