"""forward_ms.train: device time of the port's spans ``train/forward``
(``next_token_loss``, once per microbatch), summed, in milliseconds per
traced step (`portbench.spans`)."""
from portbench import spans


def read(r):
    return spans.device_ms(r, "train", "train/forward")
