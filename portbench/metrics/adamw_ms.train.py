"""adamw_ms.train: device time of the port's span ``train/adamw_update``
(``adamw_update``, the clip included), in milliseconds per traced step
(`portbench.spans`)."""
from portbench import spans


def read(r):
    return spans.device_ms(r, "train", "train/adamw_update")
