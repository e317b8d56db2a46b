"""backward_ms.train: device time of the port's spans ``train/backward``
(``loss.backward()`` per microbatch, the blocks' recomputation included),
summed, in milliseconds per traced step (`portbench.spans`)."""
from portbench import spans


def read(r):
    return spans.device_ms(r, "train", "train/backward")
