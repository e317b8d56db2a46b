"""forward_ms.score: device time of the port's span ``model/forward``
(``transformer.forward``, whole), in milliseconds per traced forward
(`portbench.spans`)."""
from portbench import spans


def read(r):
    return spans.device_ms(r, "score", "model/forward")
