"""head_ms.score: device time of the port's span ``model/head`` (the final
norm, the tied head's product, the gather and the softcap), in milliseconds
per traced forward (`portbench.spans`)."""
from portbench import spans


def read(r):
    return spans.device_ms(r, "score", "model/head")
