"""mamba_ms.score: device time of the port's spans ``model/mamba_layer`` (each
Mamba2 layer: its norm, the mixer and the SSD scan), summed, in milliseconds
per traced forward (`portbench.spans`)."""
from portbench import spans


def read(r):
    return spans.device_ms(r, "score", "model/mamba_layer")
