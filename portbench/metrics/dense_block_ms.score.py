"""dense_block_ms.score: device time of the port's spans ``model/dense_block``
(each decoder block: attention and SwiGLU with their norms), summed, in
milliseconds per traced forward (`portbench.spans`)."""
from portbench import spans


def read(r):
    return spans.device_ms(r, "score", "model/dense_block")
