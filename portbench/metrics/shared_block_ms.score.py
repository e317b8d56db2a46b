"""shared_block_ms.score: device time of the port's spans
``model/shared_block`` (the shared attention and SwiGLU block after each
group of Mamba2 layers), summed, in milliseconds per traced forward
(`portbench.spans`)."""
from portbench import spans


def read(r):
    return spans.device_ms(r, "score", "model/shared_block")
