"""gemm_ms.train: the device time of the matrix-product kernels (names with
gemm, cutlass or xmma) per traced step, in milliseconds."""
from portbench import trace


def read(r):
    if r.loop != "train" or not r.trace or not r.iters:
        return None
    s = sum(v for k, v in r.trace["device_s_by_name"].items()
            if trace.is_matmul(k))
    return 1e3 * s / r.iters if s > 0 else None
