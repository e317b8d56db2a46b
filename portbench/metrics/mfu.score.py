"""mfu.score: the model FLOPs of the traced forwards
(`counts.forward_flops`) over the traced window, as a percentage of the
float32 peak (`peaks.json`; the harness runs float32 only, TF32 off) of
every chip the run used (on several, rank 0's window)."""
from portbench import counts


def read(r):
    if r.loop != "score" or not r.trace or r.peak is None:
        return None
    t = r.traffic
    flops = counts.forward_flops(r.config, t["batch"], t["seq_len"]) * r.iters
    return (100.0 * flops / r.trace["window_s"]
            / (r.chips * r.peak["f32_flops_per_s"]))
