"""device_idle.train: the percentage of the traced window in which no
operation ran on the device (1 − the union of device intervals over the
window)."""


def read(r):
    if r.loop != "train" or not r.trace or r.trace["busy_s"] <= 0:
        return None
    return 100.0 * (1.0 - r.trace["busy_s"] / r.trace["window_s"])
