"""ssd_scan_roofline: the least time of the traced forwards' Mamba2 scan
calls (`counts.ssd_scan_least_s` at the call's shape, one call per Mamba2
layer) over the device time of their launches (kernels whose names hold
"ssd"), as a percentage.  Nothing to read where no such kernel ran."""
from portbench import counts


def read(r):
    if r.loop != "score" or r.config["family"] != "hybrid" or not r.trace \
            or r.peak is None:
        return None
    spent = sum(v for k, v in r.trace["device_s_by_name"].items()
                if "ssd" in k.lower())
    if spent <= 0:
        return None
    c, rows = r.config, r.traffic["batch"]
    heads = c["ssm_expand"] * c["d_model"] // c["ssm_head_dim"]
    least, _ = counts.ssd_scan_least_s(rows * heads, r.traffic["seq_len"],
                                       c["ssm_head_dim"], c["ssm_state"],
                                       rows, r.peak)
    return 100.0 * least * c["n_layers"] * r.iters / spent
