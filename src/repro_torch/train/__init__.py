"""Training (port of ``repro/train``): the next-token loss and train step,
AdamW with the WSD schedule, the data streams, checkpoint/restart, the
fault-tolerant loop and pipeline-stage assignment by kaffpa."""
