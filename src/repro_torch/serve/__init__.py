"""Serving (port of ``repro/serve``): prefill/decode steps and the
continuous batcher."""
