"""Plain PyTorch references of the benchmark's model families.

Each family module gives ``spec(cfg)`` (the weights' layout: group, dotted
name, shape, init), ``forward(w, cfg, tokens, remat=False)`` → logits
over the padded vocabulary, and ``no_decay(cfg)``, the leaves AdamW does
not decay.  They import nothing of the port and take nothing it made.
"""
