"""Cells of the benchmark cut to a size the CPU tests run in a second: the
configuration at the port's ``reduced()`` sizes (same family and wiring,
tiny widths), short sequences and a small pool."""
from __future__ import annotations

import dataclasses

from portbench import spec

ARCH = {"hybrid-mamba2-2.3b": "zamba2_2p7b", "minicpm-2b": "minicpm_2b"}


def tiny_cell(name: str) -> spec.Cell:
    from repro_torch.configs.base import get_config
    cell = spec.resolve(name)
    small = dataclasses.asdict(get_config(ARCH[cell.config["name"]]).reduced())
    cfg = {k: (small[k] if k in small and k not in ("name", "source") else v)
           for k, v in cell.config.items()}
    tr = dict(cell.traffic, pool=4, seq_len=32)
    return dataclasses.replace(cell, config=cfg, traffic=tr)
