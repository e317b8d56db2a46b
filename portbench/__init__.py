"""portbench: the benchmark of the PyTorch and CUDA port (``repro_torch``)
on NVIDIA GPUs.

``python portbench/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json`` and prints one JSON
result line.  Everything that belongs to one configuration, one traffic
mix or one per-layer metric lives in a file of its own, found by name:

    configs/<config>.json      published sizes, source, reduced, assumed
    traffic/<mix>.json         batch, lengths, the loop that drives them
    limits/<cell>.json         the limit of each number ``correct`` compares
    loops/<loop>.py            one general driver per loop type
    metrics/<metric>.py        one reader per per-layer metric
    reference/<family>.py      weights layout and plain PyTorch forward

``sut.py`` is the one module that imports the port.  A cell of several
chips runs as one process per card (``ranks.py``) on the mesh its traffic
names.
"""
