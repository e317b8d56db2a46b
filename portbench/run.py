#!/usr/bin/env python3
"""Run one cell of the port's benchmark on the GPUs of this machine.

    python portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout.  Prints, as the last line of standard
output, one JSON object: ``correct``, ``attempted``, ``failed``,
``metrics`` (the cell's end-to-end metrics, or with ``--trace 1`` its
per-layer metrics), ``device``, with ``--trace 1`` ``breakdown``, and last
``checks``, each number ``correct`` compared beside its limit (also the
last lines of standard error).  Exits non-zero with no result line
without enough CUDA devices, and if JAX or the JAX package was loaded.

A cell of one chip runs in this process on ``cuda:0``.  A cell of several
chips runs as one process per card (``ranks.py``), which meet in
``build/portbench/ranks/``; this process hands on rank 0's result line
and errors when every rank has exited 0.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def caches_inside(root: Path) -> None:
    """Every build and kernel cache at a fixed path inside the checkout (the
    port's nvcc builds are under build/kernels/ there already)."""
    base = root / "build" / "portbench"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(base / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(base / "triton")


def loaded_forbidden() -> list:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args()
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    caches_inside(ROOT)
    from portbench import spec
    cell = spec.resolve(args.workload)
    import torch
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"error: {args.workload} needs {cell.chips} CUDA device(s); "
              f"this machine has "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    if cell.chips > 1:
        return several(cell, args)
    from portbench import harness
    result = harness.run_cell(cell, args.seed, args.seconds, bool(args.trace),
                              "cuda:0", T_START)
    found = loaded_forbidden()
    if found:
        print(f"error: these modules were loaded: {found}", file=sys.stderr)
        return 3
    sys.stdout.flush()
    print("\n".join(harness.check_lines(result)), file=sys.stderr, flush=True)
    print(json.dumps(result), flush=True)
    return 0


def several(cell, args) -> int:
    """Run ``cell`` as one rank per card and hand on rank 0's result."""
    import signal
    from portbench import ranks

    def stop(signum, frame):            # end the ranks on the way out
        sys.exit(128 + signum)
    signal.signal(signal.SIGTERM, stop)
    codes, out, err = ranks.launch(cell, args.seed, args.seconds,
                                   bool(args.trace), "cuda", T_START,
                                   ROOT / "build" / "portbench" / "ranks")
    found = loaded_forbidden()
    if found:
        err += f"error: these modules were loaded: {found}\n"
    sys.stderr.write(err)
    sys.stderr.flush()
    if any(codes) or found:
        return 3
    sys.stdout.write(out)
    sys.stdout.flush()
    return 0


if __name__ == "__main__":
    sys.exit(main())
