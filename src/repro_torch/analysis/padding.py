"""Padding-inertness checker: noninterference by self-composition, run
eagerly (port of ``repro/analysis/padding.py``).

The masking contract (``kernels/ops.py`` docstring, ``PADDING_CONTRACT``)
says the *only* trusted padding indicator is a weight or mask of zero —
padded index slots may hold any valid id, because a sentinel like
``n_pad - 1`` can alias a real row when a dim lands exactly on its bucket.
So **the real slots of every output are a function of the real slots of
the inputs alone.**

The checker holds that per entry by self-composition: call ``fn(*args)``
on the canonical inputs, then ``fn(*perturb(args))`` with deterministic
garbage written into exactly the padding slots (the entry's `PaddingSpec`:
zero-weight edges re-aimed at random vertices, masked pins at random nets
and vertices, padding labels scrambled, the padding slots of the
tie-break draws redrawn), and require the projections onto real slots to
be **bit-identical**.  The reference evaluates its traced jaxpr twice
(``_eval_closed``); here the entry itself runs, so on CPU tensors the
plain paths are checked and on CUDA tensors (``use_kernel=None``) the
hand-written kernels — whose launch counters are read around each run and
must rise in both (``kernel-not-launched`` otherwise).
"""
from __future__ import annotations

from typing import List

import numpy as np
import torch

from repro_torch.analysis.findings import Finding
from repro_torch.analysis.tracing import launch_counts

_SEED = 0xA11A


def _run(fn, args, names, cuda: bool):
    before = launch_counts(names)
    out = fn(*args)
    if cuda:
        torch.cuda.synchronize()
    after = launch_counts(names)
    return out, {n: after[n] - before[n] for n in names}


def check_padding(entry, device) -> List[Finding]:
    if entry.padding is None:
        return []
    fn, args = entry.build(device)
    cuda = torch.device(device).type == "cuda"
    rng = np.random.default_rng(_SEED)
    perturbed = entry.padding.perturb(args, rng)
    if len(perturbed) != len(args):
        return [Finding(
            checker="padding", severity="error", entry=entry.name,
            code="bad-perturbation", location="spec",
            message=f"{entry.name}: PaddingSpec.perturb changed the "
                    f"argument count ({len(args)} -> {len(perturbed)})")]
    out_a, la = _run(fn, args, entry.kernels, cuda)
    out_b, lb = _run(fn, perturbed, entry.kernels, cuda)
    findings: List[Finding] = []
    if cuda:
        for name in entry.kernels:
            if min(la[name], lb[name]) <= 0:
                findings.append(Finding(
                    checker="padding", severity="error", entry=entry.name,
                    code="kernel-not-launched", location=name,
                    message=f"{entry.name}: the padding runs on the card "
                            f"launched {name} {la[name]:g} and {lb[name]:g} "
                            f"times — the kernel was not checked"))
    proj_a = entry.padding.project(out_a)
    proj_b = entry.padding.project(out_b)
    for i, (a, b) in enumerate(zip(proj_a, proj_b)):
        a, b = np.asarray(a), np.asarray(b)
        if a.shape != b.shape or not np.array_equal(a, b):
            diff = (int(np.count_nonzero(a != b))
                    if a.shape == b.shape else -1)
            findings.append(Finding(
                checker="padding", severity="error", entry=entry.name,
                code="padding-flows-into-output",
                location=f"output[{i}]",
                message=f"{entry.name}: garbage in padding slots changed "
                        f"real output {i} ({diff} differing elements) — "
                        f"padding leaked into accepted moves, objective "
                        f"values, or balance totals",
                detail={"output": i, "differing": diff}))
    return findings
