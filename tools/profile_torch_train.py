#!/usr/bin/env python3
"""Where the time of the port's train step goes, on one NVIDIA GPU.

    python3 tools/profile_torch_train.py [--out build/profile_train.json]

The step of chip_smoke.py's phase 45: minicpm-2B at its published config
(f32 weights from seed 0, TF32 off), ``make_train_step(remat="full",
microbatches=2)`` on ``batches`` of 2 x 2048 tokens.  After two warm-up
steps:

1. the wall of one step (ends in a sync) and of ``adamw_update`` alone
   on the same gradients;
2. torch.profiler over one step: device busy time (the union of all
   device-activity intervals), idle share = 1 - busy / wall, the device
   time of matmul kernels (names with gemm, cutlass, xmma), of softmax
   kernels and of everything else, and the device time by kernel name.

Prints one JSON object and writes it to ``--out``.  Needs CUDA; imports
nothing of jax or of the JAX package.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

from chip_smoke import TRAIN_FWD, TRAIN_MB, card_line  # noqa: E402
from repro_torch.configs.base import get_config  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.train.data import DataConfig, batches  # noqa: E402
from repro_torch.train.optimizer import OptConfig, adamw_update  # noqa: E402
from repro_torch.train.train_step import (init_opt_state,  # noqa: E402
                                          make_train_step)

MATMUL = ("gemm", "cutlass", "xmma")


def timed(fn) -> float:
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return time.perf_counter() - t0


def kind(name: str) -> str:
    low = name.lower()
    if any(m in low for m in MATMUL):
        return "matmul"
    return "softmax" if "softmax" in low else "other"


def device_profile(fn) -> dict:
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        wall = timed(fn)
    spans = sorted((e.time_range.start, e.time_range.end, e.name)
                   for e in prof.events() if e.device_type == DeviceType.CUDA)
    if not spans:
        return {"device": "not measured (the profiler saw no device time)"}
    busy, cur_s, cur_e = 0.0, None, None
    by_name: dict = {}
    by_kind = {"matmul": 0.0, "softmax": 0.0, "other": 0.0}
    for s, e, name in spans:
        by_name[name] = by_name.get(name, 0.0) + (e - s)
        by_kind[kind(name)] += (e - s) / 1e6
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                busy += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    busy += cur_e - cur_s
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:12]
    return {"profiled_wall_s": wall, "device_busy_s": busy / 1e6,
            "device_idle_share": 1.0 - busy / 1e6 / wall,
            "device_activities": len(spans), "device_s_by_kind": by_kind,
            "top_device_s": [[n[:90], t / 1e6] for n, t in top]}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", default=str(ROOT / "build" / "profile_train.json"))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("error: needs an NVIDIA GPU", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    cfg = get_config("minicpm_2b")
    model = T.init_params(cfg, seed=0, device=dev)
    b, s = TRAIN_FWD
    data = batches(DataConfig(cfg.vocab, s, b), device=dev)
    opt = init_opt_state(model)
    step = make_train_step(cfg, OptConfig(), remat="full",
                           microbatches=TRAIN_MB)
    for _ in range(2):
        step(model, opt, next(data))
    batch = next(data)
    out = {"card": card_line(), "cell": f"minicpm-2b train step B={b} "
           f"S={s}, {TRAIN_MB} microbatches, remat full, f32",
           "step_s": timed(lambda: step(model, opt, batch)),
           "adamw_update_s": timed(lambda: adamw_update(model, opt,
                                                        OptConfig()))}
    out.update(device_profile(lambda: step(model, opt, batch)))
    text = json.dumps(out, indent=1)
    print(text)
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out).write_text(text)
    return 0


if __name__ == "__main__":
    sys.exit(main())
