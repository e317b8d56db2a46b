"""Training on the PyTorch/CUDA port: train a scaled minicpm (~100M
parameters at --dim 512) for a few hundred steps with checkpoint/restart
and the straggler watchdog.

    PYTHONPATH=src python examples/train_lm_torch.py [--cpu] [--steps 200] [--dim 512]

Runs on the GPU unless ``--cpu`` is given (then shrink it, e.g.
``--steps 4 --dim 64 --layers 2 --seq 16 --batch 2``).
"""
import argparse
import dataclasses
import os
import tempfile
import time

from repro_torch.configs.base import get_config
from repro_torch.models import transformer as T
from repro_torch.train.data import DataConfig, batches
from repro_torch.train.fault import run_resilient
from repro_torch.train.optimizer import OptConfig
from repro_torch.train.train_step import init_opt_state, make_train_step


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--cpu", action="store_true", help="run on the CPU")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--dim", type=int, default=512)
    ap.add_argument("--layers", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--ckpt", default=os.path.join(tempfile.gettempdir(),
                                                   "repro_torch_train_ckpt"))
    ap.add_argument("--fail-at", type=int, default=None,
                    help="inject a failure at this step (recovery demo)")
    args = ap.parse_args()
    dev = "cpu" if args.cpu else "cuda"

    cfg = dataclasses.replace(
        get_config("minicpm_2b"),
        n_layers=args.layers, d_model=args.dim,
        n_heads=max(1, args.dim // 64), n_kv_heads=max(1, args.dim // 64),
        d_ff=4 * args.dim, vocab=8192)
    n = cfg.param_count()
    print(f"model: {n/1e6:.1f}M params, {cfg.n_layers}L d={cfg.d_model}")

    model = T.init_params(cfg, 0, device=dev)
    warmup = max(1, min(20, args.steps // 4))
    decay = max(1, min(40, args.steps // 4))
    opt_cfg = OptConfig(peak_lr=3e-4, warmup_steps=warmup,
                        stable_steps=max(0, args.steps - warmup - decay),
                        decay_steps=decay)
    step_fn = make_train_step(cfg, opt_cfg, remat="full")
    opt = init_opt_state(model)
    dc = DataConfig(vocab=cfg.vocab, seq_len=args.seq,
                    global_batch=args.batch)

    def data_fn(start):
        return batches(dc, start_step=start, device=dev)

    t0 = time.time()

    def log(msg):
        print(f"[{time.time() - t0:7.1f}s] {msg}", flush=True)

    model, opt, info = run_resilient(
        step_fn, model, opt, data_fn, args.steps, args.ckpt,
        ckpt_every=50, fail_at=args.fail_at, log=log)
    print(f"done: {info}")


if __name__ == "__main__":
    main()
