"""Dry run of every (arch × shape × mesh) cell, shapes only (port of
``repro/launch/dryrun.py``).

The reference lowers and compiles each cell's step on 512 fake jax
devices and reads XLA's ``memory_analysis``, ``cost_analysis`` and the
collectives of the compiled HLO.  Torch compiles nothing, so the port
*runs* the cell's step once per rank layout, under ``FakeTensorMode``:
every tensor has a shape, a dtype and a device, and no storage, so
nothing is computed and nothing is allocated.

  * The rank is a stand-in mesh (`RankStandIn`): rank 0 of the given
    extents, a `core.mesh.Mesh` whose collectives return fake tensors of
    the shapes a real group would return and count calls and operand
    bytes per kind and per group size, exactly where the real ``mesh/*``
    counters count (`core/mesh.py`) — the counterpart of
    ``parse_collectives`` on the HLO.
  * The model is ``init_params(cfg, 0, dtype, mesh=rank)``: the rank's
    blocks (`shardings.rank_block`).  Its caches come from
    ``init_caches(..., mesh=rank)`` and its batch holds the rank's rows.
  * The step is the port's own: ``make_train_step`` (AdamW, the cell's
    remat and microbatches), ``prefill_step`` or ``decode_step``, under
    ``shardings.use_mesh(rank)``.  A `LiveBytes` dispatch mode follows
    the fake tensors' storages made during the step and keeps the peak of
    their live bytes (gradients and saved activations included): the
    counterpart of ``memory_analysis``'s temp bytes.  FLOPs come from
    ``torch.utils.flop_counter.FlopCounterMode``.

Depth is extrapolated as the reference's ``corrected_costs`` does, from a
1-unit and a 2-unit variant: F1 + (trips − 1)·(F2 − F1), applied to the
FLOPs, the activation peak and the collective counts and bytes (the
hybrid's unit is ``attn_every`` layers, gemma2's a local/global pair;
whisper's encoder gets a third variant).  Parameter, optimizer and cache
bytes are exact at full depth (shapes only).  The hybrid and ssm families
prefill token by token (`serve/serve_step.py`): one token step is run and
its FLOPs and collectives multiplied by the prompt length, which the
cell's JSON records (``token_steps``).

Bytes are reported at bf16 (the reference's ``PARAM_DTYPE`` and
``CACHE_DTYPE``) and at f32, the dtype of the port's records; AdamW's
moments are f32 in both (``train/optimizer.adamw_init``).  The activation
peak is measured at each dtype where the step runs at it.  Whether a
rank's total fits one card is asked against one H100's 80 GB; the TPU
constants of the reference are not carried over.

A data-dependent read on the host (``.item()``, ``int(t)``) cannot run
on a fake tensor: a cell whose step makes one is written with the error
(``errors``), never skipped silently.

Usage::

    python -m repro_torch.launch.dryrun --arch gemma2_9b --shape train_4k \\
        --mesh 2x2
    python -m repro_torch.launch.dryrun --all [--mesh single|multi|both|DxM]

``--mesh`` takes the reference's ``single`` (data 16, model 16) and
``multi`` (pod 2, data 16, model 16) layouts (`launch.mesh.
production_layout`) and ``DxM``, a (data, model) layout such as ``1x4``
or ``2x2`` (those the port's records run on 1 and 4 H100s).  Each cell
writes ``<out>/<arch>__<shape>__<mesh>[__<tag>].json`` and is skipped when
the file exists; ``--all`` runs each cell in a subprocess of its own
unless ``--inline``.  ``--fit a,b`` prints the depths of those archs whose
parameters fit (data 1, model 4) and (data 2, model 2) (`depth_table`).
Everything runs on the CPU.  The reference's ``--donate`` has no
counterpart: the port's steps update their parameters, moments and caches
in place, so there is no buffer to donate.
"""
from __future__ import annotations

import argparse
import collections
import dataclasses
import json
import math
import os
import subprocess
import sys
import time
import weakref
from typing import Dict, Optional, Sequence, Tuple

import torch

from repro_torch.core.mesh import (ALL_GATHER, ALL_REDUCE, ALL_TO_ALL,
                                   PPERMUTE, REDUCE_SCATTER, Mesh)

#: one NVIDIA H100 SXM (data sheet, dense rates, at its 700 W limit): the
#: memory a rank's total is held to, the FLOP/s of each dtype's matmuls
CARD = "NVIDIA H100 80GB HBM3"
CARD_BYTES = 80e9
PEAK_FLOPS = {"f32": 67e12, "bf16": 989e12}
#: what a serving depth leaves free per card (tools/serve_torch_sharded.py)
FREE_BYTES = 15e9
DTYPES = {"bf16": torch.bfloat16, "f32": torch.float32}
KINDS = (ALL_REDUCE, ALL_GATHER, REDUCE_SCATTER, ALL_TO_ALL, PPERMUTE)


# ---------------------------------------------------------------------------
# the stand-in rank
# ---------------------------------------------------------------------------

class RankStandIn(Mesh):
    """Rank ``rank`` (default 0) of a mesh of ``sizes`` over ``axes``,
    with no process group: what `shardings.tp_block`/`rank_block` read
    (every rank's blocks have one size), and collectives that return
    tensors of the shapes a real group's would and count each call where
    a `Mesh` with a group counts it (``calls``, per kind; ``by_group``,
    per kind and group size, with the operand bytes)."""

    def __init__(self, axes: Sequence[str], sizes: Sequence[int],
                 rank: int = 0, device="cpu"):
        self.axis_names = tuple(axes)
        self.shape = tuple(int(s) for s in sizes)
        self.size = int(math.prod(self.shape))
        self.rank = rank
        self.device = torch.device(device)
        self.group = None
        self._groups = {a: None for a in self.axis_names}
        self._ranks = list(range(self.size))
        self.reset()

    def reset(self) -> None:
        self.calls: Dict[str, int] = collections.Counter()
        self.by_group: Dict[str, list] = {}

    def counts(self) -> dict:
        """{"calls": {kind: n}, "bytes": {kind: operand bytes},
        "by_group": {"kind:gN": [calls, bytes]}}."""
        nbytes = collections.Counter()
        for key, (_, b) in self.by_group.items():
            nbytes[key.split(":")[0]] += b
        return {"calls": {k: int(self.calls[k]) for k in KINDS},
                "bytes": {k: int(nbytes[k]) for k in KINDS},
                "by_group": {k: list(v) for k, v in
                             sorted(self.by_group.items())}}

    def _count(self, kind: str, x: torch.Tensor, n: int) -> None:
        self.calls[kind] += 1
        ent = self.by_group.setdefault(f"{kind}:g{n}", [0, 0])
        ent[0] += 1
        ent[1] += x.numel() * x.element_size()

    def _all_reduce(self, x, axis, op):
        if axis is None:
            return x
        self._count(ALL_REDUCE, x, self.extent(axis))
        return x

    def agree(self, flag: bool) -> bool:
        self._count(ALL_REDUCE, torch.zeros(1, dtype=torch.int32),
                    self.size)
        return bool(flag)

    def all_gather(self, x, axis=None, dim: int = 0):
        n = self.size if axis is None else self.extent(axis)
        self._count(ALL_GATHER, x, n)
        return torch.cat([x.contiguous()] * n, dim)

    def all_to_all(self, x, axis):
        if x.shape[0] != self.extent(axis):
            raise ValueError(f"all_to_all over {axis!r} needs dim 0 of "
                             f"size {self.extent(axis)}, got "
                             f"{tuple(x.shape)}")
        self._count(ALL_TO_ALL, x, self.extent(axis))
        return x.clone()

    def reduce_scatter(self, x, axis, dim: int = 0):
        n = self.extent(axis)
        if x.shape[dim] % n:
            raise ValueError(f"reduce_scatter over {axis!r}: dim {dim} of "
                             f"{tuple(x.shape)} does not split into {n}")
        self._count(REDUCE_SCATTER, x, n)
        return x.narrow(dim, 0, x.shape[dim] // n).clone()

    def ppermute(self, x, perm):
        fwd = dict(perm)
        back = {d: s for s, d in perm}
        me = self.rank
        if (me in fwd and fwd[me] != me) or (me in back and back[me] != me):
            self._count(PPERMUTE, x, self.size)
        return torch.zeros_like(x)


def mesh_layout(kind: str) -> Tuple[Tuple[str, ...], Tuple[int, ...]]:
    """(axes, sizes) of ``single``, ``multi`` or ``DxM``."""
    from repro_torch.launch.mesh import production_layout
    if kind in ("single", "multi"):
        shape, axes = production_layout(multi_pod=kind == "multi")
        return tuple(axes), tuple(shape)
    d, m = (int(x) for x in kind.lower().split("x"))
    return ("data", "model"), (d, m)


# ---------------------------------------------------------------------------
# per-rank bytes of the parameters (shapes only)
# ---------------------------------------------------------------------------

def spec_block_bytes(t: torch.Tensor, spec, ext: dict) -> int:
    """Bytes of one rank's block of ``t`` under ``spec``: each dim split
    over the product of its axes' extents, rounded up (as GSPMD pads)."""
    n = 1
    for dim, e in zip(t.shape, tuple(spec) + (None,) * t.dim()):
        axes = e if isinstance(e, tuple) else (e,)
        n *= -(-dim // math.prod(ext[a] for a in axes if a is not None))
    return n * t.element_size()


def spec_param_bytes(cfg, axes, sizes, dtype=torch.float32) -> int:
    """Bytes of one rank's parameters of ``cfg`` under the reference's
    specs (`shardings.leaf_spec`) on a mesh of ``sizes`` over ``axes``:
    what the reference's ``build_cell`` argument tree holds per device
    under its ``in_specs``.  Shapes only, under ``FakeTensorMode``."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from repro_torch.models import shardings as SH
    from repro_torch.models import transformer as T
    ext = dict(zip(axes, sizes))
    with FakeTensorMode():
        model = T.init_params(cfg, 0, dtype=dtype, device="cpu")
        return sum(spec_block_bytes(p, SH.leaf_spec(n, p.dim(), axes), ext)
                   for n, p in model.named_parameters())


def spec_cache_bytes(cfg, batch: int, seq_len: int, axes, sizes,
                     dtype=torch.float32) -> int:
    """Bytes of one rank's caches of ``cfg`` for ``batch`` sequences of
    ``seq_len`` under the reference's specs (`shardings.cache_specs`).
    Shapes only, under ``FakeTensorMode``."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.utils._pytree import tree_leaves
    from repro_torch.models import shardings as SH
    from repro_torch.models import transformer as T
    ext = dict(zip(axes, sizes))
    with FakeTensorMode():
        caches = T.init_caches(cfg, batch, seq_len, dtype=dtype,
                               device="cpu")
        specs = SH.cache_specs(caches, RankStandIn(axes, sizes), batch)
        return sum(spec_block_bytes(t, sp, ext) for t, sp in zip(
            tree_leaves(dict(caches)),
            tree_leaves(specs, is_leaf=lambda x: isinstance(x, tuple))))


def rank_bytes(cfg, n: int, mesh, itemsize: int = 4,
               fsdp: bool = False) -> int:
    """The bytes of the blocks `shardings.tp_block` gives a rank of
    ``mesh`` (anything with its ``axis_names``, ``extent`` and
    ``axis_index``) of ``cfg`` cut to ``n`` layers, at ``itemsize`` bytes
    per element: shapes only, under ``FakeTensorMode``.  With ``fsdp``,
    the blocks it holds (`shardings.rank_block`: also its shard over the
    data axes)."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from repro_torch.models import shardings as SH
    from repro_torch.models import transformer as T
    cut = dataclasses.replace(cfg, n_layers=n)
    block = SH.rank_block if fsdp else SH.tp_block
    with FakeTensorMode():
        model = T.init_params(cut, 0, device="cpu")
        return itemsize * sum(block(name, p, cut, mesh).numel()
                              for name, p in model.named_parameters())


def fitting_depth(cfg, mesh, total: int, free: float = FREE_BYTES,
                  itemsize: int = 4, fsdp: bool = False) -> int:
    """The most of ``cfg``'s layers whose per-rank parameters (at
    ``itemsize`` bytes per element) leave ``free`` bytes of a card of
    ``total`` free (`rank_bytes` of 1 and 2 layers: every layer holds the
    same blocks)."""
    one = rank_bytes(cfg, 1, mesh, itemsize, fsdp)
    two = rank_bytes(cfg, 2, mesh, itemsize, fsdp)
    return min(cfg.n_layers, int((total - free - one) // (two - one)) + 1)


def depth_table(archs: Sequence[str],
                layouts: Sequence[str] = ("1x4", "2x2"),
                dtypes: Sequence[str] = ("bf16", "f32"),
                total: float = CARD_BYTES, free: float = FREE_BYTES) -> list:
    """Rows (arch, layout, dtype, layers that fit, of how many, the
    per-rank parameter bytes at that depth and at full depth): the most
    layers whose held parameters (`rank_bytes` with ``fsdp``) leave
    ``free`` of a card of ``total`` bytes."""
    from repro_torch.configs.base import get_config
    rows = []
    for arch in archs:
        cfg = get_config(arch)
        for layout in layouts:
            axes, sizes = mesh_layout(layout)
            rank = RankStandIn(axes, sizes)
            for name in dtypes:
                size = torch.empty((), dtype=DTYPES[name]).element_size()
                depth = fitting_depth(cfg, rank, total, free, size, True)
                rows.append({
                    "arch": arch, "mesh": layout, "dtype": name,
                    "layers": max(depth, 0), "of": cfg.n_layers,
                    "bytes_at_depth": rank_bytes(cfg, max(depth, 1), rank,
                                                 size, True),
                    "bytes_full": rank_bytes(cfg, cfg.n_layers, rank, size,
                                             True)})
    return rows


# ---------------------------------------------------------------------------
# live bytes of the fake tensors' storages
# ---------------------------------------------------------------------------

class LiveBytes:
    """Context manager over a dispatch mode: the peak, over the run, of
    the bytes of the storages that ops made inside it and that are still
    alive (a storage counts while any tensor on it lives; storages made
    before — the parameters, moments, caches, batch — are not counted,
    nor are their views)."""

    def __init__(self):
        from torch.utils._python_dispatch import TorchDispatchMode
        from torch.utils._pytree import tree_leaves
        from torch.utils.weak import WeakTensorKeyDictionary
        outer = self
        self.live = 0
        self.peak = 0
        self._refs: Dict[int, list] = {}
        self._seen = WeakTensorKeyDictionary()

        class _Mode(TorchDispatchMode):
            def __torch_dispatch__(self, func, types, args=(), kwargs=None):
                out = func(*args, **(kwargs or {}))
                for t in tree_leaves(out):
                    if isinstance(t, torch.Tensor):
                        outer._track(t)
                return out

        self._mode = _Mode()
        self._before: set = set()

    def exclude(self, tensors) -> None:
        """Storages made before the run (never counted)."""
        for t in tensors:
            self._before.add(t.untyped_storage()._cdata)

    def _track(self, t: torch.Tensor) -> None:
        if t in self._seen:
            return
        st = t.untyped_storage()
        key = st._cdata
        self._seen[t] = key
        if key in self._before:
            return
        ent = self._refs.get(key)
        if ent is None:
            self._refs[key] = [1, st.nbytes()]
            self.live += st.nbytes()
            self.peak = max(self.peak, self.live)
        else:
            ent[0] += 1
        weakref.finalize(t, self._drop, key)

    def _drop(self, key: int) -> None:
        ent = self._refs.get(key)
        if ent is None:
            return
        ent[0] -= 1
        if ent[0] == 0:
            self.live -= ent[1]
            del self._refs[key]

    def __enter__(self):
        self._mode.__enter__()
        return self

    def __exit__(self, *exc):
        return self._mode.__exit__(*exc)


# ---------------------------------------------------------------------------
# one step of a cell, on fake tensors
# ---------------------------------------------------------------------------

def _nbytes(tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def _leaves(tree) -> list:
    from torch.utils._pytree import tree_leaves
    return [t for t in tree_leaves(dict(tree)) if isinstance(t, torch.Tensor)]


def rank_rows(rank, b: int) -> int:
    """The rows of a global batch of ``b`` that this rank holds: split
    over the data axes that divide it (`shardings.batch_axes_for`), else
    whole (context parallelism)."""
    from repro_torch.models import shardings as SH
    bax = SH.batch_axes_for(rank, b)
    if bax is None:
        return b
    axes = bax if isinstance(bax, tuple) else (bax,)
    return b // math.prod(rank.extent(a) for a in axes)


def step_costs(cfg, shape, rank: Optional[RankStandIn],
               dtype=torch.float32, remat: str = "full",
               microbatches: int = 1, params_only: bool = False) -> dict:
    """One step of the cell (``cfg`` at its depth; ``shape`` a name of
    ``SHAPES`` or a dict like its entries) on ``rank`` (None: one card,
    no mesh), on fake tensors: {"params", "optimizer", "caches",
    "batch"} bytes of the rank, and unless ``params_only`` the step's
    "flops", "activation_peak", "collectives" (`RankStandIn.counts`) and,
    for a prefill run token by token, "token_steps" (the prompt length
    the one-token step stands for: its flops and collectives are already
    multiplied by it)."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.utils.flop_counter import FlopCounterMode
    from repro_torch.configs.base import SHAPES
    from repro_torch.models import shardings as SH
    from repro_torch.models import transformer as T
    shp = SHAPES[shape] if isinstance(shape, str) else shape
    kind, b, s = shp["kind"], shp["global_batch"], shp["seq_len"]
    rows = b if rank is None else rank_rows(rank, b)
    dev = "cpu" if rank is None else None
    out: dict = {}
    with FakeTensorMode():
        model = T.init_params(cfg, 0, dtype=dtype, device=dev, mesh=rank)
        params = list(model.parameters())
        out["params"] = _nbytes(params)
        out["optimizer"] = 0
        out["caches"] = 0
        d = cfg.d_model
        extra = {}
        if cfg.n_prefix_embeds:
            extra["prefix_embeds"] = torch.randn(rows, cfg.n_prefix_embeds,
                                                 d, dtype=dtype)
        if cfg.enc_layers:
            extra["enc_frames"] = torch.randn(rows, cfg.enc_positions, d,
                                              dtype=dtype)
        before = list(params)
        steps = 1
        if kind == "train":
            from repro_torch.train.optimizer import OptConfig
            from repro_torch.train.train_step import (init_opt_state,
                                                      make_train_step)
            opt = init_opt_state(model)
            out["optimizer"] = _nbytes(_leaves(opt))
            batch = {"tokens": torch.randint(
                0, cfg.vocab, (rows, s - cfg.n_prefix_embeds + 1)), **extra}
            before += _leaves(opt) + _leaves(batch)
            step_fn = make_train_step(cfg, OptConfig(), remat=remat,
                                      microbatches=microbatches)

            def run():
                step_fn(model, opt, batch)
        else:
            from repro_torch.serve.serve_step import decode_step, prefill_step
            caches = T.init_caches(cfg, b, s, dtype=dtype, device=dev,
                                   mesh=rank)
            out["caches"] = _nbytes(_leaves(caches))
            before += _leaves(caches)
            if kind == "prefill":
                n_text = s - cfg.n_prefix_embeds
                if cfg.family in ("hybrid", "ssm"):
                    steps = n_text
                    toks = torch.randint(0, cfg.vocab, (rows, 1))
                else:
                    toks = torch.randint(0, cfg.vocab, (rows, n_text))
                batch = {"tokens": torch.randint(0, cfg.vocab,
                                                 (rows, n_text)), **extra}

                def run():
                    prefill_step(model, cfg, toks, caches, **extra)
            else:
                batch = {"tokens": torch.randint(0, cfg.vocab, (rows, 1))}

                def run():
                    decode_step(model, cfg, batch["tokens"], caches, s - 1)
            before += _leaves(batch)
        out["batch"] = _nbytes(_leaves(batch))
        if params_only:
            return out
        counter = rank if rank is not None else RankStandIn(("data",), (1,))
        counter.reset()
        live = LiveBytes()
        live.exclude(before)
        flops = FlopCounterMode(display=False)
        with SH.use_mesh(rank), live, flops:
            run()
        counts = counter.counts()
    if steps > 1:
        counts = _scale(counts, steps)
        out["token_steps"] = steps
    out["flops"] = float(flops.get_total_flops()) * steps
    out["activation_peak"] = int(live.peak)
    out["collectives"] = counts
    return out


def _scale(tree, f):
    if isinstance(tree, dict):
        return {k: _scale(v, f) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_scale(v, f) for v in tree]
    return tree * f


def _combine(a, b, fa: float, fb: float):
    """fa·a + fb·b over matching nested dicts and lists of numbers (a
    missing key counts 0)."""
    if isinstance(a, dict) or isinstance(b, dict):
        a, b = a or {}, b or {}
        return {k: _combine(a.get(k), b.get(k), fa, fb)
                for k in sorted(set(a) | set(b))}
    if isinstance(a, list) or isinstance(b, list):
        a = a or [0] * len(b)
        b = b or [0] * len(a)
        return [_combine(x, y, fa, fb) for x, y in zip(a, b)]
    v = fa * (a or 0) + fb * (b or 0)
    return int(round(v)) if float(v).is_integer() else v


def depth_unit(cfg) -> int:
    """Layers per repeating unit: the hybrid's ``attn_every``, gemma2's
    local/global pair, else 1."""
    if cfg.family == "hybrid":
        return cfg.attn_every
    return 2 if cfg.local_global_alternate else 1


_DEPTH_KEYS = ("flops", "activation_peak", "collectives")


def extrapolated(cfg, shape_name, rank: Optional[RankStandIn], dtype,
                 remat, microbatches: int) -> dict:
    """The step's FLOPs, activation peak and collectives at ``cfg``'s full
    depth from its 1-unit and 2-unit variants (module docstring), and the
    exact bytes at full depth."""
    unit = depth_unit(cfg)
    trips = cfg.n_layers // unit
    enc1 = min(cfg.enc_layers, 1)
    v1 = dataclasses.replace(cfg, n_layers=unit, enc_layers=enc1)
    v2 = dataclasses.replace(cfg, n_layers=2 * unit, enc_layers=enc1)
    f1 = step_costs(v1, shape_name, rank, dtype, remat, microbatches)
    f2 = step_costs(v2, shape_name, rank, dtype, remat, microbatches)
    out = step_costs(cfg, shape_name, rank, dtype, remat, microbatches,
                     params_only=True)
    for key in _DEPTH_KEYS:
        out[key] = _combine(f1[key], _combine(f2[key], f1[key], 1, -1), 1,
                            trips - 1)
    if cfg.enc_layers > 1:
        v3 = dataclasses.replace(cfg, n_layers=unit, enc_layers=2)
        f3 = step_costs(v3, shape_name, rank, dtype, remat, microbatches)
        for key in _DEPTH_KEYS:
            out[key] = _combine(out[key], _combine(f3[key], f1[key], 1, -1),
                                1, cfg.enc_layers - 1)
    if "token_steps" in f1:
        out["token_steps"] = f1["token_steps"]
    out["depth"] = {"unit": unit, "trips": trips,
                    "variants": [v1.n_layers, v2.n_layers]
                    + ([1] if cfg.enc_layers > 1 else [])}
    return out


def model_flops(cfg, shape_name: str) -> Tuple[float, int]:
    """(the reference's ``model_flops`` of the cell, tokens per step):
    6·N_active·tokens to train, 2·N_active·tokens to prefill, 2·N_active·B
    to decode."""
    from repro_torch.configs.base import SHAPES
    shp = SHAPES[shape_name]
    n_active = cfg.active_param_count()
    if shp["kind"] == "decode":
        tokens = shp["global_batch"]
        return 2.0 * n_active * tokens, tokens
    tokens = shp["global_batch"] * shp["seq_len"]
    return (6.0 if shp["kind"] == "train" else 2.0) * n_active * tokens, \
        tokens


# ---------------------------------------------------------------------------
# cells
# ---------------------------------------------------------------------------

def cell_tag(arch: str, shape: str, mesh_kind: str, tag: str = "") -> str:
    return f"{arch}__{shape}__{mesh_kind}" + (f"__{tag}" if tag else "")


def run_cell(arch: str, shape: str, mesh_kind: str, out_dir: str,
             extra: Optional[dict] = None,
             dtypes: Sequence[str] = ("bf16", "f32")) -> dict:
    from repro_torch.configs.base import (SHAPES, cell_is_applicable,
                                          get_config)
    extra = dict(extra or {})
    cfg = get_config(arch)
    tag = cell_tag(arch, shape, mesh_kind, extra.get("tag", ""))
    path = os.path.join(out_dir, tag + ".json")
    os.makedirs(out_dir, exist_ok=True)
    ok, why = cell_is_applicable(cfg, shape)
    if not ok:
        rec = {"arch": arch, "shape": shape, "mesh": mesh_kind,
               "skipped": why}
        with open(path, "w") as f:
            json.dump(rec, f, indent=1)
        print(f"[skip] {tag}: {why}")
        return rec
    t0 = time.time()
    axes, sizes = mesh_layout(mesh_kind)
    rank = RankStandIn(axes, sizes)
    remat = extra.get("remat", "full")
    mb = int(extra.get("microbatch", 1))
    mflops, tokens = model_flops(cfg, shape)
    rec = {"arch": arch, "shape": shape, "mesh": mesh_kind,
           "axes": list(axes), "mesh_shape": list(sizes),
           "n_ranks": rank.size, "kind": SHAPES[shape]["kind"],
           "extra": extra, "card": CARD, "card_bytes": CARD_BYTES,
           "params_total": cfg.param_count(),
           "params_active": cfg.active_param_count(),
           "tokens_per_step": tokens, "model_flops": mflops,
           "bytes": {}, "errors": {}}
    for name in dtypes:
        try:
            got = extrapolated(cfg, shape, rank, DTYPES[name], remat, mb)
        except Exception as exc:  # noqa: BLE001 — recorded in the cell
            rec["errors"][name] = f"{type(exc).__name__}: {exc}"
            continue
        total = sum(got[k] for k in ("params", "optimizer", "caches",
                                     "batch", "activation_peak"))
        rec["bytes"][name] = {
            k: got[k] for k in ("params", "optimizer", "caches", "batch",
                                "activation_peak")}
        shp = SHAPES[shape]
        rec["bytes"][name]["params_specs"] = spec_param_bytes(
            cfg, axes, sizes, DTYPES[name])
        rec["bytes"][name]["caches_specs"] = 0 if shp["kind"] == "train" \
            else spec_cache_bytes(cfg, shp["global_batch"], shp["seq_len"],
                                  axes, sizes, DTYPES[name])
        rec["bytes"][name].update(total=total, fits=total <= CARD_BYTES)
        rec.setdefault("flops_per_rank", {})[name] = got["flops"]
        # the least time the step's matmuls could take on one card
        rec.setdefault("flop_bound_s", {})[name] = \
            got["flops"] / PEAK_FLOPS[name]
        rec.setdefault("collectives", {})[name] = got["collectives"]
        rec["depth"] = got["depth"]
        if "token_steps" in got:
            rec["token_steps"] = got["token_steps"]
    if "f32" in rec.get("flops_per_rank", {}):
        f = rec["flops_per_rank"]["f32"]
        rec["model_over_counted"] = mflops / max(f * rank.size, 1.0)
    rec["seconds"] = time.time() - t0
    with open(path, "w") as f:
        json.dump(rec, f, indent=1)
    brief = {n: f"{v['total'] / 1e9:.2f} GB fits={v['fits']}"
             for n, v in rec["bytes"].items()}
    coll = rec.get("collectives", {}).get("f32", {}).get("calls", {})
    print(f"[{'ok' if not rec['errors'] else 'error'}] {tag}: per rank "
          f"{brief}; flops {rec.get('flops_per_rank', {})}; collectives "
          f"per step {coll}; errors {rec['errors']} "
          f"({rec['seconds']:.1f} s)")
    return rec


def main(argv=None) -> int:
    from repro_torch.configs.base import ARCH_IDS, SHAPES
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.dryrun")
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", default="single",
                    help="single, multi, both, or DxM (data x model)")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default="results/dryrun_torch")
    ap.add_argument("--inline", action="store_true",
                    help="run cells in-process (default: subprocess per "
                         "cell with --all)")
    ap.add_argument("--remat", default="full")
    ap.add_argument("--microbatch", type=int, default=1)
    ap.add_argument("--tag", default="")
    ap.add_argument("--dtypes", default="bf16,f32")
    ap.add_argument("--fit", default=None,
                    help="comma-separated archs: print the depths whose "
                         "per-rank parameters leave 15 GB of a card free "
                         "on (data 1, model 4) and (data 2, model 2), and "
                         "exit")
    args = ap.parse_args(argv)
    if args.fit:
        rows = depth_table(args.fit.split(","),
                           dtypes=tuple(args.dtypes.split(",")))
        os.makedirs(args.out, exist_ok=True)
        with open(os.path.join(args.out, "fit.json"), "w") as f:
            json.dump(rows, f, indent=1)
        for r in rows:
            print(json.dumps(r))
        return 0
    extra = {"remat": args.remat}
    if args.microbatch > 1:
        extra["microbatch"] = args.microbatch
    if args.tag:
        extra["tag"] = args.tag
    dtypes = tuple(args.dtypes.split(","))
    meshes = ["single", "multi"] if args.mesh == "both" else [args.mesh]
    if not args.all:
        if not (args.arch and args.shape):
            ap.error("--arch and --shape, or --all")
        failed = False
        for mk in meshes:
            failed |= bool(run_cell(args.arch, args.shape, mk, args.out,
                                    extra, dtypes).get("errors"))
        return 1 if failed else 0
    failures = []
    for arch in ARCH_IDS:
        for shape in SHAPES:
            for mk in meshes:
                tag = cell_tag(arch, shape, mk, args.tag)
                if os.path.exists(os.path.join(args.out, tag + ".json")):
                    print(f"[cached] {tag}")
                    continue
                if args.inline:
                    rec = run_cell(arch, shape, mk, args.out, extra, dtypes)
                    if rec.get("errors"):
                        failures.append(tag)
                    continue
                cmd = [sys.executable, "-m", "repro_torch.launch.dryrun",
                       "--arch", arch, "--shape", shape, "--mesh", mk,
                       "--out", args.out, "--remat", args.remat,
                       "--microbatch", str(args.microbatch),
                       "--dtypes", args.dtypes]
                if args.tag:
                    cmd += ["--tag", args.tag]
                if subprocess.run(cmd).returncode != 0:
                    failures.append(tag)
                    print(f"[FAIL] {tag}")
    if failures:
        print("FAILURES:", failures)
        return 1
    print("ALL CELLS OK")
    return 0


if __name__ == "__main__":
    sys.exit(main())
