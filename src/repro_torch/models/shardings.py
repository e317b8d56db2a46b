"""Sharding rules (port of ``repro/models/shardings.py``): where each
parameter, cache and activation lives on a `core.mesh.Mesh`.

The reference's layout, MaxText-style:
  * ``model`` axis — tensor parallelism: attention heads, FFN hidden, the
    expert axis of MoE stacks, the vocab.
  * ``data`` (+ ``pod``) axes — data parallelism, plus FSDP: the d_model
    side of every projection is sharded there too (ZeRO-3).
  * batch over (pod, data); a batch that ``data`` does not divide shards
    the KV cache's sequence over ``data`` instead (context parallelism).

`param_specs`, `cache_specs` and `batch_axes_for` give the reference's
specs: one entry per dim (an axis name, a tuple of names, or None), the
stacked layer axis of the reference's leaves left out, since the port
keeps one module per layer.

The reference hands those specs to GSPMD.  Here the layout is explicit:
each rank holds its own block of every leaf (`rank_block`) and runs the
per-rank body, as ``shard_map`` does, with the collectives of
`core.mesh` (counted in ``obs.metrics``), each with the backward that
its transpose under ``shard_map`` gives it:

* ``model`` (`tp_block`): the rank's heads, hidden units, experts and
  vocab rows; row-parallel partial products are summed (`tp_psum`), and
  every replicated tensor that enters a split region goes through
  `tp_enter`, whose backward sums the ranks' parts of its gradient.
* the data axes (FSDP, ZeRO-3): within its ``model`` block the rank
  holds the block along the dim that the spec gives the data axes
  (`fsdp_dim`: d_model's side of every projection, the embedding's d),
  whenever their extent is above 1.  Parameters, gradients and the
  optimizer's moments are thus 1/(D·M) of each such leaf per rank;
  leaves whose spec has no data entry (norm gains, ``pos_embed``,
  rwkv6's ``mu_*``/``w0``/``w2``/``u``, MLA's gammas) stay whole.  A
  block's function gathers its shards (`gathered`, `fsdp_gather`) and
  the backward reduce-scatters their gradients, summed over the data
  ranks, into the shards.
* the batch: split over every data axis by the caller where they divide
  it; else (a batch of 1) every data rank holds the whole batch and the
  attention caches' sequence is split over ``data`` (`SeqSplitCaches`:
  context parallelism, the reference's long-context decode), each rank
  scoring its own positions and the softmax merged over ``data``.

Under this layout there is nothing left for ``with_sharding_constraint``
to do: the ``constrain_*`` functions check the rank of the local tensor
and return it.

Where ``n_kv_heads`` is not a multiple of the ``model`` extent, the
reference's `cache_specs` shards head_dim (``hd_fallback``), which an
explicit layout would have to close with a psum inside the scores.  The
port instead keeps, on each rank, the KV heads its query heads read
through the GQA group, replicated across the ranks that share them
(`kv_heads_local`); `cache_specs` still gives the reference's spec.

The other places where the explicit layout departs from the specs, each
because a spec's contiguous block of a fused or per-channel leaf is not
what the rank's heads read (GSPMD reshards such a leaf where it is used;
an explicit layout must hold the right columns from the start):

* Mamba2 (`_mamba_segments`): ``in_proj`` is ``[z | x | B | C | dt]`` along
  its columns.  The rank holds its slice of ``z``, of ``x`` and of
  ``dt`` (its heads) and *all* of ``B`` and ``C``, which every head
  reads; ``conv_w``/``conv_b`` likewise hold the rank's ``x`` channels
  and all ``B``/``C`` channels, and the conv state (``cache_specs``:
  channels over model) is di/M + 2N channels wide.  ``B``/``C`` are thus
  computed on every rank (2N of the rank's 2·di/M + 2N + nh/M columns).
  The gated norm runs over all of ``di``: `tp_rmsnorm`.
* rwkv6: the spec replicates ``w0``, ``w2``, ``u`` and ``ln_gamma``;
  the rank holds the columns of its heads of each (the decay's LoRA
  ``w1`` stays whole: its 64-wide product is computed on every rank and
  ``w2`` maps it to the rank's channels).  The time mix's output norm
  runs over all of ``d`` (`tp_rmsnorm`).  The channel mix's ``wv``
  (dff, d) is split by rows, not by the spec's output columns, so the
  column-parallel ``wk``'s hidden units need no gather; its receptance
  ``wr`` stays in column blocks and ``r`` is gathered over ``model``
  (`tp_gather`), where a replicated ``wr`` would cost d² per rank.
* MLA: the rank's heads of ``wuq``, ``wuk``, ``wuv`` and rows of
  ``wo``, as the specs say; ``wdq``, ``wdkv``, ``wkr`` and both norms'
  gains are whole, and so are the ``ckv``/``kr`` caches, which every
  head reads (``cache_specs`` splits ``ckv``'s kv_lora over model).

What the port runs reads one description: `tp_block` keeps the
``model`` entries of `leaf_spec` (the spec `param_specs` gives each
leaf), with the exceptions above written in `kv_heads_local`,
`_mamba_segments` and `_SPLIT_DIM`; `models/transformer.init_caches` sizes
the caches by the same rules.  `param_specs`, `cache_specs`,
`batch_spec` and `constrain_moe_buffers` (and
`launch.mesh.make_production_mesh`) are there for parity with the
reference and to count its per-rank bytes; the forward does not call
them.

``use_mesh`` installs the mesh that `models/transformer.forward` and
`models/moe.moe_ffn_a2a` read; with none, or a mesh whose ``model``
extent is 1, every function computes what it computes without one.
"""
from __future__ import annotations

import contextlib
from typing import Optional

import torch

from repro_torch.core.mesh import (_gather, check_mesh, copy_to,
                                   gather_from, gather_shards, reduce_both,
                                   reduce_from)
from repro_torch.models.layers import rmsnorm

_CURRENT_MESH = None


@contextlib.contextmanager
def use_mesh(mesh):
    """Make ``mesh`` (a `core.mesh.Mesh`) the current mesh inside the
    context."""
    check_mesh(mesh)
    global _CURRENT_MESH
    prev = _CURRENT_MESH
    _CURRENT_MESH = mesh
    try:
        yield mesh
    finally:
        _CURRENT_MESH = prev


def current_mesh():
    return _CURRENT_MESH


class SeqSplitCaches(dict):
    """The caches of ``transformer.init_caches`` for a batch that the data
    axes do not divide: every data rank holds the whole batch, and the
    sequence of ``k``/``v``/``xk``/``xv``/``ckv``/``kr`` is split over
    ``data`` (rank i holds positions i·S/D … (i+1)·S/D − 1), as
    `cache_specs` places them; the O(1) states are whole."""


def _sizes(mesh) -> dict:
    """{axis name: extent} of anything with ``axis_names`` and a
    ``shape`` tuple (a `core.mesh.Mesh`)."""
    return dict(zip(mesh.axis_names, mesh.shape))


def _check_rank(x: torch.Tensor, ndim: int, what: str) -> torch.Tensor:
    if x.dim() != ndim:
        raise ValueError(f"{what} must have {ndim} dims, got "
                         f"{tuple(x.shape)}")
    return x


def constrain_residual(x):
    """The residual stream (B, S, d): the reference constrains it to batch
    over (pod, data) and sequence (or d_model) over model; here each rank
    already holds its rows, whole."""
    return _check_rank(x, 3, "the residual stream (B, S, d)")


def constrain_logits(x):
    """(B, S, V): whole on each rank once the vocab slices are gathered."""
    return _check_rank(x, 3, "the logits (B, S, V)")


def constrain_moe_buffers(x):
    """(E, cap, d) / (E, cap, ff): the rank's experts' buffers."""
    return _check_rank(x, 3, "an expert buffer (E, cap, d)")


def fsdp_axes(mesh_axes) -> tuple:
    return tuple(a for a in ("pod", "data") if a in mesh_axes)


def _fs_entry(mesh_axes):
    """The data axes as one spec entry: a tuple, a name, or None."""
    fs = fsdp_axes(mesh_axes)
    return fs if len(fs) > 1 else (fs[0] if fs else None)


def batch_spec(mesh_axes) -> tuple:
    return (_fs_entry(mesh_axes),)


def batch_axes_for(mesh, batch: int):
    """Largest prefix of (pod, data) whose product divides ``batch``
    (None when even 'data' alone doesn't divide — e.g. batch 1)."""
    sizes = _sizes(mesh)
    fs = fsdp_axes(mesh.axis_names)
    full = 1
    for a in fs:
        full *= sizes[a]
    if batch % full == 0:
        return fs if len(fs) > 1 else fs[0]
    if "data" in fs and batch % sizes["data"] == 0:
        return "data"
    return None


def _rules(name: str, fs) -> Optional[tuple]:
    """Base (unstacked) partition for a leaf by param name."""
    table = {
        # embeddings / head
        "embed": ("model", fs),
        "lm_head": (fs, "model"),
        "pos_embed": (None, None),
        # attention
        "wq": (fs, "model"), "wk": (fs, "model"), "wv": (fs, "model"),
        "wo": ("model", fs),
        # mlp
        "w_gate": (fs, "model"), "w_up": (fs, "model"), "w_down": ("model", fs),
        # moe (leading expert axis → EP over model)
        "router": (fs, None),
        "moe_w_gate": ("model", fs, None), "moe_w_up": ("model", fs, None),
        "moe_w_down": ("model", None, fs),
        "ws_gate": (fs, "model"), "ws_up": (fs, "model"), "ws_down": ("model", fs),
        # mamba2
        "in_proj": (fs, "model"), "out_proj": ("model", fs),
        "conv_w": (None, "model"), "conv_b": ("model",),
        "a_log": ("model",), "dt_bias": ("model",), "d_skip": ("model",),
        "gate_gamma": ("model",),
        # rwkv6
        "wr": (fs, "model"), "wg": (fs, "model"),
        "w0": (None,), "w1": (fs, None), "w2": (None, None), "u": (None,),
        "mu_r": (None,), "mu_k": (None,), "mu_v": (None,), "mu_w": (None,),
        "mu_g": (None,),
        # mla
        "wdq": (fs, None), "wuq": (None, "model"),
        "wdkv": (fs, None), "wkr": (fs, None),
        "wuk": (None, "model"), "wuv": (None, "model"),
        "q_gamma": (None,), "kv_gamma": (None,),
    }
    if name in table:
        return table[name]
    if name.endswith("gamma") or name.startswith("ln") or name.startswith("mu_"):
        return (None,)
    return None


def leaf_spec(path: str, ndim: int, mesh_axes,
              moe_names=("w_gate", "w_up", "w_down")) -> tuple:
    """The spec of the port parameter ``path`` (a ``state_dict`` name such
    as ``blocks.0.moe.w_gate``) of rank ``ndim``."""
    keys = path.split(".")
    name = keys[-1]
    in_moe = any("moe" in k for k in keys)
    lookup = f"moe_{name}" if in_moe and name in moe_names else name
    base = _rules(lookup, _fs_entry(mesh_axes))
    if base is None:
        return (None,) * ndim
    return (None,) * (ndim - len(base)) + tuple(base)


def param_specs(model, mesh_axes,
                moe_names=("w_gate", "w_up", "w_down")) -> dict:
    """{``state_dict`` name: spec} of the port's model: each the
    reference's ``PartitionSpec`` of the leaf it stacks into, without the
    stacked layer axis."""
    return {name: leaf_spec(name, p.dim(), mesh_axes, moe_names)
            for name, p in model.named_parameters()}


def cache_specs(caches, mesh, batch: int):
    """KV caches: batch over (pod,data) when divisible, else the *sequence*
    axis shards over data (context parallelism, long-context decode).

    Head axes that don't divide the model axis (GQA kv ∈ {4, 8}) fall back
    to sharding head_dim — the reference's spec; the port's own cache
    keeps the query heads' KV heads instead (module docstring)."""
    sizes = _sizes(mesh)
    model = sizes.get("model", 1)
    dsize = sizes.get("data", 1)
    bspec = batch_axes_for(mesh, batch)
    seq_par = bspec is None

    def hd_fallback(heads_dim, hd_dim):
        """Pick (heads_spec, hd_spec) respecting divisibility."""
        if heads_dim % model == 0:
            return "model", None
        if hd_dim % model == 0:
            return None, "model"
        return None, None

    def spec_of(name, leaf):
        nd = leaf.dim()
        shp = leaf.shape
        if name in ("k", "v", "xk", "xv"):   # (L?, B, S, KV, hd)
            h_sp, d_sp = hd_fallback(shp[-2], shp[-1])
            seq_sp = "data" if (seq_par and shp[-3] % dsize == 0) else None
            base = ((None, seq_sp, h_sp, d_sp) if seq_par
                    else (bspec, None, h_sp, d_sp))
        elif name in ("ckv",):          # (L?, B, S, kv_lora)
            l_sp = "model" if shp[-1] % model == 0 else None
            seq_sp = "data" if (seq_par and shp[-2] % dsize == 0) else None
            base = ((None, seq_sp, l_sp) if seq_par else (bspec, None, l_sp))
        elif name in ("kr",):           # (L?, B, S, rope_hd)
            seq_sp = "data" if (seq_par and shp[-2] % dsize == 0) else None
            base = ((None, seq_sp, None) if seq_par else (bspec, None, None))
        elif name == "ssm":             # (L?, B, nh, N, P)
            h_sp = "model" if shp[-3] % model == 0 else None
            base = (bspec, h_sp, None, None)
        elif name == "conv":            # (L?, B, K-1, C)
            c_sp = "model" if shp[-1] % model == 0 else None
            base = (bspec, None, c_sp)
        elif name == "wkv":             # (L?, B, H, N, P)
            h_sp = "model" if shp[-3] % model == 0 else None
            base = (bspec, h_sp, None, None)
        elif name in ("prev", "prev_cm"):   # (L?, B, d)
            d_sp = "model" if shp[-1] % model == 0 else None
            base = (bspec, d_sp)
        else:
            base = (None,) * nd
        return (None,) * (nd - len(base)) + tuple(base)

    def walk(tree):
        return {k: walk(v) if isinstance(v, dict) else spec_of(k, v)
                for k, v in tree.items()}

    return walk(caches)


# ---------------------------------------------------------------------------
# the explicit layout
# ---------------------------------------------------------------------------

def block_index(spec_entry, mesh) -> tuple:
    """(this rank's block index, number of blocks) along a dim whose spec
    entry is ``spec_entry``: its axes in order, the first the slowest."""
    if spec_entry is None:
        return 0, 1
    axes = spec_entry if isinstance(spec_entry, tuple) else (spec_entry,)
    idx, n = 0, 1
    for a in axes:
        idx = idx * mesh.extent(a) + mesh.axis_index(a)
        n *= mesh.extent(a)
    return idx, n


def local_block(t: torch.Tensor, spec: tuple, mesh) -> torch.Tensor:
    """This rank's block of the whole tensor ``t`` under ``spec`` (a copy
    where any dim is split, so the whole tensor can be freed; ``t`` itself
    where none is).  A dim that its axes do not divide raises."""
    if len(spec) != t.dim():
        raise ValueError(f"spec {spec} for a tensor of shape "
                         f"{tuple(t.shape)}")
    index, split = [], False
    for dim, entry in zip(t.shape, spec):
        i, n = block_index(entry, mesh)
        if dim % n:
            raise ValueError(f"dim {dim} of {tuple(t.shape)} does not split "
                             f"into {n} blocks over {entry}")
        size = dim // n
        index.append(slice(i * size, (i + 1) * size))
        split |= n > 1
    return t[tuple(index)].clone() if split else t


def model_extent(mesh) -> int:
    """The ``model`` extent of ``mesh`` (1 without a mesh or axis)."""
    if mesh is None or "model" not in mesh.axis_names:
        return 1
    return mesh.extent("model")


def data_extent(mesh) -> int:
    """The product of the data axes' extents (pod, data)."""
    n = 1
    for a in fsdp_axes(() if mesh is None else mesh.axis_names):
        n *= mesh.extent(a)
    return n


def check_tp(cfg, m: int) -> None:
    """Raise unless ``cfg`` runs tensor-parallel over ``m`` ranks: ``m``
    must divide the query heads (the attention families), Mamba2's SSM
    heads (hybrid), rwkv6's heads (d_model / head size) and the experts,
    and the KV heads must either split over ``m`` or be shared by each
    rank's query heads."""
    if m == 1:
        return
    heads = {"query heads": 0 if cfg.family == "ssm" else cfg.n_heads,
             "experts": cfg.n_experts}
    if cfg.family == "hybrid":
        heads["SSM heads"] = cfg.ssm_nheads
    if cfg.family == "ssm":
        heads["rwkv6 heads"] = cfg.d_model // cfg.ssm_head_dim
    for what, n in heads.items():
        if n % m:
            raise ValueError(f"{cfg.name}: {n} {what} do not split over "
                             f"model={m}")
    if cfg.family != "ssm":
        kv_heads_local(cfg, m)


def kv_heads_local(cfg, m: int) -> int:
    """KV heads on each of ``m`` model ranks: n_kv/m where m divides them;
    else the one KV head that all of the rank's query heads read (the
    rank's query heads must then lie inside one GQA group)."""
    kv = cfg.n_kv_heads
    if kv % m == 0:
        return kv // m
    rep, h_loc = cfg.n_heads // kv, cfg.n_heads // m
    if rep % h_loc:
        raise ValueError(f"{cfg.name}: {h_loc} query heads per rank straddle "
                         f"GQA groups of {rep} ({kv} KV heads over "
                         f"model={m})")
    return 1


#: (parent, leaf) → the dim that ``model`` splits where the explicit
#: layout departs from the leaf's spec (module docstring): rwkv6's
#: per-channel decay terms and output norm by the rank's heads, the
#: channel mix's ``wv`` by rows
_SPLIT_DIM = {("tmix", "w0"): 0, ("tmix", "w2"): 1, ("tmix", "u"): 0,
              ("tmix", "ln_gamma"): 0, ("cmix", "wv"): 0}


def _names(path: str) -> tuple:
    keys = path.split(".")
    return (keys[-2] if len(keys) > 1 else ""), keys[-1]


def _mamba_segments(name: str, cfg):
    """(sizes, split) of the Mamba2 leaf ``name``'s last dim where it is
    not one contiguous block (module docstring), else None: ``in_proj``'s
    columns [z, x, B, C, dt], ``conv_w``/``conv_b``'s channels [x, B,
    C]; ``split`` marks the segments cut by head."""
    di, n, nh = cfg.d_inner, cfg.ssm_state, cfg.ssm_nheads
    if name == "in_proj":
        return (di, di, 2 * n, nh), (True, True, False, True)
    if name in ("conv_w", "conv_b"):
        return (di, 2 * n), (True, False)
    return None


def _kv_fallback(parent: str, name: str, cfg, m: int) -> bool:
    return (name in ("wk", "wv") and parent in ("attn", "xattn")
            and cfg.n_kv_heads % m != 0)


def _kv_head(cfg, m: int, j: int) -> int:
    """The KV head that rank ``j`` of ``m``'s query heads read, where
    ``model`` does not divide the KV heads (`kv_heads_local`)."""
    kv_heads_local(cfg, m)
    return j * (cfg.n_heads // m) // (cfg.n_heads // cfg.n_kv_heads)


def _model_dims(path: str, ndim: int) -> list:
    """The dims of leaf ``path`` that ``model`` splits in one block each."""
    parent, name = _names(path)
    if (parent, name) in _SPLIT_DIM:
        return [_SPLIT_DIM[parent, name]]
    return [i for i, e in enumerate(leaf_spec(path, ndim, ("model",)))
            if e == "model"]


def _model_index(path: str, shape, cfg, m: int, j: int) -> tuple:
    """The index into the whole leaf ``path`` (of ``shape``) of rank ``j``
    of ``m``'s tensor-parallel block: a slice per dim, or the column ids
    of a Mamba2 leaf's segments."""
    parent, name = _names(path)
    index = [slice(None)] * len(shape)
    seg = _mamba_segments(name, cfg) if parent == "mamba" else None
    if seg is not None:
        cols, lo = [], 0
        for size, cut in zip(*seg):
            if cut and size % m:
                raise ValueError(f"a segment of {size} columns does not "
                                 f"split into {m} blocks")
            w = size // m if cut else size
            first = lo + j * w if cut else lo
            cols.append(torch.arange(first, first + w))
            lo += size
        index[-1] = torch.cat(cols)
        return tuple(index)
    if _kv_fallback(parent, name, cfg, m):
        k = _kv_head(cfg, m, j)
        index[-1] = slice(k * cfg.hd, (k + 1) * cfg.hd)
        return tuple(index)
    for d in _model_dims(path, len(shape)):
        if shape[d] % m:
            raise ValueError(f"dim {shape[d]} of {tuple(shape)} does not "
                             f"split into {m} blocks over model")
        w = shape[d] // m
        index[d] = slice(j * w, (j + 1) * w)
    return tuple(index)


def _whole_shape(path: str, shape, cfg, m: int) -> tuple:
    """The whole leaf's shape of a tensor-parallel block of ``shape``."""
    parent, name = _names(path)
    shape = list(shape)
    seg = _mamba_segments(name, cfg) if parent == "mamba" else None
    if seg is not None:
        shape[-1] = sum(seg[0])
    elif _kv_fallback(parent, name, cfg, m):
        shape[-1] = cfg.n_kv_heads * cfg.hd
    else:
        for d in _model_dims(path, len(shape)):
            shape[d] *= m
    return tuple(shape)


def tp_block(path: str, t: torch.Tensor, cfg, mesh) -> torch.Tensor:
    """The rank's block of the whole parameter ``t`` (``path`` its
    ``state_dict`` name, or the name without the layer index) in the
    tensor-parallel layout: the ``model`` entries of its spec (column
    blocks of wq/wk/wv, w_gate/w_up, ws_gate/ws_up, MLA's wuq/wuk/wuv,
    rwkv6's wr/wk/wv/wg; row blocks of wo, w_down, ws_down, out_proj;
    the rank's experts, SSM heads' a_log/dt_bias/d_skip and gate_gamma
    channels; the rank's vocab rows of embed and columns of lm_head); for
    wk/wv whose heads ``model`` does not divide, the KV head of the
    rank's query heads; and the departures of the module docstring
    (Mamba2's segments, `_SPLIT_DIM`).  ``t`` itself where ``model``
    splits nothing of it, else a copy."""
    m = model_extent(mesh)
    if m == 1:
        return t
    index = _model_index(path, t.shape, cfg, m, mesh.axis_index("model"))
    if all(isinstance(i, slice) and i == slice(None) for i in index):
        return t
    blk = t[index]
    # basic slicing gives a view: copy it, so the whole can be freed
    return blk if any(torch.is_tensor(i) for i in index) else blk.clone()


def fsdp_dim(path: str, ndim: int, mesh) -> Optional[int]:
    """The dim of leaf ``path`` that the data axes split (FSDP, ZeRO-3):
    the dim whose spec entry is the data axes, always d_model's side of
    a projection; None where the spec has no data entry or the data
    extent is 1."""
    if data_extent(mesh) == 1:
        return None
    fs = _fs_entry(mesh.axis_names)
    spec = leaf_spec(path, ndim, mesh.axis_names)
    return spec.index(fs) if fs in spec else None


def _data_axes(mesh) -> tuple:
    """The data axes of ``mesh`` whose extent is above 1, slowest first."""
    return tuple(a for a in fsdp_axes(mesh.axis_names)
                 if mesh.extent(a) > 1)


def rank_block(path: str, t: torch.Tensor, cfg, mesh) -> torch.Tensor:
    """What the rank holds of the whole parameter ``t``: its `tp_block`
    and, within that, its block along `fsdp_dim` over the data axes (a
    dim they do not divide raises)."""
    t = tp_block(path, t, cfg, mesh)
    d = fsdp_dim(path, t.dim(), mesh)
    if d is None:
        return t
    spec = [None] * t.dim()
    spec[d] = _fs_entry(mesh.axis_names)
    return local_block(t, tuple(spec), mesh)


def mark_layout(model, mesh) -> None:
    """Record on each parameter of ``model`` (held as `rank_block`s of
    ``mesh``) its ``fsdp_dim``, which `gathered` reads."""
    for name, p in model.named_parameters():
        p.fsdp_dim = None if mesh is None else fsdp_dim(name, p.dim(), mesh)


def fsdp_gather(t: torch.Tensor) -> torch.Tensor:
    """The rank's parameter shard ``t`` gathered over the current mesh's
    data axes along its ``fsdp_dim`` (its `tp_block`); the backward
    reduce-scatters (sums) each rank's gradient of the gathered tensor
    into the shards.  ``t`` itself where it is not sharded."""
    d = getattr(t, "fsdp_dim", None)
    if d is None:
        return t
    mesh = _CURRENT_MESH
    return gather_shards(mesh, t, _data_axes(mesh), d)


class _Gathered:
    """A module's parameters, each through `fsdp_gather`, under the
    module's own attribute names; child modules likewise."""

    def __init__(self, module):
        for name, p in module.named_parameters(recurse=False):
            setattr(self, name, fsdp_gather(p))
        for name, child in module.named_children():
            setattr(self, name, _Gathered(child))


def gathered(module):
    """``module`` with its FSDP shards gathered (`fsdp_gather`), for the
    body of one block: called inside the function that remat
    checkpoints, the gathered weights are freed after the block and
    gathered again in the recomputation.  ``module`` itself when the
    current mesh's data extent is 1."""
    if data_extent(_CURRENT_MESH) == 1:
        return module
    return _Gathered(module)


def whole_leaf(path: str, t: torch.Tensor, cfg, mesh) -> torch.Tensor:
    """The inverse of `rank_block`: the whole parameter from every rank's
    block ``t`` (a collective over ``mesh``: every rank calls it, in the
    same order)."""
    d = fsdp_dim(path, t.dim(), mesh)
    if d is not None:
        t = _gather(mesh, t.contiguous(), _data_axes(mesh), d)
    m = model_extent(mesh)
    if m == 1:
        return t
    shape = _whole_shape(path, t.shape, cfg, m)
    parts = mesh.all_gather(t.contiguous()[None], "model", dim=0)
    out = t.new_empty(shape)
    for j in range(m):
        out[_model_index(path, shape, cfg, m, j)] = parts[j]
    return out


def whole_shape(path: str, shape, cfg, mesh) -> tuple:
    """The whole parameter's shape of a `rank_block` of ``shape``."""
    shape = list(shape)
    d = fsdp_dim(path, len(shape), mesh)
    if d is not None:
        shape[d] *= data_extent(mesh)
    m = model_extent(mesh)
    return _whole_shape(path, shape, cfg, m) if m > 1 else tuple(shape)


def counted_once(path: str, t: torch.Tensor, cfg, mesh):
    """What of the rank's block ``t`` of ``path`` this rank counts in a
    sum over the whole mesh that counts each element of the leaf once:
    True (all of it), False (none: another rank holds the same numbers)
    or a bool mask over the last dim (Mamba2's B/C columns, counted on
    model rank 0)."""
    if mesh is None:
        return True
    if fsdp_dim(path, t.dim(), mesh) is None and any(
            mesh.axis_index(a) for a in fsdp_axes(mesh.axis_names)):
        return False
    m = model_extent(mesh)
    if m == 1:
        return True
    j = mesh.axis_index("model")
    parent, name = _names(path)
    seg = _mamba_segments(name, cfg) if parent == "mamba" else None
    if seg is not None:
        mask = torch.cat([torch.full((size // m if cut else size,),
                                     cut or j == 0, dtype=torch.bool)
                          for size, cut in zip(*seg)])
        return mask.to(t.device)
    if _kv_fallback(parent, name, cfg, m):
        return j % (m // cfg.n_kv_heads) == 0
    return bool(_model_dims(path, t.dim())) or j == 0


def tp_psum(x: torch.Tensor) -> torch.Tensor:
    """The sum over the current mesh's ``model`` ranks of a row-parallel
    partial product (the identity at a ``model`` extent of 1); its
    output is read alike on every rank, so the backward is the
    identity (`core.mesh.reduce_from`)."""
    mesh = _CURRENT_MESH
    if model_extent(mesh) == 1:
        return x
    return reduce_from(mesh, x, "model")


def tp_enter(x: torch.Tensor) -> torch.Tensor:
    """A replicated tensor entering a split region (Megatron's "f"): the
    identity, whose backward sums the ranks' parts of the gradient over
    ``model`` (`core.mesh.copy_to`).  Each column-parallel product's
    input goes through it, so every replicated activation and leaf
    upstream of it gets its whole gradient on every rank."""
    mesh = _CURRENT_MESH
    if model_extent(mesh) == 1:
        return x
    return copy_to(mesh, x, "model")


def tp_enter_cols(t: torch.Tensor, lo: int, hi: int) -> torch.Tensor:
    """`tp_enter` of the columns ``lo:hi`` of a leaf the rank holds in
    part: Mamba2's B/C columns of ``in_proj`` and channels of
    ``conv_w``/``conv_b``, held whole on every rank beside the rank's
    split columns."""
    if model_extent(_CURRENT_MESH) == 1 or not (
            torch.is_grad_enabled() and t.requires_grad):
        return t
    return torch.cat([t[..., :lo], tp_enter(t[..., lo:hi]), t[..., hi:]],
                     -1)


def tp_enter_kv(w: torch.Tensor, cfg) -> torch.Tensor:
    """``wk``/``wv`` of the KV head that the rank's query heads read,
    where ``model`` does not divide the KV heads: the ranks of one GQA
    group hold the same columns, and the backward sums its gradient over
    them (the rank's columns placed among all KV heads' and summed over
    ``model``)."""
    mesh = _CURRENT_MESH
    m = model_extent(mesh)
    if m == 1 or cfg.n_kv_heads % m == 0 or not (
            torch.is_grad_enabled() and w.requires_grad):
        return w
    k = _kv_head(cfg, m, mesh.axis_index("model"))
    full = torch.nn.functional.pad(
        w, (k * cfg.hd, (cfg.n_kv_heads - k - 1) * cfg.hd))
    return tp_enter(full)[..., k * cfg.hd:(k + 1) * cfg.hd]


def tp_gather(x: torch.Tensor, dim: int) -> torch.Tensor:
    """The ``model`` ranks' slices of ``x`` concatenated along ``dim``,
    read replicated: the backward keeps the rank's slice
    (`core.mesh.gather_from`)."""
    mesh = _CURRENT_MESH
    if model_extent(mesh) == 1:
        return x
    return gather_from(mesh, x, "model", dim)


def tp_rmsnorm(x: torch.Tensor, gamma_local: torch.Tensor,
               eps: float = 1e-5) -> torch.Tensor:
    """`layers.rmsnorm` over a width that ``model`` splits: ``x`` and
    ``gamma_local`` hold the rank's slice of the channels, the sum of
    squares is summed over ``model`` and divided by the global width (the
    local one times the ``model`` extent).  At an extent of 1 it is
    `rmsnorm` itself."""
    mesh = _CURRENT_MESH
    m = model_extent(mesh)
    if m == 1:
        return rmsnorm(x, gamma_local, eps)
    dt = x.dtype
    xf = x.float()
    # the sum feeds split channels: psum both ways
    ss = reduce_both(mesh, (xf * xf).sum(-1, keepdim=True), "model")
    xf = xf * torch.rsqrt(ss / (xf.shape[-1] * m) + eps)
    return (xf * (1.0 + gamma_local.float())).to(dt)
