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
each rank holds its own block of every leaf the spec shards over
``model`` (`local_block`, `tp_block`) and runs the per-rank body, as
``shard_map`` does, with the collectives of `core.mesh.Mesh` (counted in
``obs.metrics``).  Only the ``model`` axis is materialised: the
``data``/``pod`` entries of the parameter specs stay replicated (the same
numbers, more memory; ZeRO-3 is left for later), and the batch is split
over every data axis by the caller.  Under this layout there is nothing
left for ``with_sharding_constraint`` to do: the ``constrain_*``
functions check the rank of the local tensor and return it.

Where ``n_kv_heads`` is not a multiple of the ``model`` extent, the
reference's `cache_specs` shards head_dim (``hd_fallback``), which an
explicit layout would have to close with a psum inside the scores.  The
port instead keeps, on each rank, the KV heads its query heads read
through the GQA group, replicated across the ranks that share them
(`kv_heads_local`); `cache_specs` still gives the reference's spec.

What the port runs reads one description: `tp_block` keeps the
``model`` entries of `leaf_spec` (the spec `param_specs` gives each
leaf), with the one KV-head exception above written in
`kv_heads_local`, which `models/transformer.init_caches` also reads.
`param_specs`, `cache_specs`, `batch_spec` and `constrain_moe_buffers`
(and `launch.mesh.make_production_mesh`) are there for parity with the
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

from repro_torch.core.mesh import check_mesh

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
    """Raise unless ``cfg``'s family runs tensor-parallel over ``m``
    ranks: the dense, vlm and non-MLA MoE decoders, with query heads that
    ``m`` divides and KV heads that either ``m`` divides or that each
    rank's query heads share one of."""
    if m == 1:
        return
    if cfg.family in ("hybrid", "ssm", "audio") or cfg.is_mla:
        raise NotImplementedError(
            f"{cfg.name}: tensor parallelism over model={m} covers the "
            f"dense, vlm and MoE decoders without MLA; Mamba2, rwkv6, "
            f"whisper and MLA are queued in ROADMAP.md")
    if cfg.n_heads % m:
        raise ValueError(f"{cfg.name}: {cfg.n_heads} query heads do not "
                         f"split over model={m}")
    if cfg.n_experts % m:
        raise ValueError(f"{cfg.name}: {cfg.n_experts} experts do not "
                         f"split over model={m}")
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


def tp_block(path: str, t: torch.Tensor, cfg, mesh) -> torch.Tensor:
    """The rank's block of the whole parameter ``t`` (``path`` its
    ``state_dict`` name, or the name without the layer index) in the
    tensor-parallel layout: the ``model`` entries of its spec (column
    blocks of wq/wk/wv, w_gate/w_up, ws_gate/ws_up; row blocks of wo,
    w_down, ws_down; the rank's experts; the rank's vocab rows of embed
    and columns of lm_head), and for wk/wv whose heads ``model`` does not
    divide, the KV head of the rank's query heads."""
    m = model_extent(mesh)
    if m == 1:
        return t
    name = path.rsplit(".", 1)[-1]
    if name in ("wk", "wv") and cfg.n_kv_heads % m:
        kv_heads_local(cfg, m)
        j = (mesh.axis_index("model") * (cfg.n_heads // m)
             // (cfg.n_heads // cfg.n_kv_heads))
        return t[:, j * cfg.hd:(j + 1) * cfg.hd].clone()
    spec = tuple("model" if e == "model" else None
                 for e in leaf_spec(path, t.dim(), mesh.axis_names))
    return local_block(t, spec, mesh)


def tp_psum(x: torch.Tensor) -> torch.Tensor:
    """The sum over the current mesh's ``model`` ranks of a row-parallel
    partial product (the identity at a ``model`` extent of 1)."""
    mesh = _CURRENT_MESH
    if model_extent(mesh) == 1:
        return x
    return mesh.psum(x.contiguous(), "model")


def tp_gather(x: torch.Tensor, dim: int) -> torch.Tensor:
    """The ``model`` ranks' slices of ``x`` concatenated along ``dim``."""
    mesh = _CURRENT_MESH
    if model_extent(mesh) == 1:
        return x
    return mesh.all_gather(x, "model", dim=dim)
