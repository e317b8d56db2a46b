"""Port parity for the sharding rules (`repro_torch.models.shardings`) and
the mesh factory (`repro_torch.launch.mesh`).

``param_specs``, ``cache_specs`` and ``batch_axes_for`` against the JAX
package's for all ten archs on their ``reduced()`` trees, on (data, model)
and (pod, data, model) axes: the port's spec of each parameter is the
reference's spec of the leaf it stacks into, the stacked layer axis left
out.  ``local_block`` and ``tp_block`` on a stand-in mesh (any rank of a
shape, no process group); ``make_mesh`` on a gloo world of one.  The
4-rank runs are in ``tests/test_torch_tp.py``.
"""
import types

import numpy as np
import pytest
import torch
import torch.distributed as dist
import jax
from jax.sharding import PartitionSpec

from repro.configs.base import ARCH_IDS as R_ARCH_IDS
from repro.configs.base import get_config as r_get_config
from repro.models import shardings as rSH
from repro.models import transformer as rT

from repro_torch.configs.base import ARCH_IDS, get_config
from repro_torch.core.mesh import Mesh
from repro_torch.launch import mesh as LM
from repro_torch.models import shardings as SH
from repro_torch.models import transformer as T
from repro_torch.models.weights import STACKED

# (axis names, sizes): the (data, model) layouts 1/4, 2/2, 4/1, and the
# same with a pod axis in front
LAYOUTS = [(("data", "model"), s) for s in ((1, 4), (2, 2), (4, 1))] + [
    (("pod", "data", "model"), s)
    for s in ((1, 1, 4), (1, 2, 2), (2, 2, 1), (2, 1, 2))]
BATCHES = (1, 2, 3, 4, 8)


def _meshes(axes, sizes):
    """The stand-ins each package's spec functions read: the reference's
    mesh shape is a mapping, the port's a tuple."""
    ref = types.SimpleNamespace(shape=dict(zip(axes, sizes)), axis_names=axes)
    port = types.SimpleNamespace(shape=tuple(sizes), axis_names=axes)
    return ref, port


def _flat_specs(tree, prefix=()):
    """{("blocks", "attn", "wq"): entries} of a nested dict of specs (the
    reference's ``PartitionSpec``s or the port's tuples)."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat_specs(v, prefix + (k,)))
        else:
            assert isinstance(v, (PartitionSpec, tuple))
            out[prefix + (k,)] = tuple(v)
    return out


def _reference_shapes(arch):
    cfg = r_get_config(arch).reduced()
    return cfg, jax.eval_shape(lambda: rT.init_params(
        cfg, jax.random.PRNGKey(0)))


def test_arch_lists_agree():
    assert list(ARCH_IDS) == list(R_ARCH_IDS)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_param_specs_equal_reference(arch):
    """Every port parameter's spec is the reference's for its leaf, the
    stacked axis stripped, on both axis sets."""
    _, shapes = _reference_shapes(arch)
    model = T.init_params(get_config(arch).reduced(), 0, device="cpu")
    for axes in (("data", "model"), ("pod", "data", "model")):
        want = _flat_specs(rSH.param_specs(shapes, axes))
        got = SH.param_specs(model, axes)
        seen = set()
        for name, spec in got.items():
            keys = name.split(".")
            stacked = keys[0] in STACKED
            path = tuple(keys[:1] + keys[2:]) if stacked else tuple(keys)
            ref = want[path]
            if stacked:                 # the reference's layer axis
                assert ref[0] is None, (name, ref)
                ref = ref[1:]
            assert spec == ref, (name, spec, ref)
            assert len(spec) == model.get_parameter(name).dim()
            seen.add(path)
        assert seen == set(want)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_cache_specs_and_batch_axes_equal_reference(arch):
    """``cache_specs`` over the port's caches (the reference's layouts) and
    ``batch_axes_for`` at batches 1–8, on every layout."""
    rcfg = r_get_config(arch).reduced()
    cfg = get_config(arch).reduced()
    for b in BATCHES:
        rcaches = jax.eval_shape(lambda: rT.init_caches(rcfg, b, 32))
        caches = T.init_caches(cfg, b, 32, device="cpu")
        for axes, sizes in LAYOUTS:
            rmesh, pmesh = _meshes(axes, sizes)
            assert SH.batch_axes_for(pmesh, b) == rSH.batch_axes_for(rmesh, b)
            want = _flat_specs(rSH.cache_specs(rcaches, rmesh, b))
            got = _flat_specs(SH.cache_specs(caches, pmesh, b))
            assert got == want, (arch, b, sizes)


def test_batch_spec_and_fsdp_axes():
    assert SH.fsdp_axes(("data", "model")) == ("data",)
    assert SH.fsdp_axes(("pod", "data", "model")) == ("pod", "data")
    assert SH.fsdp_axes(("model",)) == ()
    for axes in (("data", "model"), ("pod", "data", "model"), ("model",)):
        assert SH.batch_spec(axes) == tuple(rSH.batch_spec(axes))


class _StandIn:
    """The layout of one rank of a mesh, without a process group."""

    def __init__(self, shape, axes, rank):
        self.shape, self.axis_names, self.rank = tuple(shape), axes, rank

    def extent(self, axis):
        return self.shape[self.axis_names.index(axis)]

    def axis_index(self, axis):
        return int(np.unravel_index(self.rank, self.shape)[
            self.axis_names.index(axis)])


@pytest.mark.parametrize("axes,sizes", LAYOUTS)
def test_local_block_round_trip(axes, sizes):
    """The ranks' blocks under a spec tile the whole tensor: each element
    lands in exactly the blocks of the ranks the spec maps it to."""
    fs = SH._fs_entry(axes)
    t = torch.arange(8 * 12 * 4, dtype=torch.float32).reshape(8, 12, 4)
    spec = (fs, "model", None)
    n = int(np.prod(sizes))
    seen = torch.zeros_like(t)
    for r in range(n):
        m = _StandIn(sizes, axes, r)
        blk = SH.local_block(t, spec, m)
        i, ni = SH.block_index(fs, m)
        j, nj = SH.block_index("model", m)
        assert blk.shape == (8 // ni, 12 // nj, 4)
        rows, cols = slice(i * 8 // ni, (i + 1) * 8 // ni), \
            slice(j * 12 // nj, (j + 1) * 12 // nj)
        assert torch.equal(blk, t[rows, cols])
        seen[rows, cols] += 1
    # every element is held by the ranks the spec leaves it replicated on
    _, ni = SH.block_index(fs, _StandIn(sizes, axes, 0))
    _, nj = SH.block_index("model", _StandIn(sizes, axes, 0))
    assert bool((seen == n // (ni * nj)).all())
    one = _StandIn((1,) * len(axes), axes, 0)
    assert SH.local_block(t, spec, one) is t
    with pytest.raises(ValueError, match="does not split"):
        SH.local_block(torch.zeros(6, 5), ("data", "model"),
                       _StandIn((2, 2), ("data", "model"), 0))


def test_tp_block_keeps_the_query_heads_kv_head():
    """With fewer KV heads than model ranks, each rank keeps the KV head
    its query heads read; where model divides them, a column block."""
    cfg = get_config("llama4_scout_17b_a16e").reduced()     # 4 heads, 1 KV
    assert cfg.n_kv_heads == 1
    wk = torch.randn(cfg.d_model, cfg.n_kv_heads * cfg.hd)
    for r in range(4):
        m = _StandIn((1, 4), ("data", "model"), r)
        assert torch.equal(SH.tp_block("attn.wk", wk, cfg, m), wk)
        wq = torch.randn(cfg.d_model, cfg.n_heads * cfg.hd)
        assert torch.equal(SH.tp_block("attn.wq", wq, cfg, m),
                           wq[:, r * cfg.hd:(r + 1) * cfg.hd])
    g2 = get_config("gemma2_9b").reduced()                   # 4 heads, 2 KV
    wk = torch.randn(g2.d_model, g2.n_kv_heads * g2.hd)
    for r in range(4):
        m = _StandIn((1, 4), ("data", "model"), r)
        j = r // 2
        assert torch.equal(SH.tp_block("attn.wv", wk, g2, m),
                           wk[:, j * g2.hd:(j + 1) * g2.hd])
        assert SH.kv_heads_local(g2, 4) == 1
    assert SH.kv_heads_local(g2, 2) == 1
    assert SH.kv_heads_local(get_config("minicpm_2b").reduced(), 4) == 1
    # the experts: rank r holds experts 2r, 2r + 1 of 8
    moe = torch.arange(8.0)[:, None, None].expand(8, 3, 5)
    m = _StandIn((2, 2), ("data", "model"), 3)
    assert SH.tp_block("moe.w_gate", moe, cfg, m)[:, 0, 0].tolist() == [4, 5,
                                                                         6, 7]
    # embed: vocab rows; lm_head: vocab columns; router: replicated
    emb = torch.randn(cfg.vocab_pad, cfg.d_model)
    assert torch.equal(SH.tp_block("embed", emb, cfg, m), emb[256:])
    assert torch.equal(SH.tp_block("lm_head", emb.T, cfg, m), emb.T[:, 256:])
    router = torch.randn(cfg.d_model, 8)
    assert SH.tp_block("moe.router", router, cfg, m) is router


def test_families_without_a_tensor_parallel_form_raise():
    for arch in ("zamba2_2p7b", "rwkv6_7b", "whisper_medium",
                 "deepseek_v2_236b"):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            SH.check_tp(get_config(arch).reduced(), 4)
        SH.check_tp(get_config(arch).reduced(), 1)
    with pytest.raises(ValueError, match="query heads"):
        SH.check_tp(get_config("minicpm_2b").reduced(), 3)
    for arch in ("minicpm_2b", "gemma2_9b", "starcoder2_15b",
                 "mistral_large_123b", "internvl2_26b",
                 "llama4_scout_17b_a16e"):
        SH.check_tp(get_config(arch), 4)          # every full width divides
        SH.check_tp(get_config(arch).reduced(), 4)


def test_constrain_functions_check_shapes_and_return_their_input():
    x = torch.zeros(2, 3, 4)
    assert SH.constrain_residual(x) is x
    assert SH.constrain_logits(x) is x
    assert SH.constrain_moe_buffers(x) is x
    with pytest.raises(ValueError, match="3 dims"):
        SH.constrain_residual(torch.zeros(2, 3))


def test_use_mesh_refuses_a_foreign_mesh():
    with pytest.raises(TypeError):
        with SH.use_mesh(object()):
            pass
    assert SH.current_mesh() is None
    local = Mesh.local(("data", "model"), device="cpu")
    with SH.use_mesh(local):
        assert SH.current_mesh() is local
        assert SH.model_extent(local) == 1 and SH.data_extent(local) == 1
    assert SH.current_mesh() is None


@pytest.fixture
def gloo_world_of_one():
    assert not dist.is_initialized()
    dist.init_process_group("gloo", store=dist.HashStore(), rank=0,
                            world_size=1)
    try:
        yield
    finally:
        dist.destroy_process_group()


def test_make_mesh_needs_a_process_group():
    assert not dist.is_initialized()
    with pytest.raises(RuntimeError, match="init_process_group"):
        LM.make_mesh((1, 1), ("data", "model"), device="cpu")


def test_make_mesh_refuses_a_wrong_world_size(gloo_world_of_one):
    for shape in ((1, 4), (2, 1), (4,)):
        with pytest.raises(ValueError, match="needs"):
            LM.make_mesh(shape, ("data", "model")[:len(shape)],
                         device="cpu")
    with pytest.raises(ValueError, match="needs 256 ranks"):
        LM.make_production_mesh(device="cpu")
    with pytest.raises(ValueError, match="needs 512 ranks"):
        LM.make_production_mesh(multi_pod=True, device="cpu")
    mesh = LM.make_mesh((1, 1), ("data", "model"), device="cpu")
    assert mesh.shape == (1, 1) and mesh.axis_names == ("data", "model")
    assert mesh.group is not None and mesh.rank == 0
    # the collectives of a one-rank group: all_to_all and the per-axis
    # all_gather keep the values
    x = torch.arange(6.0).reshape(1, 2, 3)
    assert torch.equal(mesh.all_to_all(x, "model"), x)
    assert torch.equal(mesh.all_gather(x, "model", dim=2), x)
    assert torch.equal(mesh.all_gather(x, "data"), x)
    with pytest.raises(ValueError, match="size 1"):
        mesh.all_to_all(torch.zeros(2, 3), "model")
