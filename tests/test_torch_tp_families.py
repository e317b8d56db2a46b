"""Port parity for tensor parallelism over ``model`` on the four families
that PR 22's layout left out: the hybrid (zamba2's Mamba2 stack and its
shared attention block), deepseek-v2's MLA with its MoE, whisper's
encoder and cross-attention, and rwkv6's time and channel mixes.

One module fixture starts 4 gloo ranks of the port (``rank_families`` in
``tests/torch_ranks.py``; CPU processes, a ``file://`` store, no
network) beside one jax subprocess on 4 fake host devices
(``ref_families``: the JAX package under ``shardings.use_mesh`` of a
``jax.sharding.Mesh`` over ``devices().reshape(shape)``), both on the
reference's own weights (``params_from_jax(..., mesh=)`` on the ranks):

* the forward, prefill and decode of reduced zamba2, deepseek-v2 and
  whisper on (data, model) = (1, 4), and of rwkv6 (2 heads) on (2, 2):
  within 1e-4 of max |logits|;
* deepseek-v2's ``moe_ffn_a2a`` (top-2, capacity factor 1.25) on (1, 4)
  and (2, 2): within 1e-6 of max |y|;
* the caches each rank holds, the collectives of one forward, the
  batcher's reset of a reused slot on a rank, the sharded init.

The layout's pieces are also checked alone: `tp_block`'s Mamba2 segment
and conv splits and rwkv6's per-head leaves against hand slices,
`tp_rmsnorm` at a ``model`` extent of 1 (bit for bit `rmsnorm`) and over
a split width, and `check_tp` where the heads do not split.
"""
import concurrent.futures
import dataclasses

import numpy as np
import pytest
import torch

import torch_ranks as TR
from repro_torch.configs.base import get_config
from repro_torch.core.mesh import Mesh
from repro_torch.models import shardings as SH
from repro_torch.models.layers import rmsnorm

TOL_MOE = 1e-6        # of max |y|: one MoE layer
TOL_LOGITS = 1e-4     # of max |logits|: the whole stack


@pytest.fixture(scope="module")
def families(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("families")
    inp = TR.family_inputs()
    with concurrent.futures.ThreadPoolExecutor(2) as pool:
        ref = pool.submit(TR.run_reference, "ref_families", 4, tmp, **inp)
        ranks = pool.submit(TR.run_ranks, "rank_families", 4, tmp, **inp)
        return inp, ref.result(), ranks.result()


def _rows(name, rank, b):
    d, m = TR.TP_MESHES[name]
    i = rank // m
    return slice(i * b // d, (i + 1) * b // d)


def _rel(got, want):
    return float(np.abs(got - want).max() / np.abs(want).max())


@pytest.mark.parametrize("arch,name", TR.FAM_RUNS,
                         ids=[f"{a}-{n}" for a, n in TR.FAM_RUNS])
def test_tensor_parallel_forward_and_decode_equal_reference(families, arch,
                                                            name):
    """The forward's logits (whisper's with its frames), the prefill's
    last logits and each decode step's, on each rank's rows, against the
    reference under the same mesh; the ranks of one data row block hold
    the same logits."""
    _, ref, ranks = families
    for kind in ("fwd", "dec"):
        key = f"{kind}/{arch}/{name}"
        for r, out in enumerate(ranks):
            assert _rel(out[key], ref[key][_rows(name, r, TR.FAM_B)]) \
                <= TOL_LOGITS, (key, r)
            first = ranks[r - r % TR.TP_MESHES[name][1]][key]
            np.testing.assert_array_equal(out[key], first)


@pytest.mark.parametrize("name", TR.DS_MESHES)
def test_deepseek_moe_a2a_equals_reference(families, name):
    """deepseek-v2's routed experts at top-2 with its shared expert: each
    rank's rows of ``moe_ffn_a2a`` equal the reference's ``shard_map``
    a2a, whose per-source capacity drops other tokens than ``moe_ffn``'s
    one group (so a wrong capacity misses by O(1))."""
    _, ref, ranks = families
    assert _rel(ref[f"a2a/{name}"], ref["moe_ffn"]) > 1e-2
    for r, out in enumerate(ranks):
        assert _rel(out[f"a2a/{name}"],
                    ref[f"a2a/{name}"][_rows(name, r, TR.MOE_B)]) <= TOL_MOE


def test_caches_hold_the_ranks_heads(families):
    """On (1, 4) with 4 query heads and 4 KV heads each rank caches one KV
    head: zamba2's shared attention (``attn.k/v``) and whisper's self- and
    cross-attention (``xk``/``xv``); zamba2's ``ssm`` its one SSM head of
    4 and ``conv`` its 32 x channels with all 2·16 B/C channels; rwkv6's
    ``wkv`` (on (2, 2)) its one head of 2 and 2 of the 4 rows; MLA's
    ``ckv``/``kr`` whole."""
    _, _, ranks = families
    zc = get_config("zamba2_2p7b").reduced()
    for out in ranks:
        c = {k.split("/", 2)[2]: v.tolist() for k, v in out.items()
             if k.startswith("cache/zamba2")}
        assert c["attn/k"] == c["attn/v"] == [
            zc.n_layers // zc.attn_every, TR.FAM_B, TR.FAM_S, 1, zc.hd]
        assert c["ssm"] == [zc.n_layers, TR.FAM_B, 1, zc.ssm_state,
                            zc.ssm_head_dim]
        assert c["conv"] == [zc.n_layers, TR.FAM_B, zc.ssm_conv - 1,
                             zc.d_inner // 4 + 2 * zc.ssm_state]
        for leaf in ("k", "v", "xk", "xv"):
            assert out[f"cache/whisper_medium/{leaf}"].tolist()[3] == 1
        assert out["cache/whisper_medium/xk"].tolist()[2] == 32
        assert out["cache/rwkv6_7b/wkv"].tolist() == [4, 2, 1, 32, 32]
        assert out["cache/rwkv6_7b/prev"].tolist() == [4, 2, 64]
        assert out["cache/deepseek_v2_236b/ckv"].tolist() == [
            4, TR.FAM_B, TR.FAM_S, 32]


def test_collectives_of_one_forward(families):
    """The all-reduce, all-gather and all-to-all calls of one forward:
    the embedding's psum; zamba2 per Mamba layer the gated norm's and
    ``out_proj``'s psums and per shared-block application the attention's
    and the MLP's; deepseek-v2 per layer MLA's and the shared expert's
    psums, two all-to-alls and the sequence's all-gather; rwkv6 per layer
    the time mix's norm and output and the channel mix's value product,
    and the receptance's all-gather; whisper per encoder layer two and
    per decoder layer three psums; one logits all-gather each."""
    _, _, ranks = families
    for out in ranks:
        assert out["calls/zamba2_2p7b/14"].tolist() == [1 + 2 * 4 + 2 * 2,
                                                        1, 0]
        assert out["calls/deepseek_v2_236b/14"].tolist() == [1 + 2 * 4,
                                                             4 + 1, 2 * 4]
        assert out["calls/rwkv6_7b/22"].tolist() == [1 + 3 * 4, 4 + 1, 0]
        assert out["calls/whisper_medium/14"].tolist() == [
            1 + 2 * 2 + 3 * 4, 1, 0]


@pytest.mark.parametrize("arch", ("zamba2_2p7b", "rwkv6_7b"))
def test_batcher_resets_a_reused_slot_on_a_rank(families, arch):
    """A stream of 5 requests through 2 slots: on (1, 4), with slot 0's
    Mamba2 / rwkv6 state poisoned before each prefill into it, the
    batcher serves the tokens and prefill logits of the clean batcher
    without a mesh (the rank's whole model)."""
    _, _, ranks = families
    for out in ranks:
        key = f"serve/{arch}"
        np.testing.assert_array_equal(out[f"{key}/mesh/tokens"],
                                      out[f"{key}/none/tokens"])
        assert _rel(out[f"{key}/mesh/logits"],
                    out[f"{key}/none/logits"]) <= TOL_LOGITS
        assert len(out[f"{key}/mesh/tokens"]) == sum(
            n for _, _, n in TR.SERVE_STREAM)


def test_sharded_init_holds_the_unsharded_weights(families):
    """``init_params(mesh=)`` of each family: every parameter is the
    rank's ``tp_block`` of the unsharded model's from the same seed."""
    _, _, ranks = families
    for out in ranks:
        for arch in TR.FAM_ARCHS:
            assert bool(out[f"init_equal/{arch}"]), arch


class _StandIn:
    """The layout of one rank of a mesh, without a process group."""

    def __init__(self, shape, rank):
        self.shape, self.axis_names, self.rank = tuple(shape), \
            ("data", "model"), rank

    def extent(self, axis):
        return self.shape[self.axis_names.index(axis)]

    def axis_index(self, axis):
        return int(np.unravel_index(self.rank, self.shape)[
            self.axis_names.index(axis)])


def test_tp_block_splits_mamba2_segments_and_conv():
    """``in_proj`` [z | x | B | C | dt]: rank r holds its slice of z, of x
    and of dt and all of B and C; ``conv_w``/``conv_b`` [x | B | C]: its
    x channels and all B/C channels; a_log, dt_bias, d_skip by head,
    gate_gamma by channel, out_proj by rows."""
    cfg = get_config("zamba2_2p7b").reduced()
    di, n, nh, m = cfg.d_inner, cfg.ssm_state, cfg.ssm_nheads, 4
    dl, hl = di // m, nh // m
    in_proj = torch.arange(3 * (2 * di + 2 * n + nh), dtype=torch.float32) \
        .reshape(3, -1)
    conv = torch.arange(4 * (di + 2 * n), dtype=torch.float32).reshape(4, -1)
    for r in range(m):
        mesh = _StandIn((1, m), r)
        z, x = in_proj[:, r * dl:(r + 1) * dl], \
            in_proj[:, di + r * dl:di + (r + 1) * dl]
        bc = in_proj[:, 2 * di:2 * di + 2 * n]
        dt = in_proj[:, 2 * di + 2 * n + r * hl:2 * di + 2 * n + (r + 1) * hl]
        assert torch.equal(SH.tp_block("blocks.0.mamba.in_proj", in_proj,
                                       cfg, mesh),
                           torch.cat([z, x, bc, dt], -1))
        want = torch.cat([conv[:, r * dl:(r + 1) * dl], conv[:, di:]], -1)
        assert torch.equal(SH.tp_block("mamba.conv_w", conv, cfg, mesh),
                           want)
        assert torch.equal(SH.tp_block("mamba.conv_b", conv[0], cfg, mesh),
                           want[0])
        heads = torch.arange(float(nh))
        for leaf in ("a_log", "dt_bias", "d_skip"):
            assert SH.tp_block(f"mamba.{leaf}", heads, cfg, mesh).tolist() \
                == heads[r * hl:(r + 1) * hl].tolist()
        gamma = torch.arange(float(di))
        assert torch.equal(SH.tp_block("mamba.gate_gamma", gamma, cfg, mesh),
                           gamma[r * dl:(r + 1) * dl])
        out = torch.arange(float(di * 5)).reshape(di, 5)
        assert torch.equal(SH.tp_block("mamba.out_proj", out, cfg, mesh),
                           out[r * dl:(r + 1) * dl])


def test_tp_block_keeps_rwkv6_and_mla_leaves_by_head():
    """rwkv6 on (2, 2): the time mix's r/k/v/g in column blocks, wo in
    row blocks, w0/w2/u/ln_gamma by the rank's channels, w1 and the mu's
    whole; the channel mix's wr and wk by columns, wv by rows.  MLA:
    wuq/wuk/wuv by the rank's heads, wo by rows, the latent path whole."""
    cfg = get_config("rwkv6_7b").reduced()
    d, half = cfg.d_model, cfg.d_model // 2
    sq = torch.arange(float(d * d)).reshape(d, d)
    vec = torch.arange(float(d))
    for r in range(4):
        mesh = _StandIn((2, 2), r)
        j = r % 2
        cols, rows = sq[:, j * half:(j + 1) * half], sq[j * half:(j + 1) * half]
        for leaf in ("wr", "wk", "wv", "wg"):
            assert torch.equal(SH.tp_block(f"tmix.{leaf}", sq, cfg, mesh),
                               cols)
        assert torch.equal(SH.tp_block("tmix.wo", sq, cfg, mesh), rows)
        for leaf in ("w0", "u", "ln_gamma"):
            assert torch.equal(SH.tp_block(f"tmix.{leaf}", vec, cfg, mesh),
                               vec[j * half:(j + 1) * half])
        w2 = torch.arange(float(64 * d)).reshape(64, d)
        assert torch.equal(SH.tp_block("tmix.w2", w2, cfg, mesh),
                           w2[:, j * half:(j + 1) * half])
        w1 = torch.zeros(d, 64)
        assert SH.tp_block("tmix.w1", w1, cfg, mesh) is w1
        assert SH.tp_block("tmix.mu_r", vec, cfg, mesh) is vec
        assert torch.equal(SH.tp_block("cmix.wr", sq, cfg, mesh), cols)
        ff = torch.arange(float(d * cfg.d_ff)).reshape(d, cfg.d_ff)
        assert torch.equal(SH.tp_block("cmix.wk", ff, cfg, mesh),
                           ff[:, j * cfg.d_ff // 2:(j + 1) * cfg.d_ff // 2])
        assert torch.equal(SH.tp_block("cmix.wv", ff.T, cfg, mesh),
                           ff.T[j * cfg.d_ff // 2:(j + 1) * cfg.d_ff // 2])
    ds = get_config("deepseek_v2_236b").reduced()
    h, qk = ds.n_heads, ds.nope_head_dim + ds.rope_head_dim
    wuq = torch.arange(float(ds.q_lora * h * qk)).reshape(ds.q_lora, -1)
    wuk = torch.arange(float(ds.kv_lora * h * ds.nope_head_dim)) \
        .reshape(ds.kv_lora, -1)
    wo = torch.arange(float(h * ds.v_head_dim * 3)).reshape(-1, 3)
    wdkv = torch.zeros(ds.d_model, ds.kv_lora)
    for r in range(4):
        mesh = _StandIn((1, 4), r)
        assert torch.equal(SH.tp_block("attn.wuq", wuq, ds, mesh),
                           wuq[:, r * qk:(r + 1) * qk])
        dn = ds.nope_head_dim
        assert torch.equal(SH.tp_block("attn.wuk", wuk, ds, mesh),
                           wuk[:, r * dn:(r + 1) * dn])
        dv = ds.v_head_dim
        assert torch.equal(SH.tp_block("attn.wo", wo, ds, mesh),
                           wo[r * dv:(r + 1) * dv])
        for leaf in ("wdq", "wdkv", "wkr"):
            assert SH.tp_block(f"attn.{leaf}", wdkv, ds, mesh) is wdkv


def test_tp_rmsnorm_at_one_rank_is_rmsnorm():
    """At a ``model`` extent of 1 (no mesh, or a local (1, 1) mesh) the
    norm is `rmsnorm` bit for bit."""
    gen = torch.Generator().manual_seed(0)
    x = torch.randn(2, 5, 48, generator=gen)
    g = torch.randn(48, generator=gen) * 0.1
    want = rmsnorm(x, g, 1e-5)
    assert torch.equal(SH.tp_rmsnorm(x, g, 1e-5), want)
    with SH.use_mesh(Mesh.local(("data", "model"), device="cpu")):
        assert torch.equal(SH.tp_rmsnorm(x, g, 1e-5), want)


def test_tp_rmsnorm_divides_by_the_global_width(monkeypatch):
    """Over a split width the sum of squares is summed over ``model`` and
    divided by the whole width: with two ranks holding the same half (a
    psum that doubles), the norm of [x, x] on its first half."""
    mesh = Mesh.local(("data", "model"), device="cpu")
    monkeypatch.setattr(mesh, "shape", (1, 2))
    monkeypatch.setattr(mesh, "psum", lambda t, axis: t * 2)
    gen = torch.Generator().manual_seed(1)
    x = torch.randn(3, 4, 16, generator=gen)
    g = torch.randn(16, generator=gen) * 0.1
    want = rmsnorm(torch.cat([x, x], -1), torch.cat([g, g]), 1e-5)[..., :16]
    with SH.use_mesh(mesh):
        torch.testing.assert_close(SH.tp_rmsnorm(x, g, 1e-5), want,
                                   rtol=0, atol=1e-6)


def test_check_tp_admits_the_families_and_raises_where_heads_do_not_split():
    for arch in ("zamba2_2p7b", "rwkv6_7b", "whisper_medium",
                 "deepseek_v2_236b"):
        SH.check_tp(get_config(arch), 4)             # every full width
    for arch in ("zamba2_2p7b", "whisper_medium", "deepseek_v2_236b"):
        SH.check_tp(get_config(arch).reduced(), 4)
    rw = get_config("rwkv6_7b").reduced()            # 2 heads of 32
    SH.check_tp(rw, 2)
    with pytest.raises(ValueError, match="2 rwkv6 heads"):
        SH.check_tp(rw, 4)
    zc = dataclasses.replace(get_config("zamba2_2p7b").reduced(),
                             ssm_expand=3)           # 6 SSM heads
    with pytest.raises(ValueError, match="6 SSM heads"):
        SH.check_tp(zc, 4)
    with pytest.raises(ValueError, match="query heads"):
        SH.check_tp(get_config("whisper_medium").reduced(), 3)
    ds = dataclasses.replace(get_config("deepseek_v2_236b").reduced(),
                             n_experts=6)
    with pytest.raises(ValueError, match="6 experts"):
        SH.check_tp(ds, 4)
