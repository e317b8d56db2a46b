"""Port parity on the ``data`` axis: FSDP (ZeRO-3) parameters, training
under a ``model`` extent above 1, and context-parallel KV caches.

One module fixture starts 4 gloo ranks of the port (``rank_data`` in
``tests/torch_ranks.py``; CPU processes, a ``file://`` store, no network)
beside three jax subprocesses on 4 fake host devices (``REF_DATA``: the
JAX package under ``shardings.use_mesh`` of a ``jax.sharding.Mesh`` over
``devices().reshape(shape)``), all on the same weights (the reference's
pytree of the port's seeded init):

* on (data 2, model 2), each rank on its row of a global batch of 2,
  parameters sharded over both axes: the loss and every leaf's gradient
  (reassembled from the ranks' blocks) of minicpm (dense, tied),
  llama4-scout (MoE through ``moe_ffn_a2a``), zamba2 (chunked scan,
  ``tp_rmsnorm``) and rwkv6 (2 heads over model = 2, the gathered
  receptance) against ``jax.value_and_grad(next_token_loss)``: the loss
  within 1e-5 relative, each leaf within 1e-4 of its max |g|.  A leaf
  whose reference gradient is below 1e-6 of the model's largest is zero
  in exact arithmetic (llama4-scout's top-1 router: the normalised gate
  of one choice is 1) and holds rounding noise in both packages: the
  port's must stay below that bound too;
* the replicated leaves' gradients bit for bit equal on every rank that
  holds the same block, and 1/(D·M) of each leaf the spec shards over
  both axes on each rank;
* two int8-compressed steps of minicpm and llama4-scout on (2, 2)
  against the reference's ``train_step`` under a (2, 2) mesh: within
  1e-5 of max |p| outside the compression's rounding ties (≤ 1%);
* a checkpoint saved on (2, 2) and restored on (4, 1) and without a
  mesh: every parameter, μ, ν and error-feedback leaf equal;
* context-parallel prefill and decode at B = 1 on (4, 1) and (2, 2) of
  minicpm (k/v), deepseek-v2 (ckv/kr, the absorbed step), zamba2
  (``attn.k/v`` beside whole O(1) states), whisper (``xk``/``xv`` and
  ``k``/``v``) and gemma2 (its window of 32 across rank boundaries)
  against the reference's ``prefill_step``/``decode_step`` under the
  same mesh: within 1e-4 of max |logits|, the same logits on every rank.
"""
import concurrent.futures

import numpy as np
import pytest
import torch

import torch_ranks as TR
from repro_torch.configs.base import get_config
from repro_torch.core.mesh import REDUCE_SCATTER, Mesh
from repro_torch.models import shardings as SH
from repro_torch.models import transformer as T
from repro_torch.models.attention import split_slots
from repro_torch.models.weights import params_from_jax, reference_tree

LOSS_TOL = 1e-5       # relative
GRAD_TOL = 1e-4       # of each leaf's max |g|
ZERO_TOL = 1e-6       # of the model's largest |g|: a leaf that is zero
STEP_TOL = 1e-5       # of each leaf's max |p|
TOL_LOGITS = 1e-4     # of max |logits|
D, M = TR.TP_MESHES[TR.GRAD_MESH]


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("data")
    inp = TR.data_inputs()
    with concurrent.futures.ThreadPoolExecutor(1 + len(TR.REF_DATA)) as pool:
        refs = [pool.submit(TR.run_reference, job, 4, tmp, **inp)
                for job in TR.REF_DATA]
        ranks = pool.submit(TR.run_ranks, "rank_data", 4, tmp,
                            **dict(inp, ckpt_dir=str(tmp / "ckpt")))
        ref = {}
        for f in refs:
            ref.update(f.result())
        return inp, ref, ranks.result()


def _rel(got, want):
    return float(np.abs(got - want).max() / np.abs(want).max())


def _model(inp, arch):
    return params_from_jax(TR.nest_tree(inp, f"w/{arch}"),
                           get_config(arch).reduced(), device="cpu")


def _tree(model, out, prefix):
    """The reference pytree, flattened, of ``out``'s whole tensors under
    ``prefix``/<parameter name>."""
    return TR.flat_tree(reference_tree(model, {
        n: torch.from_numpy(out[f"{prefix}/{n}"])
        for n, _ in model.named_parameters()}), "")


@pytest.mark.parametrize("arch", TR.GRAD_ARCHS)
def test_loss_and_grads_on_both_axes_equal_reference(data, arch):
    """(2, 2): the global batch's loss and every reference leaf's
    gradient, each rank's blocks reassembled, against the reference's
    ``value_and_grad``."""
    inp, ref, ranks = data
    want_loss = float(ref[f"g/{arch}/loss"])
    want = TR.flat_tree(TR.nest_tree(ref, f"g/{arch}/grad"), "")
    model = _model(inp, arch)
    top = max(float(np.abs(w).max()) for w in want.values())
    for out in ranks:
        assert abs(float(out[f"g/{arch}/loss"]) - want_loss) <= \
            LOSS_TOL * abs(want_loss)
        got = _tree(model, out, f"g/{arch}/grad")
        assert got.keys() == want.keys()
        for key, w in want.items():
            scale = float(np.abs(w).max())
            if scale <= ZERO_TOL * top:
                assert np.abs(got[key]).max() <= ZERO_TOL * top, key
            else:
                assert _rel(got[key], w) <= GRAD_TOL, key


@pytest.mark.parametrize("arch", TR.GRAD_ARCHS)
def test_replicated_grads_agree_and_shards_are_one_in_d_m(data, arch):
    """Ranks that hold the same block of a leaf hold bit for bit the same
    gradient of it (the replicated leaves on all four); a leaf the spec
    shards over both axes is 1/(D·M) of itself on each rank, except where
    the explicit layout keeps columns whole (Mamba2's B/C, a KV head
    shared by a GQA group), and never more than 1/D."""
    inp, _, ranks = data
    model = _model(inp, arch)
    cfg = model.cfg
    for name, p in model.named_parameters():
        blocks = [out[f"pl/{arch}/{name}"] for out in ranks]
        grads = [out[f"gl/{arch}/{name}"] for out in ranks]
        # which elements each rank holds: its block of the element ids
        ids = torch.arange(p.numel(), dtype=torch.float64).reshape(p.shape)
        held = [SH.rank_block(name, ids, cfg, _StandIn((D, M), r))
                for r in range(4)]
        for r in range(4):
            np.testing.assert_array_equal(
                blocks[r], SH.rank_block(name, p.detach(), cfg,
                                         _StandIn((D, M), r)).numpy())
        for i in range(4):
            for j in range(i + 1, 4):
                if torch.equal(held[i], held[j]):
                    np.testing.assert_array_equal(grads[i], grads[j],
                                                  err_msg=name)
        spec = SH.leaf_spec(name, p.dim(), ("data", "model"))
        parent, leaf = name.split(".")[-2:] if "." in name else ("", name)
        kept_whole = (parent == "mamba" and leaf in ("in_proj", "conv_w",
                                                     "conv_b")) or (
            leaf in ("wk", "wv") and cfg.n_kv_heads % M)
        if "data" in spec:
            assert blocks[0].size * D <= p.numel(), name
        if "data" in spec and "model" in spec and not kept_whole:
            assert blocks[0].size * D * M == p.numel(), name
    assert sum("data" in SH.leaf_spec(n, p.dim(), ("data", "model"))
               for n, p in model.named_parameters()) >= cfg.n_layers


@pytest.mark.parametrize("arch", TR.STEP_ARCHS)
def test_compressed_steps_on_both_axes_equal_reference(data, arch):
    """Two int8-compressed steps on (2, 2) against the reference's
    ``train_step`` under a (2, 2) mesh, from the same weights on the same
    global batches: the losses within 1e-5 relative, every reference
    leaf within 1e-5 of its max |p| outside the port's rounding ties
    (≤ 1%)."""
    inp, ref, ranks = data
    np.testing.assert_allclose(ranks[0][f"s/{arch}/loss"],
                               ref[f"s/{arch}/loss"], rtol=LOSS_TOL)
    model = _model(inp, arch)
    got = _tree(model, ranks[0], f"s/{arch}/p")
    skip = _tree(model, ranks[0], f"s/{arch}/tie")
    want = TR.flat_tree(TR.nest_tree(ref, f"s/{arch}/ref"), "")
    assert got.keys() == want.keys()
    n_skip = sum(int(m.sum()) for m in skip.values())
    assert n_skip <= 0.01 * sum(a.size for a in want.values())
    for key, w in want.items():
        err = np.abs(got[key] - w)[~skip[key]]
        assert err.max(initial=0.0) <= STEP_TOL * np.abs(w).max(), key
    for out in ranks[1:]:
        for key in out:
            if key.startswith(f"s/{arch}/p/"):
                np.testing.assert_array_equal(out[key], ranks[0][key])


@pytest.mark.parametrize("target", ("41", "none"))
def test_checkpoint_saved_on_2x2_restores_elsewhere(data, target):
    """The trained llama4-scout and its AdamW and int8 state, saved whole
    on (2, 2), restored on (4, 1) (each rank's blocks) and without a
    mesh: every leaf equal, the step too."""
    _, _, ranks = data
    for out in ranks:
        assert bool(out[f"ck/{target}"])


CP_CASES = [(a, n) for a in TR.CP_RUNS for n in TR.CP_MESHES]


@pytest.mark.parametrize("arch,name", CP_CASES,
                         ids=[f"{a}-{n}" for a, n in CP_CASES])
def test_context_parallel_prefill_and_decode_equal_reference(data, arch,
                                                             name):
    """B = 1 on (4, 1) and (2, 2): the prefill's last logits and each
    decode step's, every rank holding the whole batch and its share of
    the positions, against the reference under the same mesh."""
    _, ref, ranks = data
    key = f"cp/{arch}/{name}"
    for out in ranks:
        assert _rel(out[key], ref[key]) <= TOL_LOGITS, key
        np.testing.assert_array_equal(out[key], ranks[0][key])


def test_context_parallel_caches_split_the_sequence(data):
    """Each rank's ``k``/``v``/``xk``/``xv``/``ckv``/``kr`` hold
    max_len / D (enc_len / D) positions of the whole batch; zamba2's
    ``ssm``/``conv`` are whole over the batch."""
    _, _, ranks = data
    for out in ranks:
        for arch, (max_len, _) in TR.CP_RUNS.items():
            cfg = get_config(arch).reduced()
            for name in TR.CP_MESHES:
                d = TR.TP_MESHES[name][0]
                pre = f"cpc/{arch}/{name}/"
                shapes = {k[len(pre):]: out[k].tolist() for k in out
                          if k.startswith(pre)}
                assert shapes
                for leaf, shape in shapes.items():
                    assert shape[1] == 1, (arch, leaf)
                    if leaf.split("/")[-1] in ("k", "v", "ckv", "kr"):
                        assert shape[2] == max_len // d, (arch, leaf)
                    if leaf in ("xk", "xv"):
                        assert shape[2] == cfg.enc_positions // d
                if arch == "zamba2_2p7b":
                    assert shapes["ssm"][2] == cfg.ssm_nheads // \
                        TR.TP_MESHES[name][1]


# -- the pieces alone, without ranks ------------------------------------------

def test_split_slots_write_only_the_owned_positions():
    """A step of 6 tokens at position 13 over 4 ranks of 8 positions:
    rank 1 writes its positions 13–15 from tokens 0–2, rank 2 positions
    16–18 from tokens 3–5, ranks 0 and 3 nothing; the start clamps into
    the global cache."""
    class _Data:
        def __init__(self, i):
            self.i = i

        def axis_index(self, axis):
            return self.i

        def extent(self, axis):
            return 4

    got = [split_slots(13, 6, 8, _Data(i)) for i in range(4)]
    assert [g[3] for g in got] == [0, 8, 16, 24]
    assert got[1][1:3] == (slice(5, 8), slice(0, 3))
    assert got[2][1:3] == (slice(0, 3), slice(3, 6))
    for g in (got[0], got[3]):
        assert g[1].stop == g[1].start and g[2].stop == g[2].start
    late = split_slots(40, 6, 8, _Data(3))
    assert late[0] == 40 and late[1:3] == (slice(2, 8), slice(0, 6))
    with pytest.raises(NotImplementedError):
        split_slots(torch.tensor([3]), 1, 8, _Data(0))


def test_reduce_scatter_on_a_world_of_one_and_the_counts():
    """``Mesh.reduce_scatter`` on a world of one is the identity, and no
    collective is counted."""
    from repro_torch import obs
    mesh = Mesh.local(("data", "model"), device="cpu")
    x = torch.arange(12.0).reshape(4, 3)
    before = obs.metrics.get(REDUCE_SCATTER)
    assert torch.equal(mesh.reduce_scatter(x, "data", dim=1), x)
    assert obs.metrics.get(REDUCE_SCATTER) == before


class _StandIn:
    def __init__(self, shape, rank):
        self.shape, self.axis_names, self.rank = tuple(shape), \
            ("data", "model"), rank

    def extent(self, axis):
        return self.shape[self.axis_names.index(axis)]

    def axis_index(self, axis):
        return int(np.unravel_index(self.rank, self.shape)[
            self.axis_names.index(axis)])


@pytest.mark.parametrize("arch", ("zamba2_2p7b", "rwkv6_7b",
                                  "llama4_scout_17b_a16e"))
def test_rank_blocks_tile_every_leaf_and_count_it_once(arch):
    """On (2, 2) stand-in ranks, ``rank_block`` of every leaf of a seeded
    model: each block's ``whole_shape`` is the leaf's, and the elements
    ``counted_once`` marks on the four ranks sum to the leaf's squared
    norm once (what the clip's global norm adds up)."""
    cfg = get_config(arch).reduced()
    model = T.init_params(cfg, 3, device="cpu")
    for name, p in model.named_parameters():
        total = 0.0
        for r in range(4):
            mesh = _StandIn((2, 2), r)
            blk = SH.rank_block(name, p.detach(), cfg, mesh)
            assert SH.whole_shape(name, blk.shape, cfg, mesh) == \
                tuple(p.shape), name
            part = SH.counted_once(name, blk, cfg, mesh)
            if part is False:
                continue
            sel = blk if part is True else blk[..., part]
            total += float((sel.double() ** 2).sum())
        want = float((p.detach().double() ** 2).sum())
        assert abs(total - want) <= 1e-9 * max(want, 1e-30), name
