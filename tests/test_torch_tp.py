"""Port parity for the decoder stack across ranks: tensor parallelism over
``model``, the expert-parallel ``moe_ffn_a2a`` and the data-parallel train
step.

One module fixture starts 4 gloo ranks of the port (``rank_stack`` in
``tests/torch_ranks.py``; CPU processes, a ``file://`` store, no network)
beside one jax subprocess on 4 fake host devices (``ref_stack``: the JAX
package under ``shardings.use_mesh`` of a ``jax.sharding.Mesh`` over
``devices().reshape(shape)``), both on the reference's own weights:

* ``moe_ffn_a2a`` on llama4-scout ``reduced()`` at capacity factor 1.25,
  where the per-(source shard → expert) capacity drops tokens, on
  (data, model) = (1, 4) and (2, 2), and its ``moe_ffn`` fallback on
  (4, 1) and on every S = 1 step: within 1e-6 of max |y|;
* the tensor-parallel forward, prefill and decode of llama4-scout,
  minicpm, internvl2 (its prefix embeddings) and starcoder2 (4 KV heads):
  within 1e-4 of max |logits| of the reference under the same mesh;
* three data-parallel train steps of minicpm and llama4-scout (MoE) on
  (data=4) with the int8 compression against the port's one-process
  steps on the global batch and the reference's ``train_step`` under a
  (4, 1) mesh: within 1e-5 of max |p| outside the compression's
  rounding ties.
"""
import concurrent.futures

import numpy as np
import pytest
import torch

import torch_ranks as TR
from repro_torch.configs.base import get_config
from repro_torch.models import moe as tM
from repro_torch.models.layers import ParamTree
from repro_torch.models.weights import params_from_jax, reference_tree
from repro_torch.train import train_step as tTS
from repro_torch.train.optimizer import OptConfig

TOL_MOE = 1e-6        # of max |y|: one MoE layer
TOL_LOGITS = 1e-4     # of max |logits|: the whole stack


@pytest.fixture(scope="module")
def stack(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("stack")
    inp = TR.stack_inputs()
    with concurrent.futures.ThreadPoolExecutor(2) as pool:
        ref = pool.submit(TR.run_reference, "ref_stack", 4, tmp, **inp)
        ranks = pool.submit(TR.run_ranks, "rank_stack", 4, tmp,
                            **dict(inp, ckpt_dir=str(tmp / "ckpt")))
        return inp, ref.result(), ranks.result()


def _rows(name, rank, b):
    d, m = TR.TP_MESHES[name]
    i = rank // m
    return slice(i * b // d, (i + 1) * b // d)


def _rel(got, want):
    return float(np.abs(got - want).max() / np.abs(want).max())


@pytest.mark.parametrize("name", sorted(TR.TP_MESHES))
def test_moe_a2a_equals_reference(stack, name):
    """Each rank's rows of ``moe_ffn_a2a`` equal the reference's
    ``shard_map`` a2a (or, on (4, 1), its ``moe_ffn`` fallback over the
    global batch): the same tokens drop."""
    _, ref, ranks = stack
    for r, out in enumerate(ranks):
        assert _rel(out[f"a2a/{name}"],
                    ref[f"a2a/{name}"][_rows(name, r, TR.MOE_B)]) <= TOL_MOE


def test_a2a_drops_other_tokens_than_moe_ffn(stack):
    """At capacity factor 1.25 the a2a's per-source capacity drops other
    tokens than ``moe_ffn``'s one group: the check above is not
    vacuous."""
    _, ref, _ = stack
    assert _rel(ref["a2a/14"], ref["moe_ffn"]) > 1e-2
    assert _rel(ref["a2a/41"], ref["moe_ffn"]) <= TOL_MOE


@pytest.mark.parametrize("name", sorted(TR.TP_MESHES))
def test_moe_a2a_one_token_steps_equal_moe_ffn(stack, name):
    """S = 1 (every decode step) takes the fallback on every mesh: the
    reference's ``moe_ffn``; with ``per_row`` each row dispatches alone,
    as the port's ``moe_ffn(per_row=True)`` without a mesh."""
    inp, ref, ranks = stack
    cfg = TR.stack_config(TR.MOE_ARCH, get_config)
    p = ParamTree({k: torch.tensor(v) for k, v in
                   TR.nest_tree(inp, "moe").items()})
    alone = tM.moe_ffn(p, torch.from_numpy(inp["moe_x1"]), cfg,
                       per_row=True).numpy()
    for r, out in enumerate(ranks):
        rows = _rows(name, r, TR.MOE_B)
        assert _rel(out[f"a2a1/{name}"], ref[f"a2a1/{name}"][rows]) <= TOL_MOE
        assert _rel(out[f"a2a1_rows/{name}"], alone[rows]) <= TOL_MOE


@pytest.mark.parametrize("arch,name", TR.TP_RUNS,
                         ids=[f"{a}-{n}" for a, n in TR.TP_RUNS])
def test_tensor_parallel_forward_and_decode_equal_reference(stack, arch,
                                                            name):
    """The forward's logits, the prefill's last logits and each decode
    step's, on each rank's rows, against the reference under the same
    mesh; ranks of one data row block hold the same logits."""
    _, ref, ranks = stack
    for kind in ("fwd", "dec"):
        key = f"{kind}/{arch}/{name}"
        for r, out in enumerate(ranks):
            assert _rel(out[key], ref[key][_rows(name, r, TR.TP_B)]) \
                <= TOL_LOGITS, (key, r)
            first = ranks[r - r % TR.TP_MESHES[name][1]][key]
            np.testing.assert_array_equal(out[key], first)


def test_caches_and_collectives_of_the_tensor_parallel_forward(stack):
    """Each rank caches the KV heads its query heads read (reduced
    llama4 has 1 KV head for 4 query heads: replicated), its rows of the
    batch; one forward issues an embedding psum, per layer one psum for
    the attention and one for the shared expert, two all-to-alls and a
    sequence all-gather, and one logits all-gather."""
    _, _, ranks = stack
    cfg = TR.stack_config("llama4_scout_17b_a16e", get_config)
    layers = cfg.n_layers
    for out in ranks:
        assert out["kv/llama4_scout_17b_a16e/14"].tolist() == [
            layers, TR.TP_B, TR.TP_S, 1, cfg.hd]
        assert out["kv/llama4_scout_17b_a16e/22"].tolist()[1] == TR.TP_B // 2
        assert out["kv/starcoder2_15b/14"].tolist()[3] == 1   # 4 KV / 4
        assert out["calls/llama4_scout_17b_a16e/14"].tolist() == [
            1 + 2 * layers, layers + 1, 2 * layers]
        mcfg = TR.stack_config("minicpm_2b", get_config)
        assert out["calls/minicpm_2b/14"].tolist() == [
            1 + 2 * mcfg.n_layers, 1, 0]


def test_all_to_all_and_per_axis_all_gather(stack):
    """``Mesh.all_to_all`` on (1, 4): rank j receives 10·i + j from each
    rank i, in order; the per-axis ``all_gather`` on (2, 2) gathers the
    model row, the data column and, with no axis, the whole mesh."""
    _, _, ranks = stack
    for r, out in enumerate(ranks):
        assert out["probe_a2a"][:, 0].tolist() == [10 * i + r
                                                   for i in range(4)]
        row, col = divmod(r, 2)
        assert out["probe_gather_model"].tolist() == [[2 * row, 2 * row + 1]]
        assert out["probe_gather_data"][:, 0].tolist() == [col, col + 2]
        assert out["probe_gather_all"][:, 0].tolist() == [0, 1, 2, 3]


def test_place_experts_over_the_model_axis(stack):
    """``place_experts(p, perm, mesh)`` on (1, 4): each rank holds its
    block of the placed stack, and the router's permuted columns."""
    inp, _, ranks = stack
    whole = TR.nest_tree(inp, "moe")
    placed = whole["w_gate"][inp["perm"]]
    for r, out in enumerate(ranks):
        np.testing.assert_array_equal(out["placed_w_gate"],
                                      placed[2 * r:2 * r + 2])
        np.testing.assert_array_equal(out["placed_router"],
                                      whole["router"][:, inp["perm"]])


def _one_process_steps(inp, arch):
    """Three steps of the port on the global batch in this process, from
    the reference's weights, with the compression's rounding ties
    recorded."""
    cfg = TR.stack_config(arch, get_config)
    model = params_from_jax(TR.nest_tree(inp, f"w/{arch}"), cfg,
                            device="cpu")
    opt = tTS.init_opt_state(model, grad_compress=True)
    step = tTS.make_train_step(cfg, OptConfig(**TR.DP_OPT), remat="full",
                               grad_compress=True)
    ties, real = {}, tTS._compress_group

    def recording(gs, errs):
        names = {id(q.grad): n for n, q in model.named_parameters()}
        ties.update(TR.tie_records(torch, [names[id(a)] for a in gs], gs,
                                   errs, ties))
        return real(gs, errs)

    losses = []
    tTS._compress_group = recording
    try:
        for i in range(TR.DP_STEPS):
            model, opt, m = step(model, opt, {"tokens": torch.from_numpy(
                inp[f"dp_tokens/{arch}"][i])})
            losses.append(float(m["loss"]))
    finally:
        tTS._compress_group = real
    return model, ties, losses


@pytest.mark.parametrize("arch", TR.DP_ARCHS)
def test_data_parallel_steps_equal_one_process(stack, arch):
    """(data=4): each rank's 2 rows, the loss and grads averaged over the
    ranks before the int8 compression and AdamW: the global batch's
    losses within 1e-5 relative, every parameter within 1e-5 of its max
    |p| (rounding ties, recorded in both runs, left out: ≤ 1%), and the
    four replicas bit for bit equal.  llama4-scout's MoE layers dispatch
    the global batch as one group, from rows gathered over ``data``."""
    inp, _, ranks = stack
    model, ties, losses = _one_process_steps(inp, arch)
    np.testing.assert_allclose(ranks[0][f"dp/{arch}/loss"], losses,
                               rtol=1e-5)
    n_skip = n_all = 0
    for name, p in model.named_parameters():
        want = p.detach().numpy()
        skip = ties[name] | ranks[0][f"dp/{arch}/tie/{name}"]
        n_skip += int(skip.sum())
        n_all += skip.size
        err = np.abs(ranks[0][f"dp/{arch}/p/{name}"] - want)[~skip]
        assert err.max(initial=0.0) <= 1e-5 * np.abs(want).max(), name
        for out in ranks[1:]:
            np.testing.assert_array_equal(out[f"dp/{arch}/p/{name}"],
                                          ranks[0][f"dp/{arch}/p/{name}"])
    assert n_skip <= 0.01 * n_all


@pytest.mark.parametrize("arch", TR.DP_ARCHS)
def test_data_parallel_steps_equal_reference(stack, arch):
    """The same three steps against the reference's ``train_step`` under
    ``use_mesh`` of a (4, 1) mesh of fake devices, from the same weights
    on the same global batches: the losses within 1e-5 relative, every
    reference leaf within 1e-5 of its max |p| outside the port's int8
    rounding ties (≤ 1%).  On llama4-scout the layers below each MoE
    layer learn through the rank's own rows of its gathered batch."""
    inp, ref, ranks = stack
    cfg = TR.stack_config(arch, get_config)
    np.testing.assert_allclose(ranks[0][f"dp/{arch}/loss"],
                               ref[f"dp/{arch}/loss"], rtol=1e-5)
    model = params_from_jax(TR.nest_tree(inp, f"w/{arch}"), cfg,
                            device="cpu")

    def tree(kind):
        return reference_tree(model, {n: torch.from_numpy(
            ranks[0][f"dp/{arch}/{kind}/{n}"])
            for n, _ in model.named_parameters()})

    got = TR.flat_tree(tree("p"), "")
    skip = TR.flat_tree(tree("tie"), "")
    want = TR.flat_tree(TR.nest_tree(ref, f"dp/{arch}/ref"), "")
    assert got.keys() == want.keys()
    n_skip = sum(int(m.sum()) for m in skip.values())
    assert n_skip <= 0.01 * sum(a.size for a in want.values())
    for key, w in want.items():
        err = np.abs(got[key] - w)[~skip[key]]
        assert err.max(initial=0.0) <= 1e-5 * np.abs(w).max(), key


def test_checkpoints_under_a_mesh(stack):
    """``run_resilient`` under the mesh with a failure injected at step 1
    of 2: rank 0 writes, every rank restores and restarts once, and the
    replicas end equal."""
    _, _, ranks = stack
    for out in ranks:
        assert int(out["ckpt_restarts"]) == 1
        np.testing.assert_array_equal(out["ckpt_embed"],
                                      ranks[0]["ckpt_embed"])


def test_sharded_init_holds_the_unsharded_weights(stack):
    """``init_params(mesh=)`` on (1, 4) and (2, 2): every parameter is the
    rank's ``tp_block`` of the unsharded model's from the same seed."""
    _, _, ranks = stack
    for out in ranks:
        assert out["init_equal"].tolist() == [True, True]
