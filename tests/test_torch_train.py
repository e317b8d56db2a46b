"""The port's training stack (``repro_torch/train``) held to the contracts
of tests/test_train_serve.py: the loss falls on reduced minicpm, the WSD
schedule, deterministic sharded data, atomic checkpoints that refuse a
mismatched tree, a restart that reproduces an uninterrupted run, the
straggler watchdog, int8 error feedback and balanced contiguous pipeline
stages, each also against the JAX package where it has an output to
compare (the schedule, the token stream, the stages)."""
import dataclasses
import json
import os

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from repro.configs.base import get_config as r_get_config
from repro.train import data as r_data
from repro.train import optimizer as r_opt
from repro.train import pipeline as r_pipeline

from repro_torch.configs.base import get_config
from repro_torch.models import transformer as T
from repro_torch.train import checkpoint as tckpt
from repro_torch.train.checkpoint import latest_step, restore, save
from repro_torch.train.data import (CorpusReader, DataConfig, batches,
                                    synthetic_tokens)
from repro_torch.train.fault import Watchdog, run_resilient
from repro_torch.train.optimizer import OptConfig, schedule_lr
from repro_torch.train.pipeline import partition_layers
from repro_torch.train.train_step import (_compress_int8, init_opt_state,
                                          make_train_step)

CFG = get_config("minicpm_2b").reduced()
OPT = OptConfig(peak_lr=2e-3, warmup_steps=5, stable_steps=60, decay_steps=10)
DC = DataConfig(vocab=CFG.vocab, seq_len=24, global_batch=8)


@pytest.fixture(scope="module")
def step_fn():
    return make_train_step(CFG, OPT, remat="full")


def _model():
    return T.init_params(CFG, 0, device="cpu")


def test_loss_falls(step_fn):
    model = _model()
    opt = init_opt_state(model)
    it = batches(DC, device="cpu")
    losses = []
    for _ in range(40):
        model, opt, m = step_fn(model, opt, next(it))
        losses.append(float(m["loss"]))
    assert losses[-1] < losses[0] - 0.4, losses[::10]
    assert int(opt["step"]) == 40


def test_train_step_records_a_span(step_fn):
    from repro_torch import obs
    model = _model()
    rec = obs.Recorder("train")
    with obs.use(rec):
        step_fn(model, init_opt_state(model), next(batches(DC, device="cpu")))
    begins = [e for e in rec.events
              if e["name"] == "train/step" and e["ph"] == "B"]
    assert len(begins) == 1
    assert begins[0]["args"] == {"tokens": DC.global_batch * DC.seq_len}


def test_wsd_schedule_shape():
    lrs = [float(schedule_lr(OPT, torch.tensor(s, dtype=torch.int32)))
           for s in range(90)]
    assert lrs[2] < lrs[10]                     # warmup
    assert abs(lrs[30] - OPT.peak_lr) < 1e-9    # stable plateau
    assert lrs[-1] < 0.3 * OPT.peak_lr          # sharp decay


@pytest.mark.parametrize("schedule", ["wsd", "cosine", "const"])
def test_schedule_matches_reference(schedule):
    kw = dict(peak_lr=2e-3, warmup_steps=5, stable_steps=60, decay_steps=10,
              schedule=schedule)
    cfg, rcfg = OptConfig(**kw), r_opt.OptConfig(**kw)
    got = np.array([float(schedule_lr(cfg, s)) for s in range(90)])
    want = np.array([float(r_opt.schedule_lr(rcfg, jnp.int32(s)))
                     for s in range(90)])
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-7)


def test_data_determinism_and_sharding():
    a = synthetic_tokens(3, 0, 2, DC)
    b = synthetic_tokens(3, 0, 2, DC)
    c = synthetic_tokens(3, 1, 2, DC)
    assert np.array_equal(a, b)
    assert not np.array_equal(a, c)
    assert a.shape == (DC.global_batch // 2, DC.seq_len + 1)


def test_data_matches_reference(tmp_path):
    rdc = r_data.DataConfig(vocab=DC.vocab, seq_len=DC.seq_len,
                            global_batch=DC.global_batch)
    for step, shard, n in ((0, 0, 1), (3, 0, 2), (3, 1, 2), (17, 3, 4)):
        got = synthetic_tokens(step, shard, n, DC)
        want = r_data.synthetic_tokens(step, shard, n, rdc)
        assert got.dtype == want.dtype and np.array_equal(got, want)
    it, rit = batches(DC, start_step=5, device="cpu"), r_data.batches(
        rdc, start_step=5)
    for _ in range(3):
        got, want = next(it)["tokens"], np.asarray(next(rit)["tokens"])
        assert got.dtype == torch.int64 and np.array_equal(got.numpy(), want)
    corpus = tmp_path / "corpus.bin"
    corpus.write_bytes(bytes(np.random.default_rng(0).integers(
        0, 256, 4000, dtype=np.uint8)))
    cdc = DataConfig(vocab=200, seq_len=16, global_batch=4,
                     corpus_path=str(corpus))
    rcdc = r_data.DataConfig(vocab=200, seq_len=16, global_batch=4,
                             corpus_path=str(corpus))
    assert np.array_equal(CorpusReader(str(corpus), cdc).batch(2, 1, 2),
                          r_data.CorpusReader(str(corpus), rcdc)
                          .batch(2, 1, 2))
    assert np.array_equal(next(batches(cdc, device="cpu"))["tokens"].numpy(),
                          np.asarray(next(r_data.batches(rcdc))["tokens"]))


def test_checkpoint_atomic_roundtrip(tmp_path):
    model = _model()
    opt = init_opt_state(model)
    d = str(tmp_path / "ck")
    save(d, 5, (model, opt))
    save(d, 10, (model, opt))
    assert latest_step(d) == 10
    assert sorted(os.listdir(d)) == ["step_00000005", "step_00000010"]
    with open(os.path.join(d, "step_00000010", "manifest.json")) as f:
        manifest = json.load(f)
    assert manifest["names"][0] == "0.embed"
    assert manifest["names"][-1] == "1.step"
    # a restore overwrites the live tensors in place
    other = T.init_params(CFG, 1, device="cpu")
    other_opt = init_opt_state(other)
    embed = other.embed
    (m2, o2), manifest = restore(d, (other, other_opt))
    assert manifest["step"] == 10 and m2 is other and o2 is other_opt
    assert other.embed is embed
    for (n, a), (_, b) in zip(model.state_dict().items(),
                              other.state_dict().items()):
        assert torch.equal(a, b), n
    # structure mismatch refused
    with pytest.raises(ValueError):
        restore(d, (model,))
    deeper = T.init_params(
        dataclasses.replace(CFG, n_layers=CFG.n_layers + 1), 0, device="cpu")
    with pytest.raises(ValueError):
        restore(d, (deeper, init_opt_state(deeper)))
    with pytest.raises(ValueError):           # same count, other names
        restore(d, (model, {"nu": opt["nu"], "mu2": opt["mu"],
                            "step": opt["step"]}))
    with pytest.raises(ValueError):           # same names, other shape
        restore(d, (model, {**opt, "step": torch.zeros(2, dtype=torch.int32)}))


def test_checkpoint_retention_keeps_newest_three(tmp_path):
    d = str(tmp_path / "ck")
    tree = {"w": torch.arange(4.0)}
    for s in (1, 2, 3, 4, 5):
        save(d, s, tree)
    assert sorted(os.listdir(d)) == [f"step_{s:08d}" for s in (3, 4, 5)]
    with pytest.raises(TypeError):
        tckpt.save(d, 6, {"w": np.zeros(3)})


def test_fault_injection_restart_reproduces(tmp_path, step_fn):
    data_fn = lambda start: batches(DC, start_step=start,  # noqa: E731
                                    device="cpu")
    ma = _model()
    pa, _, info = run_resilient(step_fn, ma, init_opt_state(ma), data_fn,
                                15, str(tmp_path / "a"), ckpt_every=5,
                                fail_at=8)
    assert info["restarts"] == 1 and pa is ma
    mb = _model()
    pb, _, _ = run_resilient(step_fn, mb, init_opt_state(mb), data_fn,
                             15, str(tmp_path / "b"), ckpt_every=5)
    for (n, a), (_, b) in zip(pa.named_parameters(), pb.named_parameters()):
        np.testing.assert_allclose(a.detach().numpy(), b.detach().numpy(),
                                   atol=1e-6, err_msg=n)


def test_watchdog_flags_stragglers():
    wd = Watchdog(straggler_factor=2.0)
    for _ in range(10):
        wd.observe(0.1)
    assert wd.observe(0.5)
    assert not wd.observe(0.11)


def test_grad_compression_error_feedback():
    g = torch.from_numpy(np.random.default_rng(0).standard_normal(1000)
                         .astype(np.float32))
    err = torch.zeros_like(g)
    total = torch.zeros_like(g)
    # over steps, error feedback keeps the running sum unbiased
    for _ in range(20):
        deq, err = _compress_int8(g, err)
        total = total + deq
    np.testing.assert_allclose((total / 20).numpy(), g.numpy(), atol=0.05)


def test_pipeline_partition_balanced():
    stage = partition_layers(get_config("mistral_large_123b"), 8,
                             device="cpu")
    sizes = np.bincount(stage, minlength=8)
    assert sizes.max() - sizes.min() <= 1
    # contiguity
    assert np.all(np.diff(stage) >= 0)


@pytest.mark.parametrize("arch,stages", [("mistral_large_123b", 8),
                                         ("minicpm_2b", 4),
                                         ("minicpm_2b", 1)])
def test_pipeline_partition_matches_reference(arch, stages):
    got = partition_layers(get_config(arch), stages, device="cpu")
    want = r_pipeline.partition_layers(r_get_config(arch), stages)
    assert got.dtype == want.dtype and np.array_equal(got, want)


def test_entry_points_need_a_card_unless_told_cpu():
    if torch.cuda.is_available():
        pytest.skip("a card is present: device=None is valid here")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        next(batches(DC))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        partition_layers(get_config("minicpm_2b"), 4)
