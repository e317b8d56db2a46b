"""The layer spans of the port's model and training paths (`repro_torch.obs`):
each forward and train step gives its spans with the right counts and
parents, the blocks' recomputation under remat included; nothing the
model computes changes under a recorder or a profiler; with neither the
span sites stay on `NULL` and keep nothing; a torch.profiler session with
no recorder installed gets a recorder of its own (`obs.profiled`) holding
that session's spans only, each a host operation of the profiler's, never
a user annotation; device times resolve from event pairs (faked here: the
CPU has no CUDA events) into `span_times`, the journal and the Chrome
trace; and the benchmark's span readers (``portbench/spans.py``) turn
them into milliseconds per traced iteration."""
import sys
import tracemalloc
from pathlib import Path

import pytest
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from repro_torch import obs
from repro_torch.configs.base import get_config
from repro_torch.models import transformer as T
from repro_torch.obs import recorder as R
from repro_torch.train.optimizer import OptConfig
from repro_torch.train.train_step import init_opt_state, make_train_step

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from portbench import harness, spec  # noqa: E402

HYBRID = get_config("zamba2_2p7b").reduced()
DENSE = get_config("minicpm_2b").reduced()
RWKV = get_config("rwkv6_7b").reduced()
AUDIO = get_config("whisper_medium").reduced()
OPT = OptConfig(peak_lr=2e-3, warmup_steps=5, stable_steps=60,
                decay_steps=10)
FRAMES = 8


def _model(cfg):
    return T.init_params(cfg, 0, device="cpu")


def _inputs(cfg, seed=0, rows=2, length=12):
    g = torch.Generator().manual_seed(seed)
    kw = {}
    if cfg.enc_layers:
        kw["enc_frames"] = torch.randn(rows, FRAMES, cfg.d_model, generator=g)
    return torch.randint(0, cfg.vocab, (rows, length), generator=g), kw


def _forward(model, cfg, seed=0):
    tokens, kw = _inputs(cfg, seed)
    with torch.no_grad():
        return T.forward(model, cfg, tokens, **kw)[0]


def _tree(rec):
    """(name, parent's name or None) of every span, in the order opened."""
    out, stacks = [], {}
    for e in rec.events:
        if e["ph"] == "B":
            st = stacks.setdefault(e["tid"], [])
            out.append((e["name"], st[-1] if st else None))
            st.append(e["name"])
        elif e["ph"] == "E":
            stacks[e["tid"]].pop()
    return out


def _forward_tree(cfg):
    """What one forward of ``cfg`` opens, under a parent of its own."""
    top = "model/forward"
    inner = []
    if cfg.enc_layers:
        inner += ["model/encoder_block"] * cfg.enc_layers
    if cfg.family == "hybrid":
        for _ in range(cfg.n_layers // cfg.attn_every):
            inner += (["model/mamba_layer"] * cfg.attn_every
                      + ["model/shared_block"])
    else:
        block = ("model/rwkv_block" if cfg.family == "ssm"
                 else "model/dense_block")
        inner += [block] * cfg.n_layers
    return [(top, None)] + [(n, top) for n in inner + ["model/head"]]


FAMILIES = [pytest.param(c, id=c.name) for c in (HYBRID, DENSE, RWKV, AUDIO)]


@pytest.mark.parametrize("cfg", FAMILIES)
def test_forward_spans_counts_and_parents(cfg):
    model = _model(cfg)
    rec = obs.Recorder("forward")
    with obs.use(rec):
        _forward(model, cfg)
    assert _tree(rec) == _forward_tree(cfg)
    times = rec.span_times()
    assert times["model/forward"]["calls"] == 1
    assert all(t["device_s"] is None and t["host_s"] > 0
               for t in times.values())      # no CUDA on this process
    assert sum(t["host_s"] for n, t in times.items()
               if n != "model/forward") <= times["model/forward"]["host_s"]


def test_train_step_spans_nest():
    """``train/step`` holds forward and backward per microbatch, then the
    update with the clip inside it; each block recomputed in the backward
    (remat "full") is recorded there."""
    model = _model(DENSE)
    fn = make_train_step(DENSE, OPT, remat="full", microbatches=2)
    tokens, _ = _inputs(DENSE, rows=4, length=13)
    rec = obs.Recorder("train")
    with obs.use(rec):
        fn(model, init_opt_state(model), {"tokens": tokens})
    tree = _tree(rec)
    child = {p: [n for n, q in tree if q == p] for p in {q for _, q in tree}}
    assert child[None] == ["train/step"]
    assert child["train/step"] == ["train/forward", "train/backward"] * 2 \
        + ["train/adamw_update"]
    assert child["train/adamw_update"] == ["train/clip"]
    assert child["train/forward"] == ["model/forward"] * 2
    assert child["train/backward"] == ["model/dense_block"] * (
        2 * DENSE.n_layers)
    assert {n: t["calls"] for n, t in rec.span_times().items()} == {
        "train/step": 1, "train/forward": 2, "train/backward": 2,
        "train/adamw_update": 1, "train/clip": 1, "model/forward": 2,
        "model/dense_block": 4 * DENSE.n_layers, "model/head": 2}


def _cpu_profile():
    return profile(activities=[ProfilerActivity.CPU])


@pytest.mark.parametrize("cfg", FAMILIES)
def test_logits_identical_under_recorder_and_profiler(cfg):
    model = _model(cfg)
    bare = _forward(model, cfg)
    with obs.use(obs.Recorder("r")):
        recorded = _forward(model, cfg)
    with _cpu_profile():
        profiled = _forward(model, cfg)
    assert torch.equal(bare, recorded) and torch.equal(bare, profiled)


def test_train_steps_identical_under_recorder_and_profiler():
    fn = make_train_step(DENSE, OPT, remat="full", microbatches=2)
    batches = [{"tokens": _inputs(DENSE, seed=s, rows=4, length=13)[0]}
               for s in range(2)]

    def run(ctx):
        model = _model(DENSE)
        st = init_opt_state(model)
        with ctx:
            losses = [fn(model, st, b)[2]["loss"] for b in batches]
        return torch.stack(losses), dict(model.named_parameters())

    bare = run(obs.use(None))
    for ctx in (obs.use(obs.Recorder("r")), _cpu_profile()):
        losses, params = run(ctx)
        assert torch.equal(losses, bare[0])
        assert all(torch.equal(p, bare[1][n]) for n, p in params.items())


def test_no_recorder_and_no_profiler_keep_nothing():
    model = _model(HYBRID)
    _forward(model, HYBRID)
    session = obs.profiled()
    tracemalloc.start()
    try:
        before = tracemalloc.take_snapshot()
        for s in range(3):
            assert obs.current() is obs.NULL
            _forward(model, HYBRID, seed=s)
        after = tracemalloc.take_snapshot()
    finally:
        tracemalloc.stop()
    grown = sum(d.size_diff for d in after.compare_to(before, "filename")
                if "repro_torch/obs/" in d.traceback[0].filename)
    assert grown <= 0
    assert obs.profiled() is session


def test_profiler_session_has_a_recorder_of_its_own():
    model = _model(DENSE)
    names = {"model/forward", "model/dense_block", "model/head"}
    _forward(model, DENSE)                          # before: not recorded
    with _cpu_profile() as prof:
        _forward(model, DENSE)
    _forward(model, DENSE)                          # after: not recorded
    first = obs.profiled()
    assert first is not None and obs.current() is obs.NULL
    calls = {n: t["calls"] for n, t in first.span_times().items()}
    assert calls == {"model/forward": 1, "model/head": 1,
                     "model/dense_block": DENSE.n_layers}
    ours = [e for e in prof.events() if e.name in names]
    assert {e.name for e in ours} == names
    assert not any(e.is_user_annotation for e in ours)
    assert all(e.device_type == DeviceType.CPU for e in ours)
    rec = obs.Recorder("installed")
    with _cpu_profile():
        with obs.use(rec):                          # an installed recorder
            _forward(model, DENSE)                  # takes the spans
        _forward(model, DENSE)
        _forward(model, DENSE)
    second = obs.profiled()
    assert second is not first
    assert second.span_times()["model/forward"]["calls"] == 2
    assert rec.span_times()["model/forward"]["calls"] == 1
    assert first.span_times()["model/forward"]["calls"] == 1


class _Event:
    """A stand-in for a CUDA timing event: each one made is one
    millisecond after the last."""
    clock = 0.0

    def __init__(self):
        _Event.clock += 1.0
        self.ms = _Event.clock

    def synchronize(self):
        pass

    def query(self):
        return True

    def elapsed_time(self, end):
        return end.ms - self.ms


@pytest.fixture
def fake_events(monkeypatch):
    monkeypatch.setattr(R, "_timing_event", _Event)


def test_device_times_resolve_into_journal_and_chrome_trace(fake_events,
                                                            tmp_path):
    rec = obs.Recorder("timed")
    for _ in range(2):
        with rec.span("outer"):
            with rec.span("inner"):
                pass
    assert len(rec._pending) == 4
    times = rec.span_times()
    assert rec._pending == []
    assert times["inner"]["calls"] == times["outer"]["calls"] == 2
    assert times["inner"]["device_s"] == pytest.approx(2e-3)
    assert times["outer"]["device_s"] == pytest.approx(6e-3)
    ends = [e["device_us"] for e in rec.events if e["ph"] == "E"]
    assert ends == pytest.approx([1e3, 3e3] * 2)
    path = str(tmp_path / "j.jsonl")
    obs.write_jsonl(rec, path)
    _, events = obs.read_jsonl(path)
    assert [e.get("device_us") for e in events if e["ph"] == "E"] == ends
    chrome = [e["args"]["device_us"]
              for e in obs.chrome_trace(rec)["traceEvents"] if e["ph"] == "E"]
    assert chrome == ends


def test_a_long_lived_recorder_drains_what_is_done(fake_events, monkeypatch):
    monkeypatch.setattr(R, "_DRAIN_AT", 8)
    rec = obs.Recorder("long")
    for _ in range(20):
        with rec.span("s"):
            pass
    assert len(rec._pending) < 8
    assert rec.span_times()["s"]["device_s"] == pytest.approx(20e-3)


READS = {                   # metric: (cell, span)
    "forward_ms.score": ("minicpm-2b.score_b24_l2048", "model/forward"),
    "mamba_ms.score": ("hybrid-mamba2-2.3b.score_b32_l2048",
                       "model/mamba_layer"),
    "shared_block_ms.score": ("hybrid-mamba2-2.3b.score_b32_l2048",
                              "model/shared_block"),
    "dense_block_ms.score": ("minicpm-2b.score_b24_l2048",
                             "model/dense_block"),
    "head_ms.score": ("hybrid-mamba2-2.3b.score_b32_l2048", "model/head"),
    "forward_ms.train": ("minicpm-2b.train_b2_s2048", "train/forward"),
    "backward_ms.train": ("minicpm-2b.train_b2_s2048", "train/backward"),
    "adamw_ms.train": ("minicpm-2b.train_b2_s2048", "train/adamw_update"),
}


def _reading(cell, iters=2):
    c = spec.resolve(cell)
    return harness.Reading(c.name, c.config, c.traffic, {}, iters, None)


@pytest.mark.parametrize("metric", sorted(READS))
def test_span_readers(metric, fake_events, monkeypatch):
    cell, span = READS[metric]
    read = spec.metric_module(metric).read
    rec = obs.Recorder("profiled")
    for _ in range(3):                  # 3 calls of 1 ms over 2 iterations
        with rec.span(span):
            pass
    monkeypatch.setattr(obs, "profiled", lambda: rec)
    assert read(_reading(cell)) == pytest.approx(1.5)
    other = ("minicpm-2b.score_b24_l2048" if cell.endswith("train_b2_s2048")
             else "minicpm-2b.train_b2_s2048")
    assert read(_reading(other)) is None            # another loop
    monkeypatch.setattr(obs, "profiled", lambda: obs.Recorder("empty"))
    assert read(_reading(cell)) is None             # the span never ran
    monkeypatch.setattr(obs, "profiled", lambda: None)
    assert read(_reading(cell)) is None             # no session at all
