"""The plain references against the port on the reduced configurations
(CPU), and the pieces they are built from."""

import pytest
import torch

from portbench import sut
from portbench.reference import common as C
from portbench.reference import dense, hybrid
from portbench.reference import train as RT
from portbench.tiny import tiny_cell

SCORE_CELLS = ["hybrid-mamba2-2.3b.score_b32_l2048", "minicpm-2b.score_b24_l2048"]
FAMILY = {"hybrid": hybrid, "dense": dense}


def rel(a, b):
    return float((a - b).abs().max() / b.abs().max())


def sequential_ssd(x, dt, a, bm, cm):
    b, seq, nh, p = x.shape
    h = torch.zeros(b, nh, bm.shape[-1], p, dtype=torch.float64)
    ys = []
    for t in range(seq):
        h = torch.exp(a * dt[:, t])[..., None, None] * h + \
            dt[:, t, :, None, None] * bm[:, t, None, :, None] * x[:, t, :, None, :]
        ys.append(torch.einsum("bn,bhnp->bhp", cm[:, t], h))
    return torch.stack(ys, 1)


@pytest.mark.parametrize("seq", [40, 64, 150])
def test_chunked_scan_is_the_recurrence(seq):
    g = torch.Generator().manual_seed(seq)
    x = torch.randn(2, seq, 3, 4, generator=g, dtype=torch.float64)
    dt = torch.rand(2, seq, 3, generator=g, dtype=torch.float64) * 0.5
    a = -torch.tensor([1.0, 4.0, 16.0], dtype=torch.float64)
    bm = torch.randn(2, seq, 5, generator=g, dtype=torch.float64)
    cm = torch.randn(2, seq, 5, generator=g, dtype=torch.float64)
    assert rel(hybrid.ssd(x, dt, a, bm, cm), sequential_ssd(x, dt, a, bm, cm)) < 1e-12


@pytest.mark.parametrize("cell", SCORE_CELLS)
def test_reference_forward_matches_the_port(cell):
    c = tiny_cell(cell)
    fam = FAMILY[c.config["family"]]
    w = C.draw(fam.spec(c.config), 5, "cpu")
    tokens = C.token_pool(5, 1, 2, 48, c.config["vocab"], "cpu")[0]
    ours = fam.forward(w, c.config, tokens)
    theirs = sut.Scorer(c.config, c.traffic, w).forward(tokens)
    assert ours.shape == theirs.shape == (2, 48, C.vocab_pad(c.config))
    assert rel(theirs, ours) < 1e-5


def test_reference_train_steps_match_the_port():
    c = tiny_cell("minicpm-2b.train_b2_s2048")
    tokens = C.token_pool(9, 3, 2, 33, c.config["vocab"], "cpu")
    spec = dense.spec(c.config)
    prog = sut.Trainer(c.config, c.traffic, C.draw(spec, 9, "cpu"))
    ref = RT.Trainer(dense, c.config, c.traffic, C.draw(spec, 9, "cpu"))
    for k in range(3):
        lp, lr = float(prog.step(tokens[k])), float(ref.step(tokens[k]))
        assert abs(lp - lr) / lr < 1e-6
        if k == 0:
            gp, gr = prog.first_grad_norms(), ref.first_grad_norms()
            assert set(gp) == set(gr)
            assert max(abs(float(gp[n] - gr[n])) / float(gr[n]) for n in gr) < 1e-5
    pp, pr = prog.params(), ref.params()
    assert max(rel(pp[n], pr[n]) for n in pr) < 1e-5


def test_wsd_schedule():
    opt = {"peak_lr": 1.0, "warmup_steps": 10, "stable_steps": 5,
           "decay_steps": 4, "min_lr_frac": 0.1}
    assert RT.wsd_lr(opt, 1) == pytest.approx(0.2)
    assert RT.wsd_lr(opt, 9) == RT.wsd_lr(opt, 15) == 1.0
    assert RT.wsd_lr(opt, 17) == pytest.approx(0.1 ** 0.5)
    assert RT.wsd_lr(opt, 40) == pytest.approx(0.1)


def test_tf32_rounding_and_precision_flags():
    one = torch.tensor([1 + 2 ** -12, 1 + 3 * 2 ** -12, -2 - 2 ** -9])
    assert C.round_tf32(one).tolist() == [1.0, 1 + 2 ** -10, -2 - 2 ** -9]
    x = torch.randn(8, 8, requires_grad=True)
    C.round_tf32(x).sum().backward()
    assert torch.equal(x.grad, torch.ones(8, 8))
    a, b = torch.randn(64, 64), torch.randn(64, 64)
    with C.precision("tf32", "cpu"):
        low = C.mm(a, b)
    assert torch.equal(C.mm(a, b), a @ b) and not torch.equal(low, a @ b)
    assert rel(low, a @ b) < 1e-2
    with pytest.raises(ValueError):
        with C.precision("bf16", "cpu"):
            pass


def test_weights_redraw_by_group_and_tokens_by_seed():
    c = tiny_cell("hybrid-mamba2-2.3b.score_b32_l2048").config
    spec = hybrid.spec(c)
    w = C.draw(spec, 2 ** 40 + 3, "cpu")
    assert set(w) == {row[1] for row in spec}
    layer = C.draw(spec, 2 ** 40 + 3, "cpu", only="layer1")
    assert set(layer) == {n for n in w if n.startswith("blocks.1.")}
    assert all(torch.equal(layer[n], w[n]) for n in layer)
    assert not torch.equal(C.draw(spec, 4, "cpu", only="layer1")
                           ["blocks.1.ln1"], w["blocks.1.ln1"])
    a_log = w["blocks.0.mamba.a_log"].exp()
    assert bool(((a_log >= 1) & (a_log <= 16)).all())
    dt = torch.nn.functional.softplus(w["blocks.0.mamba.dt_bias"])
    assert bool(((dt > 1e-3 * 0.999) & (dt < 0.1 * 1.001)).all())
    p1 = C.token_pool(7, 3, 2, 5, 100, "cpu")
    assert torch.equal(p1, C.token_pool(7, 3, 2, 5, 100, "cpu"))
    assert int(p1.max()) < 100 and not torch.equal(p1[0], p1[1])


def test_tree_layout():
    t = C.tree({"embed": 1, "blocks.0.ln1": 2, "blocks.1.ln1": 3,
                "blocks.0.mlp.w_up": 4, "shared.attn.wq": 5})
    assert t == {"embed": 1, "blocks": [{"ln1": 2, "mlp": {"w_up": 4}},
                                        {"ln1": 3}],
                 "shared": {"attn": {"wq": 5}}}
    assert C.derive_seed(1, "a") != C.derive_seed(1, "b")
