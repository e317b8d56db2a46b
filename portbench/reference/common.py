"""Plain PyTorch building blocks of the references, and their weights.

Written for the benchmark alone: nothing here imports the port, and every
formula is the model's own (RMS norm with a zero-centred gain x̂·(1 + g),
rotary embeddings on the two halves of each head, causal softmax
attention, SwiGLU).  Matrix products go through `mm` and `einsum`, so a
control can run the same code one precision lower (`precision`).

Weights are drawn on the device from the seed in a few large calls: one
``randn`` per group (the embedding, each layer, the shared block, the
final norm), from a generator seeded by the run's seed and the group's
name, so any group can be drawn again alone (`Streamed` draws them as
they are read).  Each leaf is a view into its group's buffer, shaped and
scaled by its ``init``.
"""
from __future__ import annotations

import contextlib
import hashlib
import math
from collections.abc import Mapping

import torch
import torch.nn.functional as F

_TF32_EMULATED = False


def derive_seed(seed: int, label: str) -> int:
    """A 63-bit seed from the run's seed and a label: independent streams
    for weights, tokens and samples, each reproducible alone."""
    digest = hashlib.sha256(f"{int(seed)}/{label}".encode()).digest()
    return int.from_bytes(digest[:8], "little") & (2 ** 63 - 1)


@contextlib.contextmanager
def precision(kind: str, device):
    """``"f32"``: every product in float32 (TF32 off).  ``"tf32"``: the
    control's precision, TF32 products with float32 sums: on a CUDA
    device cuBLAS's own TF32 path, on the CPU each operand rounded to
    TF32's 10-bit mantissa before an f32 product."""
    global _TF32_EMULATED
    if kind not in ("f32", "tf32"):
        raise ValueError(f"precision must be f32 or tf32, got {kind!r}")
    cuda = torch.device(device).type == "cuda"
    prev = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32, _TF32_EMULATED)
    on = kind == "tf32"
    torch.backends.cuda.matmul.allow_tf32 = on and cuda
    torch.backends.cudnn.allow_tf32 = on and cuda
    _TF32_EMULATED = on and not cuda
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32, _TF32_EMULATED) = prev


def round_tf32(t: torch.Tensor) -> torch.Tensor:
    """``t`` (float32) rounded to the nearest value with a 10-bit
    mantissa, as a TF32 tensor core reads it; the gradient passes
    through unrounded."""
    bits = t.detach().contiguous().view(torch.int32)
    rounded = ((bits + 0x1000) & ~0x1FFF).view(torch.float32)
    return t + (rounded.view(t.shape) - t).detach()


def mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    if _TF32_EMULATED:
        a, b = round_tf32(a), round_tf32(b)
    return a @ b


def einsum(eq: str, *ops: torch.Tensor) -> torch.Tensor:
    if _TF32_EMULATED:
        ops = tuple(round_tf32(o) for o in ops)
    return torch.einsum(eq, *ops)


def rmsnorm(x: torch.Tensor, gain: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + eps) * (1 + gain)


def rotary(x: torch.Tensor, theta: float) -> torch.Tensor:
    """x (B, L, H, hd) at positions 0..L−1: each pair (x_i, x_{i+hd/2})
    rotated by the angle pos·θ^(−2i/hd)."""
    seq, hd = x.shape[1], x.shape[-1]
    freq = theta ** (-torch.arange(0, hd, 2, device=x.device,
                                   dtype=torch.float32) / hd)
    ang = torch.arange(seq, device=x.device, dtype=torch.float32)[:, None] * freq
    cos, sin = ang.cos()[:, None, :], ang.sin()[:, None, :]
    lo, hi = x[..., :hd // 2], x[..., hd // 2:]
    return torch.cat([lo * cos - hi * sin, hi * cos + lo * sin], -1)


def causal_attention(w: dict, pre: str, h: torch.Tensor, cfg: dict) -> torch.Tensor:
    """Multi-head causal self-attention with rotary positions; the key and
    value heads serve n_heads / n_kv_heads query heads each."""
    b, seq, _ = h.shape
    nh, kvh = cfg["n_heads"], cfg["n_kv_heads"]
    hd = cfg["d_model"] // nh
    q = rotary(mm(h, w[pre + "wq"]).view(b, seq, nh, hd), cfg["rope_theta"])
    k = rotary(mm(h, w[pre + "wk"]).view(b, seq, kvh, hd), cfg["rope_theta"])
    v = mm(h, w[pre + "wv"]).view(b, seq, kvh, hd)
    if kvh != nh:
        k = k.repeat_interleave(nh // kvh, dim=2)
        v = v.repeat_interleave(nh // kvh, dim=2)
    scores = einsum("bqhd,bkhd->bhqk", q, k) / math.sqrt(hd)
    future = torch.ones(seq, seq, dtype=torch.bool, device=h.device).triu(1)
    probs = torch.softmax(scores.masked_fill(future, float("-inf")), -1)
    out = einsum("bhqk,bkhd->bqhd", probs, v).reshape(b, seq, nh * hd)
    return mm(out, w[pre + "wo"])


def swiglu(w: dict, pre: str, h: torch.Tensor) -> torch.Tensor:
    return mm(F.silu(mm(h, w[pre + "w_gate"])) * mm(h, w[pre + "w_up"]),
              w[pre + "w_down"])


def vocab_pad(cfg: dict) -> int:
    """The vocabulary rounded up to a multiple of 512, as the embedding is
    held (the padded rows take part in the softmax like any other)."""
    return (cfg["vocab"] + 511) // 512 * 512


def _shaped(z: torch.Tensor, init: tuple) -> torch.Tensor:
    """A leaf from its standard-normal draws ``z`` (in place)."""
    kind = init[0]
    if kind == "normal":                      # std · N(0, 1)
        return z.mul_(init[1])
    if kind == "one_plus":                    # 1 + std · N(0, 1)
        return z.mul_(init[1]).add_(1.0)
    if kind == "log_uniform":                 # log U(lo, hi)
        lo, hi = init[1], init[2]
        u = 0.5 * (1 + torch.erf(z / math.sqrt(2)))
        return z.copy_(torch.log(lo + (hi - lo) * u))
    if kind == "inv_softplus_log_uniform":    # softplus⁻¹ of exp(U(log lo, log hi))
        lo, hi = math.log(init[1]), math.log(init[2])
        u = 0.5 * (1 + torch.erf(z / math.sqrt(2)))
        dt = torch.exp(lo + (hi - lo) * u)
        return z.copy_(dt + torch.log(-torch.expm1(-dt)))
    raise ValueError(f"unknown init {init!r}")


def draw(spec: list, seed: int, device, only: str | None = None) -> dict:
    """{leaf name: tensor} of the ``spec`` rows (group, name, shape, init),
    or of the group ``only``; each group one ``randn`` on ``device``."""
    groups: dict = {}
    for group, name, shape, init in spec:
        if only is None or group == only:
            groups.setdefault(group, []).append((name, shape, init))
    out = {}
    for group, leaves in groups.items():
        sizes = [math.prod(shape) for _, shape, _ in leaves]
        gen = torch.Generator(device=device)
        gen.manual_seed(derive_seed(seed, "weights/" + group))
        flat = torch.randn(sum(sizes), generator=gen, device=device,
                           dtype=torch.float32)
        for (name, shape, init), part in zip(leaves, flat.split(sizes)):
            out[name] = _shaped(part, init).view(shape)
    return out


class Streamed(Mapping):
    """The weights of ``spec`` as `draw` gives them, drawn one group at a
    time as they are read: reading a leaf of another group than the one
    held frees that group and draws the leaf's, so at most one group is
    held (beside what the reader keeps).  A family's ``forward`` reads it
    as it reads the whole draw, and gives the same logits, bit for bit.
    ``draws`` counts the groups drawn."""

    def __init__(self, spec: list, seed: int, device):
        self._spec, self._seed, self._device = spec, seed, device
        self._group_of = {name: group for group, name, *_ in spec}
        self._group, self._held = None, {}
        self.draws = 0

    def __getitem__(self, name: str) -> torch.Tensor:
        group = self._group_of[name]
        if group != self._group:
            self._group, self._held = None, {}
            self._held = draw(self._spec, self._seed, self._device,
                              only=group)
            self._group = group
            self.draws += 1
        return self._held[name]

    def __iter__(self):
        return iter(self._group_of)

    def __len__(self) -> int:
        return len(self._group_of)


def groups_of(spec: list) -> list:
    seen = []
    for group, *_ in spec:
        if group not in seen:
            seen.append(group)
    return seen


def tree(flat: dict) -> dict:
    """The nested layout of dotted names: dicts, and lists where every key
    of a level is an index ("blocks.3.ln1" → tree["blocks"][3]["ln1"])."""
    root: dict = {}
    for name, t in flat.items():
        node = root
        *path, leaf = name.split(".")
        for key in path:
            node = node.setdefault(key, {})
        node[leaf] = t

    def listify(node):
        if not isinstance(node, dict):
            return node
        node = {k: listify(v) for k, v in node.items()}
        if node and all(k.isdigit() for k in node):
            return [node[str(i)] for i in range(len(node))]
        return node
    return listify(root)


def token_pool(seed: int, count: int, rows: int, length: int, vocab: int,
               device) -> torch.Tensor:
    """(count, rows, length) token ids, uniform over the vocabulary, drawn
    on ``device`` from the seed: the traffic's batches, in order."""
    gen = torch.Generator(device=device)
    gen.manual_seed(derive_seed(seed, "tokens"))
    return torch.randint(0, vocab, (count, rows, length), generator=gen,
                         device=device, dtype=torch.int64)
