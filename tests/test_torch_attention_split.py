"""The arithmetic of the bfloat16 area-attention kernels (K3), on the CPU.

The bfloat16 forward, dq and dkv kernels in
yolo_dbl_tpu_torch/csrc/attention.cu run every product on the bfloat16
tensor cores (mma.sync m16n8k16, float32 accumulators). A product of two
bfloat16 inputs (S = q kT, dP = dO vT, their transposes) is exact in
float32. A float32 intermediate (P, dS) times an input is split
into bfloat16 terms, one product a term: each term but the last is the
leading 8 significant bits of what is left (a truncation), the last what is
left rounded to nearest (`split_bf16x2`). Each 16-row step's products go to
a fresh accumulator, added to the running float32 sum.

Here that arithmetic runs in plain torch: the split's exactness, and an
emulation of the three kernels held against the plain versions under the
bars the card's tests hold the kernels to (tests/test_torch_cuda.py,
chip_smoke.py). It is how the number of terms was chosen: the fewest that
meet the bars, the forward's 2 and the dq's and dkv's 3, as the source
ships them; chip_smoke.py charges the same counts in its bounds. No JAX, a
few seconds:

    python -m pytest -q tests/test_torch_attention_split.py
"""

import ast
import math
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from yolo_dbl_tpu_torch.kernels.attention import (area_attention_backward_plain,
                                                  area_attention_lse_plain, area_attention_plain)
from tests.torch_fixtures import one_torch_thread  # noqa: F401 (autouse fixture)

ROOT = Path(__file__).resolve().parent.parent
SOURCE = ROOT / "yolo_dbl_tpu_torch" / "csrc" / "attention.cu"
LOG2E = 1.4426950408889634
STEP = 16  # rows of the streamed operand a step (two n8 accumulator tiles)


def _shipped(what):
    """{"forward": n, "dq": n, "dkv": n} of `what` ("TERMS", "WARPS") as
    attention.cu ships them."""
    text = SOURCE.read_text()
    return {kernel: int(re.search(rf"\b{name}_{what} = (\d+)", text).group(1))
            for kernel, name in (("forward", "FWD"), ("dq", "DQ"), ("dkv", "DKV"))}


def _split(x, terms):
    """float32 x as `terms` float32 tensors of bfloat16 values that sum to it
    (or to within the last term's rounding), as split_bf16x2 splits it."""
    out, rest = [], x
    for i in range(terms):
        if i < terms - 1:
            term = (rest.view(torch.int32) & -65536).view(torch.float32)  # upper 16 bits
        else:
            term = rest.to(torch.bfloat16).float()
        out.append(term)
        rest = rest - term
    return out


def _product(a, b, terms):
    """a @ b for float32 a and bfloat16 b (as float32): one product a term
    of a's split, the smallest first, into a fresh accumulator."""
    out = torch.zeros(a.shape[:-1] + b.shape[-1:])
    for term in reversed(_split(a, terms)):
        out = out + term @ b
    return out


def _fma(a, b, c):
    """fmaf(a, b, c) of float32 tensors: a b is exact in float64, the sum
    rounded once more."""
    return (a.double() * b.double() + c.double()).float()


def _forward(q, k, v, terms):
    """The forward kernel's arithmetic: an online softmax in the log2
    domain, one step a shared tile (16 keys a warp of the block): the row
    max of S, then P = 2^(S c - m) by one FMA; and P V over the tile's
    16-key chunks, P split into `terms`, each chunk into a fresh
    accumulator. Returns o (bfloat16), lse, and O in float32 (the
    kernel's o32)."""
    tile = STEP * _shipped("WARPS")["forward"]  # a warp owns 16 rows
    q, k, v = (t.float().transpose(1, 2) for t in (q, k, v))
    c = torch.tensor(q.shape[-1] ** -0.5 * LOG2E, dtype=torch.float32)
    m = torch.full(q.shape[:-1], -math.inf)
    l = torch.zeros(q.shape[:-1])
    acc = torch.zeros(q.shape)
    for t0 in range(0, q.shape[2], tile):
        s = q @ k[:, :, t0:t0 + tile].transpose(-1, -2)
        mx = torch.maximum(m, s.amax(-1) * c)
        alpha = torch.exp2(m - mx)
        l, acc, m = l * alpha, acc * alpha[..., None], mx
        for j in range(0, s.shape[-1], STEP):
            p = torch.exp2(_fma(s[..., j:j + STEP], c, -m[..., None]))
            l = l + p.sum(-1)
            acc = acc + _product(p, v[:, :, t0 + j:t0 + j + STEP], terms)
    o32 = (acc / l[..., None]).transpose(1, 2)
    return o32.to(torch.bfloat16), m / LOG2E + torch.log(l), o32


def _dkv(q, k, v, grad, terms):
    """The dkv kernel's arithmetic from the key side over 16-query steps:
    P^T and dS^T = P^T (dP^T - delta) split into `terms` for dV = P^T dO and
    dK = scale dS^T q; lse and delta = rowsum(dO O) in float32, as the
    forward and dq kernels hand them over: from the forward's arithmetic
    with the shipped terms (its lse and float32 O)."""
    _, lse, o32 = _forward(q, k, v, _shipped("TERMS")["forward"])
    delta = (grad.float() * o32).sum(-1).transpose(1, 2)
    q, k, v, grad = (t.float().transpose(1, 2) for t in (q, k, v, grad))
    scale = q.shape[-1] ** -0.5
    c = torch.tensor(scale * LOG2E, dtype=torch.float32)
    dk, dv = torch.zeros(k.shape), torch.zeros(v.shape)
    for j in range(0, q.shape[2], STEP):
        qj, gj = q[:, :, j:j + STEP], grad[:, :, j:j + STEP]
        lg = (lse[:, :, j:j + STEP] * LOG2E)[..., None, :]
        p = torch.exp2(_fma(k @ qj.transpose(-1, -2), c, -lg))
        ds = p * (v @ gj.transpose(-1, -2) - delta[:, :, None, j:j + STEP])
        dv = dv + _product(p, gj, terms)
        dk = dk + _product(ds, qj, terms)
    return ((dk * scale).transpose(1, 2).to(torch.bfloat16),
            dv.transpose(1, 2).to(torch.bfloat16))


def _dq(q, k, v, grad, terms):
    """The dq kernel's arithmetic from the query side over 16-key steps:
    P = 2^(S c - lse log2 e) by one FMA, dS = P (dP - delta) split into
    `terms` for dQ = scale dS k, each step into a fresh accumulator; lse
    and delta = rowsum(dO O) in float32 from the forward's arithmetic with
    the shipped terms (its lse and float32 O), as on the card."""
    _, lse, o32 = _forward(q, k, v, _shipped("TERMS")["forward"])
    delta = (grad.float() * o32).sum(-1).transpose(1, 2)
    q, k, v, grad = (t.float().transpose(1, 2) for t in (q, k, v, grad))
    scale = q.shape[-1] ** -0.5
    c = torch.tensor(scale * LOG2E, dtype=torch.float32)
    lg = (lse * LOG2E)[..., None]
    dq = torch.zeros(q.shape)
    for j in range(0, k.shape[2], STEP):
        kj, vj = k[:, :, j:j + STEP], v[:, :, j:j + STEP]
        p = torch.exp2(_fma(q @ kj.transpose(-1, -2), c, -lg))
        ds = p * (grad @ vj.transpose(-1, -2) - delta[..., None])
        dq = dq + _product(ds, kj, terms)
    return (dq * scale).transpose(1, 2).to(torch.bfloat16)


def _excess(got, want, scale):
    """The largest excess of |got - want| over the bar: one bfloat16 step of
    want plus 1e-6 of scale (<= 0 meets it)."""
    w = want.float()
    _, e = torch.frexp(w)
    ulp = torch.ldexp(torch.ones_like(w), e - 8)
    return float(((got.float() - w).abs() - ulp - 1e-6 * scale).max())


def _inputs(seed=0, bb=2, n=400, h=2):
    """bfloat16 q, k, v (views of one packed tensor, as AAttn makes them)
    and an output gradient."""
    rng = np.random.default_rng(seed)
    qkv = torch.from_numpy(rng.standard_normal((bb, n, h, 96)).astype(np.float32)).bfloat16()
    grad = torch.from_numpy(rng.standard_normal((bb, n, h, 32)).astype(np.float32)).bfloat16()
    return (*qkv.split(32, -1), grad)


def _values(rng, n, lo, hi, signed):
    """n float32 values with random 24-bit significands and exponents in
    [lo, hi), of random sign if `signed`."""
    mant = rng.uniform(1, 2, n)
    vals = np.ldexp(mant, rng.integers(lo, hi, n))
    if signed:
        vals *= rng.choice([-1.0, 1.0], n)
    return torch.from_numpy(vals.astype(np.float32))


@pytest.mark.parametrize("terms", [1, 2, 3])
@pytest.mark.parametrize("kind", ["p", "ds"])
def test_split_into_bfloat16_terms(kind, terms):
    """P in (2^-60, 1] and dS signed over (2^-60, 2^8): every term is a
    bfloat16 value, and the terms sum (in float64) to x exactly with 3
    terms, within 2^-16 of |x| with 2 and 2^-8 with 1."""
    rng = np.random.default_rng(1)
    x = (_values(rng, 100_000, -60, 0, False) if kind == "p"
         else _values(rng, 100_000, -60, 8, True))
    if kind == "p":
        x[0] = 1.0
    parts = _split(x, terms)
    for part in parts:
        assert torch.equal(part.to(torch.bfloat16).float(), part)
    err = (sum(p.double() for p in parts) - x.double()).abs()
    if terms == 3:
        assert float(err.max()) == 0.0
    else:
        assert bool((err <= 2.0 ** (-8 * terms) * x.double().abs()).all())


@pytest.mark.parametrize("terms", [1, 2, 3])
def test_forward_emulation_meets_the_bar(terms):
    """The forward kernel's arithmetic against the plain version: o within
    one bfloat16 step + 1e-6 of v's largest, lse within 1e-5. The shipped
    split is the fewest terms that meet it."""
    q, k, v, _ = _inputs()
    o, lse, _ = _forward(q, k, v, terms)
    excess = _excess(o, area_attention_plain(q, k, v), float(v.float().abs().max()))
    lse_err = float((lse - area_attention_lse_plain(q, k)).abs().max())
    meets = excess <= 0 and lse_err <= 1e-5
    assert meets == (terms >= _shipped("TERMS")["forward"]), (excess, lse_err)


@pytest.mark.parametrize("terms", [2, 3])
def test_dkv_emulation_meets_the_bar(terms):
    """The dkv kernel's arithmetic against autograd through the plain
    version: dk and dv within one bfloat16 step + 1e-6 of the tensor's
    largest (floored at 1e-2 of dv's largest). Two terms miss it at
    elements near 0 (up to 2^-16 of a term); the shipped split
    is the fewest terms that meet it."""
    q, k, v, grad = _inputs()
    _, want_dk, want_dv = area_attention_backward_plain(q, k, v, grad)
    floor = 1e-2 * float(want_dv.float().abs().max())
    got = _dkv(q, k, v, grad, terms)
    excess = max(_excess(a, r, max(float(r.float().abs().max()), floor))
                 for a, r in zip(got, (want_dk, want_dv)))
    assert (excess <= 0) == (terms >= _shipped("TERMS")["dkv"]), excess


@pytest.mark.parametrize("terms", [1, 2, 3])
def test_dq_emulation_meets_the_bar(terms):
    """The dq kernel's arithmetic against autograd through the plain
    version: dq within one bfloat16 step + 1e-6 of its largest (floored at
    1e-2 of dv's largest). Two terms miss it by a few 1e-7 near 0, one by
    about 1e-3; the shipped split is the fewest terms that meet it."""
    q, k, v, grad = _inputs()
    want_dq, _, want_dv = area_attention_backward_plain(q, k, v, grad)
    floor = 1e-2 * float(want_dv.float().abs().max())
    excess = _excess(_dq(q, k, v, grad, terms), want_dq,
                     max(float(want_dq.float().abs().max()), floor))
    assert (excess <= 0) == (terms >= _shipped("TERMS")["dq"]), excess


def test_chip_smoke_charges_the_shipped_terms():
    """chip_smoke.py's bounds charge a float32 P or dS times an input one
    bfloat16 pass a term, at the terms each kernel ships with."""
    text = (ROOT / "chip_smoke.py").read_text()
    charged = re.search(r"^BF16_TERMS = (\{.*\})$", text, re.M).group(1)
    assert ast.literal_eval(charged) == _shipped("TERMS"), charged
