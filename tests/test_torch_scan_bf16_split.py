"""The bfloat16 working type's scan kernels as they split a chunk, on the
CPU: a plain-torch replay of their order, and what the design rests on.

``csrc/selective_scan.cu``'s bfloat16 working-type kernels spread a lane
pair's chunk of ``q`` steps over ``G`` threads of a warp, ``SEG`` steps
each: the odd/even tree's levels inside a segment run in a thread, the top
``log2 G`` levels between the threads' last elements, and the transposed
tree (the backward) sends a segment's first down-sweep combine of each
level to the previous segment's last element.  ``split_scan`` and
``split_transpose`` replay that order with the kernels' own conditions,
one thread after another within a level; in bfloat16 they are held bit
for bit to ``ss.associative_scan``, ``jax.lax.associative_scan`` and
``ss._tree_transpose``, at the kernels' split (``kWSeg`` steps a
thread) and at others.  The native bfloat16 pair
operations the kernels use are held to the float32 ones rounded, in NumPy
(the card's own bits are a ``gpu`` test); and the source carries no
atomics and no switch back to the old design.  torch runs on two threads
here.
"""
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro_torch.kernels import selective_scan as ss

torch.set_num_threads(2)

CSRC = Path(ss.__file__).resolve().parent / "csrc" / "selective_scan.cu"
QS = [1, 2, 3, 7, 64, 65, 100, 128]
#: Steps a thread holds; a lane pair's chunk (q <= 128) takes 128 / SEG
#: threads, those past q idle, as in the kernels.
SEGS = [4, 8, 16, 32]


def kernel_seg() -> int:
    """Steps a thread holds in both kernels (``kWSeg`` in
    ``csrc/selective_scan.cu``)."""
    m = re.search(r"constexpr int kWSeg = (\d+), ", CSRC.read_text())
    return int(m.group(1))


def _levels(n: int) -> int:
    return max(n - 1, 0).bit_length()


def _threads(seg: int) -> int:
    return 128 // seg


def _comb(a, u, lft: int, r: int) -> None:
    """One combine, (a_l a_r, u_l a_r + u_r), each op rounded to the
    tensors' type."""
    a[:, r], u[:, r] = a[:, lft] * a[:, r], u[:, lft] * a[:, r] + u[:, r]


def split_scan(a, u, seg: int):
    """The kernels' tree over axis 1 in place: levels inside a segment (up2's
    first loop), between segments' last elements up and down, then inside
    with the previous segment's last element (down2).  Returns copies of
    ``(a, u)`` after the up-sweep and the a of each segment's last element
    before each level between segments, ``apre[s][j]``."""
    q = a.shape[1]
    g = _threads(seg)
    for lvl in range(_levels(seg)):
        h = 1 << lvl
        for j in range(g):
            for r in range(2 * h - 1, seg, 2 * h):
                if seg * j + r < q:
                    _comb(a, u, seg * j + r - h, seg * j + r)
    apre = []
    for s in range(_levels(g)):
        h = 1 << s
        apre.append({j: a[:, seg * (j + 1) - 1].clone()
                     for j in range(g) if seg * (j + 1) - 1 < q})
        for j in range(g):
            if (j + 1) % (2 * h) == 0 and seg * (j + 1) <= q:
                _comb(a, u, seg * (j + 1 - h) - 1, seg * (j + 1) - 1)
    kept = a.clone(), u.clone()
    for s in reversed(range(_levels(g))):
        h = 1 << s
        for j in range(g):
            if (j + 1) % (2 * h) == h and j + 1 >= 3 * h \
                    and seg * (j + 1) <= q:
                _comb(a, u, seg * (j + 1 - h) - 1, seg * (j + 1) - 1)
    for lvl in reversed(range(_levels(seg))):
        h = 1 << lvl
        for j in range(g):
            for i in range(h - 1, seg, 2 * h):
                t = seg * j + i
                if 3 * h - 1 <= t < q:      # i < h: the previous segment's
                    _comb(a, u, t - h, t)   # last element
    return kept, apre


def split_transpose(ga, gu, fa, fu, ua, uu, a0, apre, seg: int):
    """The backward kernel's transposed tree in place (``ga, gu`` the
    gradients of the tree's outputs become those of its inputs), in its
    order: inside each segment the down-sweep's combines from level 0 up,
    a segment's first combine of a level sending ``gA a_r, gU a_r`` to the
    previous segment's last element, where they are added in level order
    (the kernel adds each after its level: no other term reaches that
    element meanwhile); the down-sweep's levels between segments up, the
    up-sweep's down (``a_r`` kept from the forward, ``apre``), then the
    up-sweep's inside a segment from the top, ``a_r`` rebuilt from ``a0``
    by the forward's products."""
    q = ga.shape[1]
    g = _threads(seg)

    def uncomb(lft, r, al, ul, ar):
        gA, gU = ga[:, r].clone(), gu[:, r].clone()
        if lft is not None:
            ga[:, lft] = ga[:, lft] + gA * ar
            gu[:, lft] = gu[:, lft] + gU * ar
        ga[:, r] = gA * al + gU * ul

    sent = {}
    for lvl in range(_levels(seg)):
        h = 1 << lvl
        for j in range(g):
            for i in range(h - 1, seg, 2 * h):
                t = seg * j + i
                if 3 * h - 1 <= t < q:
                    if i >= h:
                        uncomb(t - h, t, fa[:, t - h], fu[:, t - h], ua[:, t])
                    else:
                        sent[j, lvl] = (ga[:, t] * ua[:, t],
                                        gu[:, t] * ua[:, t])
                        uncomb(None, t, fa[:, t - h], fu[:, t - h], ua[:, t])
    for j in range(g):
        last = seg * (j + 1) - 1
        for lvl in range(_levels(seg)):
            if (j + 1, lvl) in sent:
                ca, cu = sent[j + 1, lvl]
                ga[:, last] = ga[:, last] + ca
                gu[:, last] = gu[:, last] + cu
    for s in range(_levels(g)):
        h = 1 << s
        for j in range(g):
            if (j + 1) % (2 * h) == h and j + 1 >= 3 * h \
                    and seg * (j + 1) <= q:
                r, lft = seg * (j + 1) - 1, seg * (j + 1 - h) - 1
                uncomb(lft, r, fa[:, lft], fu[:, lft], ua[:, r])
    for s in reversed(range(_levels(g))):
        h = 1 << s
        for j in range(g):
            if (j + 1) % (2 * h) == 0 and seg * (j + 1) <= q:
                r, lft = seg * (j + 1) - 1, seg * (j + 1 - h) - 1
                uncomb(lft, r, ua[:, lft], uu[:, lft], apre[s][j])
    for lvl in reversed(range(_levels(seg))):
        h = 1 << lvl
        for j in range(g):
            for r in range(2 * h - 1, seg, 2 * h):
                t = seg * j + r
                if t < q:
                    ar = a0[:, t]
                    for j2 in range(lvl):
                        ar = ua[:, t - (1 << j2)] * ar
                    uncomb(t - h, t, ua[:, t - h], uu[:, t - h], ar)


CASES = [(q, seg) for q in QS for seg in SEGS]


def test_the_kernels_split_is_replayed():
    """The kernels' steps a thread are among the splits replayed here."""
    assert kernel_seg() in SEGS


@pytest.mark.parametrize("q,seg", CASES, ids=[f"q{q}-seg{s}"
                                                for q, s in CASES])
def test_split_scan_is_associative_scan_bit_for_bit(q, seg):
    """The kernels' split of the tree gives the bits of the recursive
    ``associative_scan`` and of ``jax.lax.associative_scan`` in bfloat16,
    and its up-sweep values those ``_tree_scan`` keeps."""
    rng = np.random.default_rng(q * 31 + seg)
    a = rng.uniform(0.5, 1.0, (2, q, 3)).astype(np.float32)
    u = rng.standard_normal((2, q, 3)).astype(np.float32)
    ta, tu = (torch.from_numpy(t).bfloat16() for t in (a, u))
    ra, ru = ss.associative_scan(ta, tu, dim=1)
    ka, ku = ta.clone(), tu.clone()
    (kua, kuu), _ = split_scan(ka, ku, seg)
    assert torch.equal(ka, ra) and torch.equal(ku, ru)
    pa, pu = ta.clone(), tu.clone()
    pua, puu = ss._tree_scan(pa, pu)
    assert torch.equal(kua, pua) and torch.equal(kuu, puu)

    def combine(left, right):
        return left[0] * right[0], left[1] * right[0] + right[1]

    with jax.disable_jit():
        ja, ju = jax.lax.associative_scan(
            combine, (jnp.asarray(a, jnp.bfloat16),
                      jnp.asarray(u, jnp.bfloat16)), axis=1)
    for got, want in ((ka, ja), (ku, ju)):
        assert torch.equal(got.float(),
                           torch.from_numpy(np.asarray(want, np.float32)))


@pytest.mark.parametrize("q,seg", CASES, ids=[f"q{q}-seg{s}"
                                                for q, s in CASES])
def test_split_transpose_is_tree_transpose_bit_for_bit(q, seg):
    """The backward kernel's order of the transposed tree gives the bits of
    ``ss._tree_transpose`` in bfloat16."""
    rng = np.random.default_rng(q * 17 + seg)
    a0 = torch.from_numpy(rng.uniform(0.5, 1.0, (2, q, 3))).bfloat16()
    u0 = torch.from_numpy(rng.standard_normal((2, q, 3))).bfloat16()
    g0 = [torch.from_numpy(rng.standard_normal((2, q, 3))).bfloat16()
          for _ in range(2)]
    fa, fu = a0.clone(), u0.clone()
    (ua, uu), apre = split_scan(fa, fu, seg)
    want = [t.clone() for t in g0]
    ss._tree_transpose(*want, fa, fu, ua, uu, a0)
    got = [t.clone() for t in g0]
    split_transpose(*got, fa, fu, ua, uu, a0, apre, seg)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


# ---------------------------------------------------------------------------
# the native pair operations' premise: double rounding
# ---------------------------------------------------------------------------

def _bf16_exact(x) -> np.ndarray:
    """float64 values rounded once to bfloat16 (8 significant bits, ties to
    even, subnormals on bfloat16's 2**-133 grid, overflow to inf)."""
    x = np.asarray(x, np.float64)
    _, e = np.frexp(x)
    step = np.maximum(e - 8, -133)
    y = np.ldexp(np.rint(np.ldexp(x, -step)), step)
    big = np.ldexp(2.0 - 2.0 ** -8, 127)         # halfway past the largest
    return np.where(np.abs(x) >= big, np.copysign(np.inf, x), y)


def _bf16_of_f32(x) -> np.ndarray:
    """float32 values rounded to bfloat16 on their bits (ties to even), as
    float64; no NaN among them."""
    bits = np.asarray(x, np.float32).view(np.uint32).astype(np.uint64)
    top = ((bits + 0x7FFF + ((bits >> 16) & 1)) >> 16) << 16
    return top.astype(np.uint32).view(np.float32).astype(np.float64)


def _random_bf16(rng, n: int, emax: int) -> np.ndarray:
    """Random bfloat16 values (as float64) with exponents in [-emax,
    emax], both signs, and the edge values: +-0, subnormals, the smallest
    normal."""
    mant = rng.integers(128, 256, n)
    vals = np.ldexp(mant.astype(np.float64), rng.integers(-emax, emax + 1, n)
                    - 7) * rng.choice([-1.0, 1.0], n)
    edges = np.array([0.0, -0.0, 2.0 ** -133, -(2.0 ** -133),
                      127 * 2.0 ** -133, 2.0 ** -126, 1.0, -1.0])
    return np.concatenate([vals, edges])


def test_float32_product_and_sum_rounded_to_bf16_round_once():
    """The product and the sum of two bfloat16 values computed in float32
    and rounded to bfloat16 equal the exact result rounded once — what lets
    the kernels' native bfloat16 pair operations (one rounding) stand for
    the reference's float32-then-bfloat16 op by op (exact float64 products
    and sums: exponents within +-20)."""
    rng = np.random.default_rng(0)
    a = _random_bf16(rng, 1 << 18, 20)
    b = rng.permutation(_random_bf16(rng, 1 << 18, 20))
    prod32 = (a.astype(np.float32) * b.astype(np.float32))
    sum32 = (a.astype(np.float32) + b.astype(np.float32))
    assert np.array_equal(_bf16_of_f32(prod32), _bf16_exact(a * b))
    assert np.array_equal(_bf16_of_f32(sum32), _bf16_exact(a + b))


def test_a_single_rounded_multiply_add_differs():
    """A bfloat16 fused multiply-add, rounded once, is not the reference's
    ``u_l a_r + u_r`` rounded after each op: counterexamples are common
    (exponents within +-5, so float64 holds the exact value)."""
    rng = np.random.default_rng(1)
    ul, ar, ur = (_random_bf16(rng, 1 << 14, 5) for _ in range(3))
    two_step = _bf16_of_f32(_bf16_of_f32(ul.astype(np.float32)
                                         * ar.astype(np.float32)
                                         ).astype(np.float32)
                            + ur.astype(np.float32))
    fused = _bf16_exact(ul * ar + ur)
    differ = two_step != fused
    assert differ.any(), "no counterexample"
    assert 0.005 < differ.mean() < 0.2, differ.mean()


# ---------------------------------------------------------------------------
# the source
# ---------------------------------------------------------------------------

def _bf16_section() -> str:
    src = CSRC.read_text()
    start = src.index("// the fused form with the bfloat16 working type")
    return src[start:src.index("}  // namespace", start)]


def test_bf16_scan_kernels_use_no_atomics_and_no_read_modify_write():
    """No atomic in the working type's kernels; the dB, dC partials leave
    each block once a chunk (one store of ``bc_part``, never read back)."""
    sec = _bf16_section()
    assert "atomic" not in sec.lower()
    assert len(re.findall(r"\bbc_part\b", sec)) == 1
    assert re.search(r"p\.bc_part\[[^;]*\]\s*=\s*sm\.acc", sec, re.S)


def test_the_old_bf16_design_is_gone():
    """The backward no longer walks its block's channel pairs in turn on
    one warp, and no lane walks its tree alone: both kernels launch eight
    warps, and the column helpers of the old design are gone."""
    sec = _bf16_section()
    assert not re.search(r"for \(int \w+ = 0; \w+ < kWPairs; ", sec)
    for gone in ("add_part", "tree_up", "tree_down", "combine_bf16",
                 "uncombine_bf16", "kWBwdThreads", "work_bwd_smem"):
        assert gone not in sec, gone
    assert re.search(r"scan_bf16_bwd_kernel<T, Q><<<grid, kWThreads", sec)
    assert re.search(r"scan_bf16_kernel<T, BOUND, Q><<<grid, kWThreads", sec)
    assert "kWThreads = 32 * kWPairs" in sec


def test_no_switch_between_designs():
    """Neither the source nor its wrapper reads the environment or a flag
    to pick a design; the only choice is the compile-time q = 128
    instance beside the generic one, both of the one layout."""
    src = CSRC.read_text()
    wrapper = Path(ss.__file__).read_text()
    for text in (src, wrapper):
        assert "getenv" not in text and "environ" not in text
    sec = _bf16_section()
    assert re.findall(r"p\.q == kWChunkMax", sec) and len(
        re.findall(r"\? launch_bf16(?:_bwd)?_q<", sec)) == 2
