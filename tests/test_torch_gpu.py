"""Card-only tests of the PyTorch package (marker ``gpu``).

They build the CUDA kernels with ``nvcc``, launch them, and hold them and
the engine on the card against the plain PyTorch versions and the host
NumPy engine: the group reduces bit for bit, the model kernels (rmsnorm,
flash_attention, selective_scan) at the JAX package's kernel tolerances.
The gather forms of ``group_min_scale`` and ``group_max`` are held
bit-equal to their plain versions, the residual form of ``rmsnorm`` bit-equal
in its sum and within the norm's tolerance, and the bfloat16 tensor-core
attention kernel to the float32 plain version within 2e-2, at long and wide
shapes too.  The scan is held to its plain version at every lane count, and
its fused Mamba1 form (bias, softplus, scan, D skip, gate in one launch) at
falcon-mamba-7b's prefill and decode-step shapes with the model's views and
the decode cache's state updated in place, and with the bfloat16 working
type (``scan_dtype="bfloat16"``) forward and backward against their plain
versions at ragged chunk lengths.  The planner's other entry
points run there too: the live bandwidth probe, the plan server, an
elastic replan and a churn replay, each equal to the host NumPy backend's
result.  So does training: the backward kernels of ``rmsnorm`` (both forms)
and ``flash_attention`` against their plain versions (the norm's and the
bfloat16 attention backward also bit-equal to themselves from launch to
launch, the norm's under a CUDA-graph replay too), the
fused scan's backward against its plain version at ragged shapes and at
falcon-mamba-7b's training microbatch (bit-equal to itself too), the
autograd Functions the wrappers hand a gradient to, the scan forms that
still refuse one, a gradient that reaches every parameter of a dense and
of a Mamba1 layer, a Mamba1 train step's launch counts, and a train step
against the host's and against itself bit for bit.  The hybrid family
(zamba2-7b) adds the ``rmsnorm`` type pair of Mamba2's gated norm (a
float32 input, a bfloat16 weight, d 7168), forward and backward, a
reduced zamba2 prefill and decode, and its train step against the host's
and against itself.  Without a CUDA device
every test here skips with a reason
(decided inside the test, never at import).  This file imports ``torch``
and ``repro_torch`` only, so it also runs on a machine without JAX:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu.py
"""
import json

import numpy as np
import pytest
import torch

from repro_torch import configs
from repro_torch.core import annealing, cluster, dedication, plan, simulator
from repro_torch.core.memory import enumerate_confs
from repro_torch.core.torch_engine import TorchDedicationEngine
from repro_torch.kernels import _build
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import group_reduce as gr
from repro_torch.kernels import rmsnorm as rn
from repro_torch.kernels import selective_scan as ss
from repro_torch.launch import generate as gen_cli
from repro_torch.models import model as M
from repro_torch.models.config import ModelConfig
from repro_torch.models.sharding import ShardCtx
from repro_torch.models.transformer import init_params

pytestmark = pytest.mark.gpu

MIN_SCALE_SHAPES = [(1, 2), (7, 4), (128, 8), (130, 2), (32 * 128, 8)]
MAX_SHAPES = [(1, 3), (9, 16), (128, 4), (257, 8), (32 * 8, 128), (16, 1024)]
GPT = ModelConfig(name="g12", family="dense", n_layers=12, d_model=1024,
                  n_heads=16, n_kv_heads=16, d_ff=4096, vocab_size=32000)


def _need_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels are CUDA C++ and have "
                    "no CPU mode")


def _random_sub(rng, n, m):
    sub = rng.uniform(0.5, 300.0, size=(n, m, m)) * 1e9
    di = np.arange(m)
    sub[:, di, di] = np.inf
    sub[rng.integers(n), 0, min(1, m - 1)] = 0.0
    if n > 2:
        sub[1] = np.inf
    return sub


def _mixed():
    return cluster.mixed_fleet_spec("gpu-mixed-8x2", 8,
                                    (cluster.A100_TIER, cluster.V100_TIER),
                                    (0.5, 0.5), gpus_per_node=2, seed=31)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32],
                         ids=["f64", "f32"])
@pytest.mark.parametrize("n,m", MIN_SCALE_SHAPES)
def test_group_min_scale_kernel_bit_equal_to_plain(n, m, dtype):
    _need_cuda()
    sub = torch.from_numpy(
        _random_sub(np.random.default_rng(n * 31 + m), n, m)).to(dtype).cuda()
    before = gr.group_min_scale.launches
    got = gr.group_min_scale(sub, 25e9)
    torch.cuda.synchronize()
    assert gr.group_min_scale.launches == before + 1
    assert got.shape == (n,) and got.dtype == dtype
    assert torch.equal(got, gr.group_min_scale_ref(sub, 25e9))
    assert torch.equal(got.cpu(), gr.group_min_scale_ref(sub.cpu(), 25e9))


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32],
                         ids=["f64", "f32"])
@pytest.mark.parametrize("n,m", MAX_SHAPES)
def test_group_max_kernel_bit_equal_to_plain(n, m, dtype):
    _need_cuda()
    vals = torch.from_numpy(np.random.default_rng(n * 17 + m).uniform(
        1.0, 3.0, size=(n, m))).to(dtype).cuda()
    before = gr.group_max.launches
    got = gr.group_max(vals)
    torch.cuda.synchronize()
    assert gr.group_max.launches == before + 1
    assert torch.equal(got, gr.group_max_ref(vals))


#: (rows, tp, cp, n): ragged row and group counts, m in {2, 4, 8, 16}, TP
#: groups (cp == 1) and CP groups (members tp apart), up to a plan's sizes.
GATHER_CASES = [(1, 2, 1, 6), (3, 4, 1, 28), (33, 8, 1, 128), (5, 16, 1, 48),
                (7, 1, 2, 10), (4, 2, 4, 24), (130, 4, 8, 128),
                (2, 2, 16, 64), (32, 8, 2, 1024)]


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32],
                         ids=["f64", "f32"])
@pytest.mark.parametrize("rows,tp,cp,n", GATHER_CASES, ids=str)
def test_group_min_scale_gather_kernel_bit_equal_to_plain(rows, tp, cp, n,
                                                           dtype):
    _need_cuda()
    rng = np.random.default_rng(rows * 131 + n)
    table = rng.uniform(0.5, 300.0, size=(n, n)) * 1e9
    np.fill_diagonal(table, np.inf)
    table[0, 1] = table[1, 0] = 0.0                   # a degenerate link
    perm = np.stack([rng.permutation(n) for _ in range(rows)])
    table = torch.from_numpy(table).to(dtype).cuda()
    perm = torch.from_numpy(perm).cuda()
    geom = gr.tp_geometry(tp) if cp == 1 else gr.cp_geometry(tp, cp)
    for ref_bw in (25e9, 1e8):                        # scaled, clamped
        before = gr.group_min_scale.launches
        got = gr.group_min_scale_gather(table, perm, ref_bw, *geom)
        torch.cuda.synchronize()
        assert gr.group_min_scale.launches == before + 1
        assert got.shape == (rows,) and got.dtype == dtype
        want = gr.group_min_scale_gather_ref(table, perm, ref_bw, *geom)
        assert torch.equal(got, want)
        assert torch.equal(got.cpu(), gr.group_min_scale_gather_ref(
            table.cpu(), perm.cpu(), ref_bw, *geom))


#: (B, pp, nc): the CPU tests' cases, more stages than warps in a block
#: (pp 40), more members than lanes (nc 512), and a tiered plan's size.
MAX_GATHER_CASES = [(1, 1, 3), (3, 3, 16), (16, 8, 4), (257, 1, 8),
                    (5, 40, 3), (4, 2, 512), (64, 8, 128)]


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32],
                         ids=["f64", "f32"])
@pytest.mark.parametrize("b,pp,nc", MAX_GATHER_CASES, ids=str)
def test_group_max_gather_kernel_bit_equal_to_plain(b, pp, nc, dtype):
    _need_cuda()
    rng = np.random.default_rng(b * 131 + pp * 7 + nc)
    n = pp * nc
    slow = torch.from_numpy(rng.uniform(1.0, 3.0, size=n)).to(dtype).cuda()
    perm = torch.from_numpy(np.stack([rng.permutation(n) for _ in range(b)]))
    perm = perm.cuda()
    cw = torch.from_numpy(rng.uniform(0.5, 2.0, size=(b, pp))).to(dtype)
    cw = cw.cuda()
    before = gr.group_max.launches
    key = ("gather", b, pp, nc, n)
    before_key = gr.group_max.shapes[key]
    c_x, c_max = gr.group_max_gather(slow, perm, cw, nc)
    torch.cuda.synchronize()
    assert gr.group_max.launches == before + 1
    assert gr.group_max.shapes[key] == before_key + 1
    assert c_x.shape == (b, pp) and c_max.shape == (b,)
    assert c_x.dtype == c_max.dtype == dtype
    want = gr.group_max_gather_ref(slow, perm, cw, nc)
    assert torch.equal(c_x, want[0]) and torch.equal(c_max, want[1])
    host = gr.group_max_gather_ref(slow.cpu(), perm.cpu(), cw.cpu(), nc)
    assert torch.equal(c_x.cpu(), host[0])
    assert torch.equal(c_max.cpu(), host[1])


def test_wrappers_raise_on_cuda_tensors_they_do_not_take():
    _need_cuda()
    sub = torch.ones(4, 2, 4, dtype=torch.float64, device="cuda")
    with pytest.raises(ValueError):
        gr.group_min_scale(sub[:, :, ::2], 1.0)        # not contiguous
    with pytest.raises(TypeError):
        gr.group_max(torch.ones(3, 4, dtype=torch.float16, device="cuda"))
    empty = gr.group_max(torch.ones(0, 4, dtype=torch.float64,
                                    device="cuda"))
    assert empty.shape == (0,)
    slow = torch.ones(6, dtype=torch.float64, device="cuda")
    perm = torch.arange(6, device="cuda")[None]
    cw = torch.ones(1, 2, dtype=torch.float64, device="cuda")
    with pytest.raises(TypeError):
        gr.group_max_gather(slow, perm.int(), cw, 3)
    with pytest.raises(ValueError):
        gr.group_max_gather(slow, perm, cw, 2)
    with pytest.raises(ValueError):                    # perm on the host
        gr.group_max_gather(slow, perm.cpu(), cw, 3)


def test_score_on_the_card_hex_equal_to_host_engine():
    _need_cuda()
    spec = _mixed()
    w = simulator.Workload(GPT, 2048, 32)
    bw, _ = cluster.profile_bandwidth(spec)
    confs = [c for c in enumerate_confs(spec.n_gpus, 32, n_layers=12,
                                        max_cp=2, seq=2048)
             if c.pp > 1 and c.tp > 1][:4]
    rng = np.random.default_rng(0)
    before = (gr.group_min_scale.launches, gr.group_max.launches)
    for conf in confs:
        prof = simulator.build_profile(w, spec, conf)
        host = dedication.DedicationEngine(conf, bw, prof, spec)
        card = TorchDedicationEngine([conf], [prof], bw, spec)  # device=None
        assert card.device.type == "cuda"
        for _ in range(3):
            perm = rng.permutation(spec.n_gpus)
            assert float(card.score(perm)).hex() == \
                float(host.score(perm)).hex()
    assert gr.group_min_scale.launches > before[0]
    assert gr.group_max.launches > before[1]


@pytest.mark.parametrize("hier", [False, True], ids=["flat", "hier"])
def test_plan_on_the_card_byte_equal_to_host_backend(hier):
    _need_cuda()
    spec = _mixed()
    bw, _ = cluster.profile_bandwidth(spec)

    def make(backend):
        req = plan.PlanRequest(
            simulator.Workload(GPT, 2048, 32), spec,
            plan.SearchSpace(max_micro=2, max_cp=2),
            plan.Budget(sa_seconds=600.0, sa_iters=60, n_chains=3,
                        sa_topk=3, backend=backend, hierarchical=hier),
            seed=11)
        d = plan.Planner(plan.PipetteStrategy()).plan(req, bw).to_json_dict()
        assert d["provenance"]["budget"].pop("backend") == backend
        return json.dumps(d, sort_keys=True)

    assert make("torch") == make("numpy")
    assert annealing.HIER_AUTO_GPUS == 2048


# ---------------------------------------------------------------------------
# model kernels: rmsnorm, flash_attention, selective_scan against their plain
# versions on the card
# ---------------------------------------------------------------------------


#: (b, h, kv, sq, sk, d, causal, window): the JAX package's kernel sweep,
#: ragged lengths, a window that masks whole key tiles, rows with no allowed
#: key (sk < sq under a window) and the qwen2-7b prefill shape.
FA_SHAPES = [
    (2, 4, 2, 128, 128, 32, True, 0), (1, 4, 4, 256, 256, 64, True, 0),
    (2, 2, 1, 128, 256, 32, False, 0), (1, 4, 2, 256, 256, 32, True, 64),
    (1, 8, 2, 128, 128, 128, True, 0), (1, 2, 2, 64, 192, 16, True, 48),
    (2, 4, 2, 50, 50, 64, True, 0), (1, 2, 1, 37, 71, 32, False, 0),
    (1, 4, 2, 200, 200, 128, True, 40), (1, 2, 2, 64, 16, 16, True, 8),
    (1, 2, 1, 33, 33, 256, True, 0), (4, 28, 4, 512, 512, 128, True, 0),
]
#: (b, s, d, n): the JAX package's scan sweep and a falcon-mamba layer.
SCAN_SHAPES = [(2, 64, 32, 8), (1, 96, 16, 4), (2, 128, 64, 16),
               (1, 50, 24, 8), (1, 17, 100, 16), (4, 512, 8192, 16)]
RMS_SHAPES = [(1, 32), (7, 128), (70, 384), (33, 3584), (2048, 4096),
              (5, 1, 3584)]


def _randn(rng, shape, dtype, scale=1.0):
    return (torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
            * scale).to(dtype).cuda()


def _close(got, want, tol):
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("shape", RMS_SHAPES, ids=str)
def test_rmsnorm_kernel_matches_plain(shape, dtype):
    _need_cuda()
    rng = np.random.default_rng(sum(shape))
    x = _randn(rng, shape, dtype, 3.0)
    w = _randn(rng, shape[-1:], dtype)
    before = rn.rmsnorm.launches
    got = rn.rmsnorm(x, w, 1e-5)
    torch.cuda.synchronize()
    assert rn.rmsnorm.launches == before + 1
    assert got.shape == x.shape and got.dtype == dtype
    _close(got, rn.rmsnorm_ref(x, w, 1e-5),
           1e-5 if dtype == torch.float32 else 3e-2)


def test_rmsnorm_kernel_mixed_types_and_strided_rows():
    _need_cuda()
    rng = np.random.default_rng(3)
    x = _randn(rng, (4, 9, 256), torch.bfloat16)[:, -1:]   # not contiguous
    w = _randn(rng, (256,), torch.float32)
    _close(rn.rmsnorm(x, w), rn.rmsnorm_ref(x, w), 3e-2)
    x32 = _randn(rng, (6, 256), torch.float32)
    wb = _randn(rng, (256,), torch.bfloat16)
    _close(rn.rmsnorm(x32, wb), rn.rmsnorm_ref(x32, wb), 1e-5)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("shape", RMS_SHAPES + [(7, 100)], ids=str)
def test_add_rmsnorm_kernel_matches_plain(shape, dtype):
    _need_cuda()
    rng = np.random.default_rng(sum(shape) + 1)
    x = _randn(rng, shape, dtype, 3.0)
    r = _randn(rng, shape, dtype)
    w = _randn(rng, shape[-1:], dtype)
    before = rn.rmsnorm.launches
    key = ("add", x.shape, dtype, dtype)
    before_key = rn.rmsnorm.shapes[key]
    s, y = rn.add_rmsnorm(x, r, w, 1e-5)
    torch.cuda.synchronize()
    assert rn.rmsnorm.launches == before + 1
    assert rn.rmsnorm.shapes[key] == before_key + 1
    assert s.shape == y.shape == x.shape and s.dtype == y.dtype == dtype
    want_s, want_y = rn.add_rmsnorm_ref(x, r, w, 1e-5)
    assert torch.equal(s, want_s)
    _close(y, want_y, 1e-5 if dtype == torch.float32 else 3e-2)


def test_add_rmsnorm_kernel_unaligned_rows_and_mixed_types():
    _need_cuda()
    rng = np.random.default_rng(9)
    # a 2-byte offset: the kernel takes one element at a time
    flat = _randn(rng, (6 * 256 + 1,), torch.bfloat16)
    x = flat[1:].view(6, 256)
    r = _randn(rng, (6, 256), torch.bfloat16)
    for w in (_randn(rng, (256,), torch.float32),
              _randn(rng, (256,), torch.bfloat16)):
        s, y = rn.add_rmsnorm(x, r, w)
        want_s, want_y = rn.add_rmsnorm_ref(x, r, w)
        assert torch.equal(s, want_s)
        _close(y, want_y, 3e-2)
    with pytest.raises(TypeError):
        rn.add_rmsnorm(x, r.float(), w)
    with pytest.raises(ValueError):
        rn.add_rmsnorm(x, r.T.contiguous().T, w)        # not contiguous


@pytest.mark.parametrize("arch", ["qwen2-7b", "falcon-mamba-7b"])
def test_generation_norms_split_plain_and_residual_on_the_card(arch):
    """A prefill launches one plain norm over the sequence, ``norms - 2``
    residual norms and one plain norm of the last row; a decode step one
    plain and ``norms - 1`` residual ones."""
    _need_cuda()
    cfg = configs.get(arch).reduced()
    params = init_params(cfg, seed=0)
    ctx = ShardCtx()
    toks = torch.randint(0, cfg.vocab_size, (2, 17), device="cuda",
                         generator=torch.Generator("cuda").manual_seed(0))
    norms = 1 + (2 if cfg.family == "dense" else 1) * cfg.n_layers
    rn.rmsnorm.launches = 0
    rn.rmsnorm.shapes.clear()
    _, cache = M.prefill(params, cfg, ctx, toks[:, :16])
    M.decode_step(params, cfg, ctx, toks[:, 16:],
                  gen_cli.grow_cache(cache, 1), 16)
    torch.cuda.synchronize()
    dt, d = params["final_norm"].dtype, cfg.d_model
    assert rn.rmsnorm.launches == 2 * norms
    assert dict(rn.rmsnorm.shapes) == {
        ((2, 16, d), dt, dt): 1, ("add", (2, 16, d), dt, dt): norms - 2,
        ((2, 1, d), dt, dt): 2, ("add", (2, 1, d), dt, dt): norms - 1}


def _attention_inputs(case, dtype, layout):
    b, h, kv, sq, sk, d, causal, window = case
    rng = np.random.default_rng(sq * 7 + sk + d)
    if layout == "bhsd":
        return (_randn(rng, (b, h, sq, d), dtype),
                _randn(rng, (b, kv, sk, d), dtype),
                _randn(rng, (b, kv, sk, d), dtype))
    # the model's (B, S, H, D), viewed
    return (_randn(rng, (b, sq, h, d), dtype).transpose(1, 2),
            _randn(rng, (b, sk, kv, d), dtype).transpose(1, 2),
            _randn(rng, (b, sk, kv, d), dtype).transpose(1, 2))


@pytest.mark.parametrize("layout", ["bhsd", "bshd"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("case", FA_SHAPES, ids=str)
def test_flash_attention_kernel_matches_plain(case, dtype, layout):
    _need_cuda()
    causal, window = case[6], case[7]
    q, k, v = _attention_inputs(case, dtype, layout)
    before = fa.flash_attention.launches
    got = fa.flash_attention(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    assert fa.flash_attention.launches == before + 1
    assert got.shape == q.shape and got.stride() == q.stride()
    _close(got, fa.flash_attention_ref(q, k, v, causal=causal,
                                       window=window),
           2e-5 if dtype == torch.float32 else 2e-2)


#: Long and wide cases of the bfloat16 tensor-core kernel: 2048 keys
#: (causal; a short query block against them; a window of 1000 keys) and
#: D = 256 (gemma3-12b's head dim: key tiles of 32, Q read from shared
#: memory), ragged and windowed.
FA_BF16_EXTRA = [
    (1, 4, 2, 2048, 2048, 128, True, 0), (2, 4, 1, 100, 2048, 64, False, 0),
    (1, 4, 2, 2048, 2048, 64, True, 1000), (1, 2, 1, 300, 300, 256, True, 0),
    (1, 4, 2, 130, 200, 256, False, 0), (1, 2, 2, 257, 257, 256, True, 50),
]


@pytest.mark.parametrize("layout", ["bhsd", "bshd"])
@pytest.mark.parametrize("case", FA_BF16_EXTRA, ids=str)
def test_flash_attention_tensor_cores_long_and_wide(case, layout):
    _need_cuda()
    causal, window = case[6], case[7]
    q, k, v = _attention_inputs(case, torch.bfloat16, layout)
    before = fa.flash_attention.launches
    got = fa.flash_attention(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    assert fa.flash_attention.launches == before + 1
    assert got.shape == q.shape and got.stride() == q.stride()
    assert bool(torch.isfinite(got.float()).all())
    _close(got, fa.flash_attention_ref(q, k, v, causal=causal,
                                       window=window), 2e-2)


def test_flash_attention_bf16_refuses_misaligned_views():
    _need_cuda()
    base = torch.zeros(1, 2, 16, 36, dtype=torch.bfloat16, device="cuda")
    before = fa.flash_attention.launches
    for view, what in ((base[..., 1:33], "pointer"),
                       (base[..., :32], "sequence stride")):
        with pytest.raises(ValueError, match=what):
            fa.flash_attention(view, view, view)
    assert fa.flash_attention.launches == before
    f = base[..., 1:33].float()                        # float32 takes it
    assert fa.flash_attention(f, f, f).shape == f.shape


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("shape", SCAN_SHAPES, ids=str)
def test_selective_scan_kernel_matches_plain(shape, dtype):
    _need_cuda()
    b, s, d, n = shape
    rng = np.random.default_rng(sum(shape))
    x = _randn(rng, (b, s, d), dtype, 0.5)
    dt = (torch.nn.functional.softplus(_randn(rng, (b, s, d),
                                              torch.float32)) * 0.1).to(dtype)
    # B and C as column slices of one projection, as the model has them
    proj = _randn(rng, (b, s, 3 + 2 * n), dtype)
    B, C = proj[..., 3:3 + n], proj[..., 3 + n:]
    A = -torch.exp(_randn(rng, (d, n), torch.float32, 0.3))
    h0 = _randn(rng, (b, d, n), torch.float32) if s < 100 else None
    before = ss.selective_scan.launches
    y, h = ss.selective_scan(x, dt, B, C, A, h0)
    torch.cuda.synchronize()
    assert ss.selective_scan.launches == before + 1
    yr, hr = ss.selective_scan_ref(x, dt, B, C, A, h0)
    assert y.dtype == h.dtype == torch.float32
    _close(y, yr, 2e-4)
    _close(h, hr, 2e-4)


@pytest.mark.parametrize("shape", [(2, 64, 32, 8), (1, 50, 24, 8),
                                   (1, 17, 100, 16), (1, 21, 45, 7)],
                         ids=str)
def test_selective_scan_with_h0_matches_plain(shape):
    """Every shape with a start state, in both types, bfloat16 views with a
    misaligned projection (B and C at an odd column) included."""
    _need_cuda()
    b, s, d, n = shape
    rng = np.random.default_rng(sum(shape) + 4)
    for dtype in (torch.float32, torch.bfloat16):
        x = _randn(rng, (b, s, d), dtype, 0.5)
        dt = (torch.nn.functional.softplus(_randn(rng, (b, s, d),
                                                  torch.float32)) * 0.1
              ).to(dtype)
        proj = _randn(rng, (b, s, 3 + 2 * n), dtype)
        B, C = proj[..., 3:3 + n], proj[..., 3 + n:]
        A = -torch.exp(_randn(rng, (d, n), torch.float32, 0.3))
        h0 = _randn(rng, (b, d, n), torch.float32)
        y, h = ss.selective_scan(x, dt, B, C, A, h0)
        yr, hr = ss.selective_scan_ref(x, dt, B, C, A, h0)
        _close(y, yr, 2e-4)
        _close(h, hr, 2e-4)


#: (b, s, d, n, dt_rank): the fused form at the scan sweep, a ragged width,
#: falcon-mamba-7b's prefill and decode-step shapes (dt_rank 256), a
#: projection whose B and C start at an odd column, and an odd width and
#: state size (a thread's second channel out of range, padded states).
FUSED_SHAPES = [(2, 64, 32, 8, 2), (1, 50, 24, 8, 2), (1, 17, 100, 16, 4),
                (2, 40, 64, 16, 3), (4, 512, 8192, 16, 256),
                (4, 1, 8192, 16, 256), (3, 1, 100, 16, 3),
                (2, 19, 45, 7, 3)]


def _fused_inputs(shape, dtype, seed):
    """Inputs laid out as ``mamba1_block`` hands them: ``dt, B, C`` from one
    projection (``dt`` through ``dt_w`` is a new tensor; ``B, C`` column
    slices), ``z`` the second half of ``xz``, and ``h0`` a state of the
    decode cache."""
    b, s, d, n, rank = shape
    rng = np.random.default_rng(seed)
    xz = _randn(rng, (b, s, 2 * d), dtype)
    x = torch.nn.functional.silu(xz[..., :d].float()).to(dtype)
    proj = _randn(rng, (b, s, rank + 2 * n), dtype)
    dt = _randn(rng, (b, s, d), dtype, 0.5)
    dt_bias = _randn(rng, (d,), torch.float32, 0.5) - 2.0
    A_log = torch.log(torch.arange(1, n + 1, dtype=torch.float32, device="cuda"
                                   )).expand(d, n) \
        + _randn(rng, (d, n), torch.float32, 0.1)
    D = _randn(rng, (d,), torch.float32)
    h0 = _randn(rng, (b, d, n), torch.float32)
    return (x, dt, dt_bias, proj[..., rank:rank + n], proj[..., rank + n:],
            A_log.contiguous(), D, xz[..., d:]), h0


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("shape", FUSED_SHAPES, ids=str)
def test_selective_scan_fused_kernel_matches_plain(shape, dtype):
    """``out`` within the JAX package's kernel tolerance of its type (2e-4
    float32, 2e-2 bfloat16), the float32 state within 2e-4; ``h_out``
    aliasing ``h0`` is updated in place; one launch a call."""
    _need_cuda()
    args, h0 = _fused_inputs(shape, dtype, sum(shape))
    assert not args[3].is_contiguous() and not args[7].is_contiguous()
    step = shape[1] == 1
    want_out, want_h = ss.selective_scan_fused_ref(*args, h0.clone(),
                                                   step=step)
    before = ss.selective_scan.launches
    key = ("fused", args[0].shape, shape[3], dtype, step)
    seen = ss.selective_scan.shapes[key]
    state = h0.clone()
    out, h = ss.selective_scan_fused(*args, state, state, step=step)
    torch.cuda.synchronize()
    assert ss.selective_scan.launches == before + 1
    assert ss.selective_scan.shapes[key] == seen + 1
    assert h is state and out.dtype == dtype and out.is_contiguous()
    _close(out, want_out, 2e-2 if dtype == torch.bfloat16 else 2e-4)
    _close(h, want_h, 2e-4)
    # without h0 and h_out: a zero start, a new state
    if not step:
        out0, h0_ = ss.selective_scan_fused(*args)
        want0, wanth0 = ss.selective_scan_fused_ref(*args)
        _close(out0, want0, 2e-2 if dtype == torch.bfloat16 else 2e-4)
        _close(h0_, wanth0, 2e-4)


def test_falcon_block_runs_only_the_fused_scan_on_the_card():
    """A reduced falcon-mamba-7b prefill and decode step launch the fused
    form once a layer each (no plain scan), and the decode step writes the
    new state into the cache row it read."""
    _need_cuda()
    cfg = configs.get("falcon-mamba-7b").reduced()
    params = init_params(cfg, seed=0)
    ctx = ShardCtx()
    toks = torch.randint(0, cfg.vocab_size, (2, 17), device="cuda",
                         generator=torch.Generator("cuda").manual_seed(0))
    ss.selective_scan.launches = 0
    ss.selective_scan.shapes.clear()
    _, cache = M.prefill(params, cfg, ctx, toks[:, :16])
    cache = gen_cli.grow_cache(cache, 1)
    ssm, before = cache["ssm"], cache["ssm"].clone()
    M.decode_step(params, cfg, ctx, toks[:, 16:], cache, 16)
    torch.cuda.synchronize()
    dt, di, n = params["final_norm"].dtype, cfg.d_inner, cfg.ssm_state
    assert ss.selective_scan.launches == 2 * cfg.n_layers
    assert dict(ss.selective_scan.shapes) == {
        ("fused", (2, 16, di), n, dt, False): cfg.n_layers,
        ("fused", (2, 1, di), n, dt, True): cfg.n_layers}
    assert cache["ssm"] is ssm and not torch.equal(ssm, before)


def test_model_kernel_wrappers_raise_on_what_they_do_not_take():
    _need_cuda()
    q = torch.ones(1, 2, 8, 48, device="cuda")
    with pytest.raises(ValueError):
        fa.flash_attention(q, q, q)                    # head dim 48
    q = torch.ones(1, 2, 8, 32, device="cuda")
    with pytest.raises(TypeError):
        fa.flash_attention(q, q.half(), q)
    with pytest.raises(ValueError):
        rn.rmsnorm(q, torch.ones(16, device="cuda"))
    x = torch.ones(1, 4, 8, device="cuda")
    bn = torch.ones(1, 4, 32, device="cuda")
    with pytest.raises(ValueError):                    # N = 32 > 16
        ss.selective_scan(x, x, bn, bn, torch.ones(8, 32, device="cuda"))
    f = torch.ones(8, device="cuda")
    with pytest.raises(ValueError):                    # N = 32 > 16
        ss.selective_scan_fused(x, x, f, bn, bn,
                                torch.ones(8, 32, device="cuda"), f, x)
    b2 = torch.ones(1, 4, 2, device="cuda")
    with pytest.raises(TypeError):                     # mixed types
        ss.selective_scan_fused(x, x.bfloat16(), f, b2, b2,
                                torch.ones(8, 2, device="cuda"), f, x)
    with pytest.raises(ValueError):                    # h_out shape
        ss.selective_scan_fused(x, x, f, b2, b2,
                                torch.ones(8, 2, device="cuda"), f, x,
                                h_out=torch.ones(1, 8, 3, device="cuda"))


# ---------------------------------------------------------------------------
# the planner's other entry points on the card: the live probe, the plan
# server, elastic replanning and the churn replay
# ---------------------------------------------------------------------------

def _without_backend(text):
    d = json.loads(text)
    d["provenance"]["budget"].pop("backend")
    return json.dumps(d, sort_keys=True)


def test_live_probe_on_the_visible_cards():
    _need_cuda()
    bw = cluster.profile_bandwidth_live()
    n = torch.cuda.device_count()
    assert bw.shape == (n, n)
    assert np.isinf(np.diag(bw)).all()
    off = bw[~np.eye(n, dtype=bool)]
    assert np.isfinite(off).all() and (off > 0).all()


def test_plan_server_on_the_card_serves_the_numpy_plan():
    """``PlanServer(device=None)`` resolves the card in the calling
    thread; its torch-backend plan is the NumPy-backend plan byte for
    byte (backend dropped), passes the verifier, and the searches
    launched the gather kernel."""
    _need_cuda()
    from repro_torch.analysis import verify_plan_dict
    from repro_torch.service import PlanClient, PlanServer
    spec = cluster.MID_RANGE.with_nodes(2)
    reqs = [plan.PlanRequest(
        simulator.Workload(GPT, 2048, 32), spec,
        plan.SearchSpace(max_micro=2),
        plan.Budget(sa_seconds=600.0, sa_iters=60, sa_topk=2,
                    backend=b), seed=3) for b in ("torch", "numpy")]
    server = PlanServer(port=0, warm_start=False)
    assert server.device.type == "cuda" and server.device.index is not None
    thread = server.start_in_thread()
    try:
        client = PlanClient(port=server.port)
        before = gr.group_min_scale.launches
        got, want = (client.submit(r)["plan"] for r in reqs)
        launched = gr.group_min_scale.launches - before
    finally:
        server.stop()
        thread.join(timeout=60)
    assert launched > 0
    assert _without_backend(got) == _without_backend(want)
    assert not [i for i in verify_plan_dict(json.loads(got), spec=spec)
                if i.severity == "error"]


def test_replan_on_the_card_equals_the_numpy_replan():
    """A tiered fleet loses one node: the warm replan on the card is the
    NumPy replan byte for byte and launches ``group_max`` in its gather
    form."""
    _need_cuda()
    from repro_torch.runtime.elastic import replan
    spec = _mixed()
    w = simulator.Workload(GPT, 2048, 32)
    kw = dict(sa_seconds=600.0, sa_iters=60, sa_topk=2, max_micro=2)
    inc = replan(w, spec, healthy_nodes=8, backend="numpy", **kw).plan
    before = gr.group_max.launches
    got = replan(w, spec, healthy_nodes=[0, 1, 2, 4, 5, 6, 7],
                 incumbent=inc, migration_weight=1e-4, **kw)
    launched = gr.group_max.launches - before
    want = replan(w, spec, healthy_nodes=[0, 1, 2, 4, 5, 6, 7],
                  incumbent=inc, migration_weight=1e-4, backend="numpy",
                  **kw)
    assert launched > 0
    assert _without_backend(got.plan.to_json()) \
        == _without_backend(want.plan.to_json())


def test_churn_replay_on_the_card_equals_numpy():
    _need_cuda()
    import dataclasses
    from repro_torch.runtime.churn import (COLD_POLICY, WARM_POLICY,
                                           generate_trace, simulate_churn)
    spec = cluster.MID_RANGE.with_nodes(3)
    w = simulator.Workload(configs.get("gpt-1.1b").reduced(), 2048, 64)
    trace = generate_trace(spec, horizon_s=600, seed=1, min_nodes=2)
    for pol in (WARM_POLICY, COLD_POLICY):
        pol = dataclasses.replace(pol, sa_iters=40, sa_seconds=600.0)
        card = simulate_churn(w, spec, trace, pol)
        host = simulate_churn(w, spec, trace, dataclasses.replace(
            pol, backend="numpy", device="cpu"))
        assert json.dumps(card.to_json_dict(), sort_keys=True) \
            == json.dumps(host.to_json_dict(), sort_keys=True)


# ---------------------------------------------------------------------------
# training: the backward kernels, the Functions, the train step
# ---------------------------------------------------------------------------

#: (rows, d) of the norm backward: packed and unpacked rows, one row, more
#: rows than the kernel's 128 blocks, and the training paths' widths —
#: gpt-demo's 768 (8 rows a block), gpt-1.1b's 1920, zamba2's 7168 (the
#: widest the ring of row stages takes) — and 12288, wider than the ring,
#: at 64 rows (fewer rows than blocks).
RMS_BWD_SHAPES = [(1, 32), (7, 384), (70, 4096), (5, 36), (3, 33),
                  (300, 128), (1024, 768), (512, 1920), (1024, 7168),
                  (64, 12288)]
#: (b, h, kv, sq, sk, d, causal, window): GQA, Sq != Sk both ways, a
#: window, rows with no allowed key (the sixth), every head dim; groups of
#: one head (no fold in bfloat16), two, four and seven (qwen2-7b's); keys
#: no query may see (the last: causal with Sq < Sk).
FA_BWD_CASES = [(2, 4, 2, 64, 64, 32, True, 0), (1, 4, 1, 50, 90, 64, False, 0),
                (1, 2, 2, 100, 100, 128, True, 16),
                (2, 8, 2, 96, 40, 128, True, 0), (1, 2, 1, 40, 40, 256, True, 0),
                (1, 2, 2, 64, 16, 16, True, 8),
                (1, 14, 2, 130, 130, 128, True, 0),
                (2, 4, 4, 70, 33, 256, False, 0),
                (1, 7, 1, 33, 77, 32, True, 20)]


def _rel_close(got, want, tol):
    got, want = got.float().cpu(), want.float().cpu()
    assert got.shape == want.shape
    scale = max(float(want.abs().max()), 1e-30)
    err = float((got - want).abs().max())
    assert err <= tol * scale, (err, scale)


@pytest.mark.parametrize("with_ds", [False, True], ids=["plain", "ds_in"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("shape", RMS_BWD_SHAPES, ids=str)
def test_rmsnorm_bwd_kernel_matches_plain(shape, dtype, with_ds):
    _need_cuda()
    g = torch.Generator(device="cuda").manual_seed(sum(shape))
    x = (torch.randn(shape, generator=g, device="cuda") * 3).to(dtype)
    w = torch.randn(shape[-1], generator=g, device="cuda").to(dtype)
    dy = torch.randn(shape, generator=g, device="cuda").to(dtype)
    ds = torch.randn(shape, generator=g, device="cuda").to(dtype) \
        if with_ds else None
    before = rn.rmsnorm.bwd_launches
    dx, dw = rn._bwd(x, w, dy, 1e-5, ds, ("test",))
    torch.cuda.synchronize()
    assert rn.rmsnorm.bwd_launches == before + 1
    want_dx, want_dw = rn.rmsnorm_bwd_ref(x, w, dy, 1e-5, ds)
    tol = 2e-5 if dtype == torch.float32 else 1e-2
    _rel_close(dx, want_dx, tol)
    _rel_close(dw, want_dw, tol)


def _rms_bwd_inputs(shape, xt, wt, with_ds, seed, offset=0):
    """Seeded inputs of the norm backward; with ``offset`` each of x, dy
    and ds starts ``offset`` elements into its storage (contiguous rows
    behind an unaligned pointer)."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    n = 1
    for s_ in shape:
        n *= s_

    def rnd(dt, scale=1.0):
        t = torch.empty(n + offset, dtype=dt, device="cuda")
        t[offset:] = (torch.randn(n, generator=g, device="cuda")
                      * scale).to(dt)
        return t[offset:].view(shape)
    x, dy = rnd(xt, 3.0), rnd(xt)
    w = torch.randn(shape[-1], generator=g, device="cuda").to(wt)
    return x, w, dy, rnd(xt) if with_ds else None


def _rms_bwd_check(got, x, w, dy, ds):
    want = rn.rmsnorm_bwd_ref(x, w, dy, 1e-5, ds)
    for a, t in zip(got, want):
        assert a.dtype == t.dtype
        _rel_close(a, t, 2e-5 if a.dtype == torch.float32 else 1e-2)


@pytest.mark.parametrize("with_ds", [False, True], ids=["plain", "ds_in"])
@pytest.mark.parametrize("shape", [(1024, 7168), (70, 7168), (3, 7168)],
                         ids=str)
def test_rmsnorm_bwd_kernel_float32_x_bfloat16_w(shape, with_ds):
    """Mamba2's gated-norm type pair at its width: ``dx`` in float32
    (2e-5), ``dw`` in bfloat16 (1e-2)."""
    _need_cuda()
    x, w, dy, ds = _rms_bwd_inputs(shape, torch.float32, torch.bfloat16,
                                   with_ds, 7)
    got = rn._bwd(x, w, dy, 1e-5, ds, ("test",))
    torch.cuda.synchronize()
    assert got[1].dtype == torch.bfloat16
    _rms_bwd_check(got, x, w, dy, ds)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("shape", RMS_BWD_SHAPES, ids=str)
def test_rmsnorm_bwd_repeats_bit_for_bit(shape, dtype):
    """No atomics: ``dw`` is folded in block order, so two launches on the
    same inputs give the same bits."""
    _need_cuda()
    x, w, dy, ds = _rms_bwd_inputs(shape, dtype, dtype, True, 11)
    first = rn._bwd(x, w, dy, 1e-5, ds, ("test",))
    second = rn._bwd(x, w, dy, 1e-5, ds, ("test",))
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(first, second))


@pytest.mark.parametrize("with_ds", [False, True], ids=["plain", "ds_in"])
@pytest.mark.parametrize("shape", [(1024, 768), (512, 1920), (1024, 7168),
                                   (64, 12288), (3, 33)], ids=str)
def test_rmsnorm_bwd_graph_replay_gives_the_launch_bits(shape, with_ds):
    """The training phases time the kernel by CUDA-graph replay: a replay
    of the captured launch gives the bits of a plain launch."""
    _need_cuda()
    x, w, dy, ds = _rms_bwd_inputs(shape, torch.bfloat16, torch.bfloat16,
                                   with_ds, 13)
    eager = rn._bwd(x, w, dy, 1e-5, ds, ("test",))
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        captured = rn._bwd(x, w, dy, 1e-5, ds, ("test",))
    graph.replay()
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(eager, captured))


def test_rmsnorm_bwd_shapes_back_to_back():
    """Calls of different shapes, types and forms queued on the stream
    with no synchronisation between them (each its own grid, ring depth
    and workspace) are each right."""
    _need_cuda()
    cases = [((512, 1920), torch.bfloat16, torch.bfloat16, False),
             ((1024, 768), torch.float32, torch.float32, True),
             ((1024, 7168), torch.float32, torch.bfloat16, False),
             ((7, 33), torch.bfloat16, torch.bfloat16, True),
             ((64, 12288), torch.bfloat16, torch.bfloat16, True),
             ((1, 32), torch.float32, torch.float32, False),
             ((256, 3584), torch.bfloat16, torch.bfloat16, True)]
    inputs = [_rms_bwd_inputs(s, xt, wt, ds, i)
              for i, (s, xt, wt, ds) in enumerate(cases)]
    torch.cuda.synchronize()
    outs = [rn._bwd(x, w, dy, 1e-5, ds, ("test",))
            for x, w, dy, ds in inputs]
    torch.cuda.synchronize()
    for got, (x, w, dy, ds) in zip(outs, inputs):
        _rms_bwd_check(got, x, w, dy, ds)


@pytest.mark.parametrize("offset", [0, 1, 3], ids=lambda o: f"off{o}")
@pytest.mark.parametrize("shape", [(70, 1920), (9, 33), (130, 1026),
                                   (5, 8200)], ids=str)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_rmsnorm_bwd_unaligned_and_unpacked_rows(dtype, shape, offset):
    """Rows behind a pointer that is not 16-byte aligned, or of a width
    that does not split into 16-byte packs, take the kernel's element-wise
    instance; rows wider than 8192 its packed instance without the ring.
    Each is right, with and without ``ds_in``, and repeats its bits."""
    _need_cuda()
    for with_ds in (False, True):
        x, w, dy, ds = _rms_bwd_inputs(shape, dtype, dtype, with_ds,
                                       sum(shape) + offset, offset)
        got = rn._bwd(x, w, dy, 1e-5, ds, ("test",))
        again = rn._bwd(x, w, dy, 1e-5, ds, ("test",))
        torch.cuda.synchronize()
        _rms_bwd_check(got, x, w, dy, ds)
        assert all(torch.equal(a, b) for a, b in zip(got, again))


def _fa_views(case, dtype, seed):
    b, h, kv, sq, sk, d, _, _ = case
    g = torch.Generator(device="cuda").manual_seed(seed)

    def view(n, s):                   # (B, S, H, D) viewed as (B, H, S, D)
        return torch.randn((b, s, n, d), generator=g, device="cuda").to(
            dtype).transpose(1, 2)

    return view(h, sq), view(kv, sk), view(kv, sk), view(h, sq)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("case", FA_BWD_CASES, ids=str)
def test_flash_attention_bwd_kernel_matches_plain(case, dtype):
    """The forward's ``lse`` against the plain one, then the backward
    kernel against the plain backward on the same ``out`` and ``lse``."""
    _need_cuda()
    *_, causal, window = case
    q, k, v, do = _fa_views(case, dtype, sum(case[:6]))
    b, h, sq = q.shape[:3]
    lse = torch.empty((b, h, sq), dtype=torch.float32, device="cuda")
    out = fa._fwd_cuda(q, k, v, causal, window, lse)
    _, want_lse = fa.flash_attention_ref(q, k, v, causal=causal,
                                         window=window, return_lse=True)
    finite = torch.isfinite(want_lse)
    assert torch.equal(torch.isfinite(lse), finite)
    _rel_close(lse[finite], want_lse[finite], 1e-5)
    before = fa.flash_attention.bwd_launches
    got = fa._bwd_cuda(q, k, v, out, lse, do, causal, window)
    torch.cuda.synchronize()
    assert fa.flash_attention.bwd_launches == before + 1
    want = fa.flash_attention_bwd_ref(q, k, v, out, lse, do, causal=causal,
                                      window=window)
    tol = 1e-4 if dtype == torch.float32 else 1e-2
    for a, t in zip(got, want):
        assert a.dtype == dtype
        _rel_close(a, t, tol)
    if not bool(finite.all()):
        assert bool((got[0][~finite[..., None].expand_as(got[0])] == 0).all())


@pytest.mark.parametrize("case", FA_BWD_CASES, ids=str)
def test_flash_attention_bwd_bf16_repeats_bit_for_bit(case):
    """No atomics: two launches on the same inputs give the same bits."""
    _need_cuda()
    *_, causal, window = case
    q, k, v, do = _fa_views(case, torch.bfloat16, sum(case[:6]) + 1)
    b, h, sq = q.shape[:3]
    lse = torch.empty((b, h, sq), dtype=torch.float32, device="cuda")
    out = fa._fwd_cuda(q, k, v, causal, window, lse)
    first = fa._bwd_cuda(q, k, v, out, lse, do, causal, window)
    second = fa._bwd_cuda(q, k, v, out, lse, do, causal, window)
    torch.cuda.synchronize()
    for a, c in zip(first, second):
        assert torch.equal(a, c)


#: (b, h, kv, sq, sk, d, window, q_offset): a share of a sequence's rows
#: (query i at position q_offset + i), one head dim per instance family
#: (64: Q in registers; 136: the zero-padded 144-wide tile; 256: Q in
#: shared memory, key tiles of 32), offsets no multiple of a tile, keys
#: past the last row's position, a window across the offset, GQA
FA_OFFSET_CASES = [(2, 4, 2, 70, 200, 64, 0, 100),
                   (1, 4, 4, 64, 256, 136, 0, 192),
                   (1, 2, 1, 50, 200, 256, 40, 150)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("case", FA_OFFSET_CASES, ids=str)
def test_flash_attention_q_offset_matches_plain(case, dtype):
    """The forward with a query offset against the plain version (the
    kernel tolerance), its ``lse``, and the backward against the plain
    backward; each launch counted under a shape key that ends in the
    offset."""
    _need_cuda()
    b, h, kv, sq, sk, d, window, off = case
    q, k, v, do = _fa_views((b, h, kv, sq, sk, d, True, window), dtype,
                            sum(case))
    fwd_tol, bwd_tol = (2e-5, 1e-4) if dtype == torch.float32 else \
        (2e-2, 1e-2)
    got = fa.flash_attention(q, k, v, window=window, q_offset=off)
    want, want_lse = fa.flash_attention_ref(q, k, v, window=window,
                                            q_offset=off, return_lse=True)
    _rel_close(got, want, fwd_tol)
    lse = torch.empty((b, h, sq), dtype=torch.float32, device="cuda")
    out = fa._fwd_cuda(q, k, v, True, window, lse, off)
    finite = torch.isfinite(want_lse)
    assert torch.equal(torch.isfinite(lse), finite)
    _rel_close(lse[finite], want_lse[finite], 1e-5)
    dq, dk, dv = fa._bwd_cuda(q, k, v, out, lse, do, True, window, off)
    torch.cuda.synchronize()
    ref = fa.flash_attention_bwd_ref(q, k, v, out, lse, do, window=window,
                                     q_offset=off)
    for a, t in zip((dq, dk, dv), ref):
        _rel_close(a, t, bwd_tol)
    key = ((b, h, sq, d), (b, kv, sk, d), True, window, str(dtype), off)
    assert fa.flash_attention.shapes[key] >= 2
    assert fa.flash_attention.shapes[("bwd",) + key] >= 1


def test_flash_attention_q_offset_zero_is_the_old_launch():
    """``q_offset=0`` launches what a call without it launches: the same
    bits forward and backward, in both types, under the shape key without
    an offset."""
    _need_cuda()
    case = (2, 4, 2, 96, 96, 128, True, 0)
    for dtype in (torch.float32, torch.bfloat16):
        q, k, v, do = _fa_views(case, dtype, 11)
        lse0 = torch.empty((2, 4, 96), dtype=torch.float32, device="cuda")
        lse1 = torch.empty_like(lse0)
        out0 = fa._fwd_cuda(q, k, v, True, 0, lse0)
        before = dict(fa.flash_attention.shapes)
        out1 = fa._fwd_cuda(q, k, v, True, 0, lse1, 0)
        assert torch.equal(out0, out1) and torch.equal(lse0, lse1)
        assert torch.equal(fa.flash_attention(q, k, v),
                           fa.flash_attention(q, k, v, q_offset=0))
        g0 = fa._bwd_cuda(q, k, v, out0, lse0, do, True, 0)
        g1 = fa._bwd_cuda(q, k, v, out0, lse0, do, True, 0, 0)
        torch.cuda.synchronize()
        assert all(torch.equal(a, c) for a, c in zip(g0, g1))
        key = ((2, 4, 96, 128), (2, 2, 96, 128), True, 0, str(dtype))
        assert fa.flash_attention.shapes[key] == before[key] + 3


def test_flash_attention_bwd_bf16_alignment():
    """The bfloat16 backward refuses a misaligned q, k or v, and copies a
    misaligned dout (the same gradient as from an aligned one)."""
    _need_cuda()
    case = (1, 4, 2, 40, 40, 64, True, 0)
    q, k, v, do = _fa_views(case, torch.bfloat16, 3)
    lse = torch.empty((1, 4, 40), dtype=torch.float32, device="cuda")
    out = fa._fwd_cuda(q, k, v, True, 0, lse)
    before = fa.flash_attention.bwd_launches
    base = torch.zeros(1, 4, 40, 72, dtype=torch.bfloat16, device="cuda")
    with pytest.raises(ValueError, match="pointer"):
        fa._bwd_cuda(base[..., 1:65], k, v, out, lse, do, True, 0)
    assert fa.flash_attention.bwd_launches == before
    odd = base[..., 1:65]
    odd.copy_(do)
    got = fa._bwd_cuda(q, k, v, out, lse, odd, True, 0)
    want = fa._bwd_cuda(q, k, v, out, lse, do.contiguous(), True, 0)
    torch.cuda.synchronize()
    for a, c in zip(got, want):
        assert torch.equal(a, c)


#: Cases at the head dims of gpt-1.1b (96), kimi-k2 and zamba2 (112) and
#: gpt-11.1b (136, the 144-wide instance with its padded chunk): GQA and
#: MHA, ragged Sq and Sk (shorter and longer than each other), causal, a
#: window, and a mask with no causal bound.
FA_NEW_DIM_CASES = [(2, 4, 2, 130, 130, 96, True, 0),
                    (1, 4, 4, 77, 200, 96, False, 0),
                    (1, 8, 1, 100, 100, 112, True, 30),
                    (2, 2, 2, 64, 50, 112, True, 0),
                    (1, 4, 2, 150, 150, 136, True, 0),
                    (1, 2, 2, 33, 90, 136, False, 20),
                    (1, 8, 2, 257, 257, 136, True, 64)]


@pytest.mark.parametrize("layout", ["bhsd", "bshd"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("case", FA_NEW_DIM_CASES, ids=str)
def test_flash_attention_new_head_dims_match_plain(case, dtype, layout):
    """The forward instances at 96, 112 and 136 against the plain version,
    at the tolerances of the other head dims."""
    test_flash_attention_kernel_matches_plain(case, dtype, layout)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("case", FA_NEW_DIM_CASES, ids=str)
def test_flash_attention_bwd_new_head_dims_match_plain(case, dtype):
    """The backward instances at 96, 112 and 136 (lse, then dq, dk, dv)
    against the plain backward."""
    test_flash_attention_bwd_kernel_matches_plain(case, dtype)


@pytest.mark.parametrize("case", FA_NEW_DIM_CASES, ids=str)
def test_flash_attention_bwd_new_head_dims_repeat_bit_for_bit(case):
    test_flash_attention_bwd_bf16_repeats_bit_for_bit(case)


def test_flash_attention_136_leaves_neighbouring_columns_alone():
    """The 144-wide instance writes 136 columns a row: the output and the
    gradients are views into wider buffers whose other columns must keep
    their sentinel."""
    _need_cuda()
    g = torch.Generator(device="cuda").manual_seed(5)

    def wide(n, s):
        t = torch.full((1, s, n, 152), 7.0, device="cuda",
                       dtype=torch.bfloat16)
        t[..., :136] = torch.randn((1, s, n, 136), generator=g,
                                   device="cuda").bfloat16()
        return t

    qw, kw, vw = wide(4, 70), wide(2, 70), wide(2, 70)
    q, k, v = (t[..., :136].transpose(1, 2) for t in (qw, kw, vw))
    lse = torch.empty((1, 4, 70), dtype=torch.float32, device="cuda")
    out = fa._fwd_cuda(q, k, v, True, 0, lse)
    _close(out, fa.flash_attention_ref(q, k, v), 2e-2)
    ow = torch.full((1, 4, 70, 152), 7.0, device="cuda",
                    dtype=torch.bfloat16)
    fa.launch("flash_attention_fwd", q.get_device(), q.data_ptr(),
              k.data_ptr(), v.data_ptr(), ow.data_ptr(), None,
              *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
              *ow.stride()[:3], 1, 4, 2, 70, 70, 136, 1.0 / 136 ** 0.5, 1,
              0, 0, 1)
    torch.cuda.synchronize()
    assert bool((ow[..., 136:] == 7.0).all())
    assert torch.equal(ow[..., :136], out)


#: The float32 training paths' shapes (b, h, kv, sq, sk, d, causal,
#: window): gpt-demo's ``train_gpt --full`` (MHA) and granite's tensor-
#: parallel slice (a group of 3 query heads, so the backward folds).
FA_F32_PATH_CASES = [(4, 12, 12, 256, 256, 64, True, 0),
                     (2, 12, 4, 512, 512, 64, True, 0)]


@pytest.mark.parametrize("case", FA_F32_PATH_CASES, ids=str)
def test_flash_attention_f32_at_the_path_shapes(case):
    """The float32 forward (model views, 2e-5) and backward (lse, then dq,
    dk, dv within 1e-4 of each gradient's largest magnitude) at the shapes
    the training paths hand them, each one launch."""
    _need_cuda()
    test_flash_attention_kernel_matches_plain(case, torch.float32, "bshd")
    test_flash_attention_bwd_kernel_matches_plain(case, torch.float32)


def _f32_backward_twice(case, seed):
    *_, causal, window = case
    q, k, v, do = _fa_views(case, torch.float32, seed)
    b, h, sq = q.shape[:3]
    lse = torch.empty((b, h, sq), dtype=torch.float32, device="cuda")
    out = fa._fwd_cuda(q, k, v, causal, window, lse)
    first = fa._bwd_cuda(q, k, v, out, lse, do, causal, window)
    second = fa._bwd_cuda(q, k, v, out, lse, do, causal, window)
    torch.cuda.synchronize()
    return (q, k, v, out, lse, do), first, second


@pytest.mark.parametrize("case", FA_BWD_CASES + FA_F32_PATH_CASES, ids=str)
def test_flash_attention_bwd_f32_repeats_bit_for_bit(case):
    """No atomics in float32 either: the dK/dV partials of a group's heads
    are folded in head order, so two launches give the same bits, and so
    does a CUDA-graph replay of a third."""
    _need_cuda()
    *_, causal, window = case
    (q, k, v, out, lse, do), first, second = _f32_backward_twice(
        case, sum(case[:6]) + 2)
    for a, c in zip(first, second):
        assert torch.equal(a, c)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        captured = fa._bwd_cuda(q, k, v, out, lse, do, causal, window)
    graph.replay()
    torch.cuda.synchronize()
    for a, c in zip(first, captured):
        assert torch.equal(a, c)


def _shifted(t: torch.Tensor) -> torch.Tensor:
    """``t``'s values in a view one float into its storage: every row 4
    bytes past a 16-byte boundary."""
    flat = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    view = flat[1:].view(t.shape)
    view.copy_(t)
    assert view.data_ptr() % 16 == 4
    return view


@pytest.mark.parametrize("case", [(2, 4, 2, 70, 90, 64, True, 0),
                                  (1, 4, 4, 33, 33, 136, False, 20),
                                  (1, 2, 1, 40, 40, 256, True, 0)], ids=str)
def test_flash_attention_f32_takes_rows_off_16_bytes(case):
    """A float32 view one float into its storage (no row 16-byte aligned)
    launches the same kernels with 4-byte copies: the forward (2e-5) and
    the backward (1e-4) against the plain versions, and the same bits as
    from aligned copies of the inputs."""
    _need_cuda()
    *_, causal, window = case
    q, k, v, do = (t.contiguous() for t in _fa_views(case, torch.float32, 9))
    qo, ko, vo, doo = (_shifted(t) for t in (q, k, v, do))
    before = fa.flash_attention.launches, fa.flash_attention.bwd_launches
    got = fa.flash_attention(qo, ko, vo, causal=causal, window=window)
    torch.cuda.synchronize()
    assert fa.flash_attention.launches == before[0] + 1
    _close(got, fa.flash_attention_ref(q, k, v, causal=causal,
                                       window=window), 2e-5)
    assert torch.equal(got, fa.flash_attention(q, k, v, causal=causal,
                                               window=window))
    b, h, sq = q.shape[:3]
    lse = torch.empty((b, h, sq), dtype=torch.float32, device="cuda")
    out = fa._fwd_cuda(q, k, v, causal, window, lse)
    outo = _shifted(out)
    grads = fa._bwd_cuda(qo, ko, vo, outo, lse, doo, causal, window)
    aligned = fa._bwd_cuda(q, k, v, out, lse, do, causal, window)
    torch.cuda.synchronize()
    assert fa.flash_attention.bwd_launches == before[1] + 2
    want = fa.flash_attention_bwd_ref(q, k, v, out, lse, do, causal=causal,
                                      window=window)
    for g, a, w in zip(grads, aligned, want):
        _rel_close(g, w, 1e-4)
        assert torch.equal(g, a)


def test_flash_attention_f32_instances_fill_the_card():
    """Every float32 pass fits at least one block an SM at every head dim,
    and two at head dims up to 128 (the tiles are sized for it: the
    training grids are about one wave of the card's SMs)."""
    _need_cuda()
    for d in fa.HEAD_DIMS:
        occ = fa.occupancy(d)
        for name in ("fwd_f32", "bwd_f32"):
            smem, blocks = occ[name]
            assert smem > 0 and blocks >= (2 if d <= 128 else 1), \
                (d, name, occ[name])


@pytest.mark.parametrize("gather,f32", [(False, True), (True, False)],
                         ids=["scatter-f32", "gather-einsum"])
def test_moe_backward_repeats_bit_for_bit_on_the_card(gather, f32):
    """The MoE layer's backward on the card, with drops (capacity factor
    0.5, the dropped assignments all pointing at slot (0, 0)): two
    backward passes give the same bits in every gradient, so a resumed
    training run repeats the uninterrupted one."""
    _need_cuda()
    from repro_torch.models import moe
    g = torch.Generator(device="cuda").manual_seed(3)
    t, d, f, e, k = 512, 256, 128, 16, 4
    x = torch.randn(t, d, generator=g, device="cuda").bfloat16()
    router = torch.randn(d, e, generator=g, device="cuda")
    ws = [(torch.randn(s, generator=g, device="cuda") * 0.05).bfloat16()
          for s in ((e, d, f), (e, d, f), (e, f, d))]
    cot = torch.randn(t, d, generator=g, device="cuda").bfloat16()

    def grads():
        ins = [a.detach().requires_grad_() for a in (x, router, *ws)]
        y = moe.moe_apply_local(*ins, k=k, n_experts=e, expert_offset=0,
                                capacity_factor=0.5, f32_combine=f32,
                                gather_dispatch=gather)
        y.backward(cot)
        return [a.grad for a in ins]

    first, second = grads(), grads()
    torch.cuda.synchronize()
    for a, b in zip(first, second):
        assert bool(torch.isfinite(a.float()).all()) and torch.equal(a, b)


#: Reduced configs of the families this package gained, at the head dims
#: that need the new instances where the config has them.
NEW_FAMILIES = [("granite-moe-3b-a800m", {}),
                ("kimi-k2-1t-a32b", {"head_dim": 112}),
                ("llava-next-mistral-7b", {}), ("musicgen-large", {}),
                ("gpt-1.1b", {"head_dim": 136})]


@pytest.mark.parametrize("arch,overrides", NEW_FAMILIES,
                         ids=[a for a, _ in NEW_FAMILIES])
def test_new_families_prefill_and_decode_on_the_card(arch, overrides):
    """Reduced, float32 (no router near-tie can flip between two sums in
    another order): a prefill launches the attention kernel once a layer,
    and a decode step after it reproduces ``forward_logits`` at the next
    position (the reference's consistency check, 2e-3); a vlm prompt
    carries its image embeddings ahead of the text.  Then bfloat16: the
    same launches, finite logits."""
    _need_cuda()
    from repro_torch.models.frontends import vlm_patch_embeddings
    for dtype in ("float32", "bfloat16"):
        cfg = configs.get(arch).reduced(dtype=dtype, **overrides)
        params = init_params(cfg, seed=0, device="cuda")
        g = torch.Generator(device="cuda").manual_seed(4)
        toks = torch.randint(0, cfg.vocab_size, (2, 17), generator=g,
                             device="cuda")
        img = vlm_patch_embeddings(g, 2, cfg.n_img_tokens, cfg.d_model,
                                   getattr(torch, dtype)) \
            if cfg.frontend == "vlm" else None
        ctx = ShardCtx()
        before = fa.flash_attention.launches
        last, cache = M.prefill(params, cfg, ctx, toks[:, :16], img)
        torch.cuda.synchronize()
        assert fa.flash_attention.launches == before + cfg.n_layers
        assert bool(torch.isfinite(last.float()).all())
        if dtype == "bfloat16":
            continue
        pos = 16 + (cfg.n_img_tokens if img is not None else 0)
        logits, _ = M.decode_step(params, cfg, ctx, toks[:, 16:],
                                  gen_cli.grow_cache(cache, 1), pos)
        full = M.forward_logits(params, cfg, ctx, toks, img)
        _close(logits, full[:, pos], 2e-3)


def test_functions_are_used_on_the_card_under_grad():
    """A CUDA wrapper handed an input that requires a gradient goes
    through its Function: a forward launch, then a backward launch."""
    _need_cuda()
    x = torch.randn(4, 64, device="cuda", requires_grad=True)
    w = torch.ones(64, device="cuda", requires_grad=True)
    counts = (rn.rmsnorm.launches, rn.rmsnorm.bwd_launches,
              fa.flash_attention.launches, fa.flash_attention.bwd_launches)
    y = rn.rmsnorm(x, w)
    s, y2 = rn.add_rmsnorm(x, x, w)
    q = torch.randn(1, 2, 16, 32, device="cuda", requires_grad=True)
    o = fa.flash_attention(q, q, q)
    assert all(t.grad_fn is not None for t in (y, s, y2, o))
    (y.sum() + s.sum() + y2.sum() + o.sum()).backward()
    assert (rn.rmsnorm.launches - counts[0], rn.rmsnorm.bwd_launches
            - counts[1], fa.flash_attention.launches - counts[2],
            fa.flash_attention.bwd_launches - counts[3]) == (2, 2, 1, 1)
    assert all(bool(torch.isfinite(t.grad).all()) for t in (x, w, q))
    with torch.no_grad():
        assert rn.rmsnorm(x, w).grad_fn is None


#: (b, S, D, N, rank) of the fused scan's backward: S not a multiple of the
#: kernel's chunk (16), D not a multiple of its 32 channels a block, N at
#: 1, 5, 7 and 16 (B, C at odd columns of the projection), and the
#: training microbatch of falcon-mamba-7b (the last).
SCAN_BWD_SHAPES = [(2, 37, 24, 5, 3), (1, 20, 40, 16, 2), (2, 33, 45, 1, 3),
                   (1, 17, 100, 16, 4), (2, 64, 32, 8, 2), (3, 5, 9, 7, 1),
                   (2, 512, 8192, 16, 256)]
#: Kernel against plain backward, relative to each gradient's largest
#: magnitude: float32 sums in another order and ``ex2.approx`` in both
#: recomputes; in bfloat16 an output may round to the neighbouring value.
SCAN_BWD_TOL = {torch.float32: 1e-4, torch.bfloat16: 1e-2}


def _scan_bwd_call(shape, dtype, with_h0, with_dhf):
    """Inputs of one backward call, with the chunk boundaries that the
    forward kernel kept for them (as ``SelectiveScanFusedFn`` does)."""
    args, h0 = _fused_inputs(shape, dtype, sum(shape))
    rng = np.random.default_rng(sum(shape) + 1)
    b, s, d, n, _ = shape
    dout = _randn(rng, (b, s, d), dtype)
    dhf = _randn(rng, (b, d, n), torch.float32) if with_dhf else None
    args = (*args, h0 if with_h0 else None)
    bounds = ss._bounds_for(args[0], n)
    ss._fused_fwd_cuda(*args, None, False, bounds)
    return args, dout, dhf, bounds


@pytest.mark.parametrize("start", ["zero", "h0+dh", "dh"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("shape", SCAN_BWD_SHAPES, ids=str)
def test_selective_scan_fused_bwd_kernel_matches_plain(shape, dtype, start):
    """The nine gradients of the backward kernel, fed by the forward
    kernel's chunk boundaries, against the plain backward, on the model's
    views; one backward call a call."""
    _need_cuda()
    args, dout, dhf, bounds = _scan_bwd_call(shape, dtype, "h0" in start,
                                             "dh" in start)
    before = ss.selective_scan.bwd_launches
    got = ss._bwd_cuda(*args, dout, dhf, bounds)
    torch.cuda.synchronize()
    assert ss.selective_scan.bwd_launches == before + 1
    want = ss.selective_scan_fused_bwd_ref(*args, dout, dhf)
    for name, g, w in zip(("x", "dt", "dt_bias", "B", "C", "A_log", "D",
                           "z", "h0"), got, want):
        if w is None:
            assert g is None
            continue
        assert g.shape == w.shape and g.dtype == w.dtype, name
        assert bool(torch.isfinite(g).all()), name
        err = float((g.float() - w.float()).abs().max())
        assert err <= SCAN_BWD_TOL[dtype] * max(
            float(w.float().abs().max()), 1e-30), (name, err)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("shape", SCAN_BWD_SHAPES[:3] + SCAN_BWD_SHAPES[-1:],
                         ids=str)
def test_selective_scan_fused_bwd_repeats_bit_for_bit(shape, dtype):
    """No atomics: two launches on the same inputs give the same bits."""
    _need_cuda()
    args, dout, dhf, bounds = _scan_bwd_call(shape, dtype, True, True)
    first = ss._bwd_cuda(*args, dout, dhf, bounds)
    again = ss._bwd_cuda(*args, dout, dhf, bounds)
    torch.cuda.synchronize()
    for a, c in zip(first, again):
        assert torch.equal(a, c)


@pytest.mark.parametrize("with_h0", [False, True], ids=["zero", "h0"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("shape", SCAN_BWD_SHAPES, ids=str)
def test_forward_kernel_keeps_the_chunk_boundaries(shape, dtype, with_h0):
    """The fused forward's instance that keeps the chunk boundaries: each
    within 1e-5 of ``1 + |h|`` of the plain walk's (``ex2.approx`` is not
    ``torch.exp``), and its ``out`` and final state bit-equal to the
    generation instance's on the same inputs."""
    _need_cuda()
    args, h0 = _fused_inputs(shape, dtype, sum(shape))
    args = (*args, h0 if with_h0 else None)
    n = shape[3]
    bounds = ss._bounds_for(args[0], n)
    out, h = ss._fused_fwd_cuda(*args, None, False, bounds)
    out_g, h_g = ss._fused_fwd_cuda(*args, None, False)
    torch.cuda.synchronize()
    assert torch.equal(out, out_g) and torch.equal(h, h_g)
    want = ss.selective_scan_fused_ref(*args, bounds=True)[2]
    assert bounds.shape == want.shape == (shape[0], -(-shape[1] // 16),
                                          shape[2], n)
    assert bool(((bounds - want).abs() <= 1e-5 * (1 + want.abs())).all())


def test_scan_backward_holds_four_blocks_an_sm():
    """The backward's main kernel is built for 16 resident warps an SM (4
    blocks of 128 threads: 128 registers, 53 KB of dynamic shared memory
    in bfloat16), so the training shape's 512 blocks run in one wave."""
    _need_cuda()
    smem, blocks = ss.bwd_occupancy(torch.bfloat16)
    assert blocks >= 4 and smem <= 56 * 1024, (smem, blocks)


def test_scan_function_is_used_on_the_card_under_grad():
    """The fused wrapper hands a sequence that requires a gradient to
    ``SelectiveScanFusedFn`` (a forward launch, then a backward call); the
    step form, ``h_out`` and the plain form refuse, naming the ROADMAP."""
    _need_cuda()
    (x, dt, bias, B, C, A_log, D, z), h0 = _fused_inputs((2, 19, 45, 7, 3),
                                                         torch.float32, 3)
    leaves = [t.detach().requires_grad_() for t in (x, dt, bias, A_log, D, z)]
    xl, dtl, bl, al, dl, zl = leaves
    counts = (ss.selective_scan.launches, ss.selective_scan.bwd_launches)
    out, h = ss.selective_scan_fused(xl, dtl, bl, B, C, al, dl, zl)
    assert out.grad_fn is not None
    out.float().square().sum().backward()
    assert (ss.selective_scan.launches - counts[0],
            ss.selective_scan.bwd_launches - counts[1]) == (1, 1)
    assert all(bool(torch.isfinite(t.grad).all()) for t in leaves)
    with pytest.raises(NotImplementedError, match="Queue A 10c"):
        ss.selective_scan_fused(xl[:, :1], dtl[:, :1], bl, B[:, :1],
                                C[:, :1], al, dl, zl[:, :1], h0, step=True)
    with pytest.raises(NotImplementedError, match="Queue A 10c"):
        ss.selective_scan_fused(xl, dtl, bl, B, C, al, dl, zl, h0,
                                torch.empty_like(h0))
    A = -torch.exp(A_log)
    with pytest.raises(NotImplementedError, match="Queue A 10c"):
        ss.selective_scan(xl, dtl.detach(), B.contiguous(), C.contiguous(), A)
    with torch.no_grad():
        assert ss.selective_scan_fused(xl, dtl, bl, B, C, al, dl,
                                       zl)[0].grad_fn is None


@pytest.mark.parametrize("remat", [False, True])
def test_backward_reaches_every_parameter_of_a_mamba1_layer(remat):
    """``loss.backward()`` on a one-layer falcon-mamba-7b on the card:
    every parameter gets a finite gradient, through the scan's backward
    kernel (one call) and the norms' (the layer's and the final norm)."""
    _need_cuda()
    from repro_torch.launch import steps
    cfg = configs.get("falcon-mamba-7b").reduced(n_layers=1,
                                                 dtype="bfloat16",
                                                 remat=remat)
    params = init_params(cfg, seed=0, device="cuda")
    p, flat = steps._leaves_for_grad(params)
    g = torch.Generator(device="cuda").manual_seed(0)
    toks = torch.randint(0, cfg.vocab_size, (2, 37), generator=g,
                         device="cuda")
    before = (ss.selective_scan.launches, ss.selective_scan.bwd_launches,
              rn.rmsnorm.bwd_launches)
    loss, _ = M.loss_fn(p, cfg, ShardCtx(), {"tokens": toks,
                                             "labels": toks.roll(-1, 1)})
    loss.backward()
    assert (ss.selective_scan.launches - before[0],
            ss.selective_scan.bwd_launches - before[1],
            rn.rmsnorm.bwd_launches - before[2]) == (2 if remat else 1, 1, 2)
    for t in flat:
        assert t.grad is not None and bool(torch.isfinite(t.grad).all())
        assert float(t.grad.float().abs().max()) > 0


def test_mamba1_train_step_launch_counts():
    """One bfloat16 train step of a two-layer falcon-mamba-7b in two
    microbatches under remat: per microbatch the fused scan runs forward
    twice a layer and backward once; the norms run 3 plain and 2 (L - 1)
    residual forwards, 2 plain and L - 1 residual backwards; and a second
    run repeats the step bit for bit."""
    _need_cuda()
    from repro_torch._tree import leaves
    from repro_torch.data.pipeline import (DataLoader, LoaderConfig,
                                           SyntheticCorpus)
    from repro_torch.launch.steps import make_train_step
    from repro_torch.optim.adamw import AdamW
    cfg = configs.get("falcon-mamba-7b").reduced(n_layers=2,
                                                 dtype="bfloat16", remat=True)
    batch = DataLoader(SyntheticCorpus(cfg.vocab_size, 0),
                       LoaderConfig(4, 40)).batch_at(0)
    opt = AdamW(lr=1e-3)
    outs = []
    for _ in range(2):
        params = init_params(cfg, seed=0, device="cuda")
        step = make_train_step(cfg, ShardCtx(), opt, n_micro=2)
        ss.selective_scan.shapes.clear()
        rn.rmsnorm.shapes.clear()
        outs.append(step(params, opt.init(params), batch))
        torch.cuda.synchronize()
        L, micro = cfg.n_layers, 2
        fwd = sum(v for k, v in ss.selective_scan.shapes.items()
                  if k[0] == "fused_bound")
        bwd = sum(v for k, v in ss.selective_scan.shapes.items()
                  if k[0] == "fused_bwd")
        assert (fwd, bwd) == (micro * 2 * L, micro * L)
        norms = {}
        for k, v in rn.rmsnorm.shapes.items():
            kind = k[0] if isinstance(k[0], str) else "plain"
            norms[kind] = norms.get(kind, 0) + v
        assert norms == {"plain": micro * 3, "add": micro * 2 * (L - 1),
                         "bwd": micro * 2, "add_bwd": micro * (L - 1)}
    assert bool(np.isfinite(float(outs[0][2]["loss"])))
    assert float(outs[0][2]["loss"]) == float(outs[1][2]["loss"])
    for a, b in zip(leaves(outs[0][:2]), leaves(outs[1][:2])):
        assert torch.equal(a, b)


@pytest.mark.parametrize("remat", [False, True])
def test_backward_reaches_every_parameter_of_a_dense_layer(remat):
    """``loss.backward()`` on a one-layer dense model on the card: every
    parameter gets a finite gradient, through the backward kernels."""
    _need_cuda()
    from repro_torch.launch import steps
    cfg = configs.get("qwen2-7b").reduced(n_layers=1, dtype="bfloat16",
                                          remat=remat)
    params = init_params(cfg, seed=0, device="cuda")
    p, flat = steps._leaves_for_grad(params)
    g = torch.Generator(device="cuda").manual_seed(0)
    toks = torch.randint(0, cfg.vocab_size, (2, 32), generator=g,
                         device="cuda")
    before = (rn.rmsnorm.bwd_launches, fa.flash_attention.bwd_launches)
    loss, _ = M.loss_fn(p, cfg, ShardCtx(), {"tokens": toks,
                                             "labels": toks.roll(-1, 1)})
    loss.backward()
    assert (rn.rmsnorm.bwd_launches - before[0],
            fa.flash_attention.bwd_launches - before[1]) == (3, 1)
    for t in flat:
        assert t.grad is not None and bool(torch.isfinite(t.grad).all())
        assert float(t.grad.float().abs().max()) > 0


def test_train_step_on_the_card_matches_the_host():
    """One float32 step of reduced qwen2-7b: loss and new parameters on the
    card against the host's plain path (sums in another order)."""
    _need_cuda()
    from repro_torch._tree import leaves
    from repro_torch.data.pipeline import (DataLoader, LoaderConfig,
                                           SyntheticCorpus)
    from repro_torch.launch.steps import make_train_step
    from repro_torch.optim.adamw import AdamW
    cfg = configs.get("qwen2-7b").reduced(n_layers=2, remat=True)
    batch = DataLoader(SyntheticCorpus(cfg.vocab_size, 0),
                       LoaderConfig(4, 32)).batch_at(0)
    opt = AdamW(lr=1e-5)
    out = {}
    for dev in ("cuda", "cpu"):
        params = init_params(cfg, seed=0, device="cuda")
        params = {k: ({kk: vv.to(dev) for kk, vv in v.items()}
                      if isinstance(v, dict) else v.to(dev))
                  for k, v in params.items()}
        step = make_train_step(cfg, ShardCtx(), opt, n_micro=2)
        out[dev] = step(params, opt.init(params), batch)
    assert abs(float(out["cuda"][2]["loss"]) - float(out["cpu"][2]["loss"])) \
        <= 1e-4
    for a, b in zip(leaves(out["cuda"][0]), leaves(out["cpu"][0])):
        torch.testing.assert_close(a.cpu(), b, rtol=1e-4, atol=3e-5)


def test_train_step_on_the_card_repeats_bit_for_bit():
    _need_cuda()
    from repro_torch._tree import leaves
    from repro_torch.data.pipeline import (DataLoader, LoaderConfig,
                                           SyntheticCorpus)
    from repro_torch.launch.steps import make_train_step
    from repro_torch.optim.adamw import AdamW
    cfg = configs.get("qwen2-7b").reduced(n_layers=2, dtype="bfloat16",
                                          remat=True)
    batch = DataLoader(SyntheticCorpus(cfg.vocab_size, 0),
                       LoaderConfig(4, 64)).batch_at(0)
    opt = AdamW(lr=1e-3)
    outs = []
    for _ in range(2):
        params = init_params(cfg, seed=0, device="cuda")
        step = make_train_step(cfg, ShardCtx(), opt, n_micro=2)
        outs.append(step(params, opt.init(params), batch))
    assert float(outs[0][2]["loss"]) == float(outs[1][2]["loss"])
    for a, b in zip(leaves(outs[0][:2]), leaves(outs[1][:2])):
        assert torch.equal(a, b)


#: Mamba2's gated norm at zamba2-7b's d_inner: (rows, 7168), float32 x with
#: a bfloat16 weight (type code 2): the prefill's (4, 512), the training
#: microbatch's (2, 512), a decode step's (4,), and a ragged count.
GATED_NORM_SHAPES = [(4, 512, 7168), (2, 512, 7168), (4, 7168), (7, 7168)]


@pytest.mark.parametrize("shape", GATED_NORM_SHAPES, ids=str)
def test_rmsnorm_float32_x_bfloat16_w_at_zamba2_width(shape):
    """The forward kernel against its plain version (float32 output, 1e-5
    of the largest magnitude), then ``RMSNormFn``'s backward kernel: ``dx``
    in float32 (2e-5), ``dw`` in bfloat16 (1e-2: one bfloat16 step)."""
    _need_cuda()
    g = torch.Generator(device="cuda").manual_seed(sum(shape))
    x = torch.randn(shape, generator=g, device="cuda") * 3
    w = torch.randn(shape[-1], generator=g, device="cuda").bfloat16()
    key = (torch.Size(shape), torch.float32, torch.bfloat16)
    before = rn.rmsnorm.shapes[key]
    y = rn.rmsnorm(x, w, 1e-5)
    torch.cuda.synchronize()
    assert rn.rmsnorm.shapes[key] == before + 1
    assert y.dtype == torch.float32
    _rel_close(y, rn.rmsnorm_ref(x, w, 1e-5), 1e-5)
    xg = x.clone().requires_grad_()
    wg = w.clone().requires_grad_()
    dy = torch.randn(shape, generator=g, device="cuda")
    before = rn.rmsnorm.bwd_launches
    dx, dw = torch.autograd.grad(rn.rmsnorm(xg, wg, 1e-5), (xg, wg), dy)
    torch.cuda.synchronize()
    assert rn.rmsnorm.bwd_launches == before + 1
    assert dx.dtype == torch.float32 and dw.dtype == torch.bfloat16
    want_dx, want_dw = rn.rmsnorm_bwd_ref(x, w, dy, 1e-5)
    _rel_close(dx, want_dx, 2e-5)
    _rel_close(dw, want_dw, 1e-2)


def _zamba2(dtype, **kw):
    return configs.get("zamba2-7b").reduced(dtype=dtype, **kw)


def test_zamba2_prefill_and_decode_on_the_card():
    """Reduced zamba2-7b (six Mamba2 layers, the shared block after layers
    2 and 5), float32: a prefill launches the attention kernel once per
    shared-block application and one gated norm a layer at the float32 /
    float32 pair, and a decode step after it reproduces
    ``forward_logits`` at the next position (2e-3).  Then bfloat16: the
    same launches, the gated norms at the float32 / bfloat16 pair, finite
    logits."""
    _need_cuda()
    for dtype in ("float32", "bfloat16"):
        cfg = _zamba2(dtype)
        params = init_params(cfg, seed=0, device="cuda")
        g = torch.Generator(device="cuda").manual_seed(4)
        toks = torch.randint(0, cfg.vocab_size, (2, 17), generator=g,
                             device="cuda")
        ctx = ShardCtx()
        before = fa.flash_attention.launches
        gated = (torch.Size((2, 16, cfg.d_inner)), torch.float32,
                 getattr(torch, dtype))
        before_gated = rn.rmsnorm.shapes[gated]
        last, cache = M.prefill(params, cfg, ctx, toks[:, :16])
        torch.cuda.synchronize()
        assert fa.flash_attention.launches == before + 2
        assert rn.rmsnorm.shapes[gated] == before_gated + cfg.n_layers
        assert bool(torch.isfinite(last.float()).all())
        if dtype == "bfloat16":
            continue
        logits, _ = M.decode_step(params, cfg, ctx, toks[:, 16:],
                                  gen_cli.grow_cache(cache, 1), 16)
        full = M.forward_logits(params, cfg, ctx, toks)
        _close(logits, full[:, 16], 2e-3)


def _zamba2_step(dev, dtype, lr):
    from repro_torch._tree import tree_map
    from repro_torch.data.pipeline import (DataLoader, LoaderConfig,
                                           SyntheticCorpus)
    from repro_torch.launch.steps import make_train_step
    from repro_torch.optim.adamw import AdamW
    cfg = _zamba2(dtype, n_layers=2, hybrid_attn_period=1, remat=True)
    batch = DataLoader(SyntheticCorpus(cfg.vocab_size, 0),
                       LoaderConfig(4, 32)).batch_at(0)
    opt = AdamW(lr=lr)
    params = tree_map(lambda t: t.to(dev),
                      init_params(cfg, seed=0, device="cuda"))
    step = make_train_step(cfg, ShardCtx(), opt, n_micro=2)
    return step(params, opt.init(params), batch)


def test_zamba2_train_step_on_the_card_matches_the_host():
    """One float32 step of reduced zamba2-7b (two layers, the shared block
    after each, remat): the loss and every new parameter, the nested
    ``shared`` leaves included, on the card against the host's plain path
    (sums in another order)."""
    _need_cuda()
    from repro_torch._tree import leaves
    card = _zamba2_step("cuda", "float32", 1e-5)
    host = _zamba2_step("cpu", "float32", 1e-5)
    assert abs(float(card[2]["loss"]) - float(host[2]["loss"])) <= 1e-4
    for a, b in zip(leaves(card[0]), leaves(host[0])):
        torch.testing.assert_close(a.cpu(), b, rtol=1e-4, atol=3e-5)


def test_zamba2_train_step_on_the_card_repeats_bit_for_bit():
    """bfloat16: the plain-torch SSD's backward (no ``index_add``,
    ``scatter_add`` or ``gather``) and the kernels' backward give the same
    bits twice."""
    _need_cuda()
    from repro_torch._tree import leaves
    outs = [_zamba2_step("cuda", "bfloat16", 1e-3) for _ in range(2)]
    assert float(outs[0][2]["loss"]) == float(outs[1][2]["loss"])
    for a, b in zip(leaves(outs[0][:2]), leaves(outs[1][:2])):
        assert torch.equal(a, b)


def test_host_staged_p2p_is_bit_exact():
    """A bfloat16 and a float32 CUDA tensor sent from one rank to another
    of a ``gloo`` group (two processes on the one card, staged through
    pinned host memory) arrive with every bit, NaN and -0.0 too."""
    _need_cuda()
    import torch_dist_workers as W
    from repro_torch.launch import collectives as C
    rng = np.random.default_rng(0)
    bits16 = rng.integers(-2 ** 15, 2 ** 15, (3, 257), dtype=np.int16)
    bits32 = rng.integers(-2 ** 31, 2 ** 31, (5, 129), dtype=np.int32)
    bits16[0, :2] = [-32768, 0x7FC0]                 # -0.0, a NaN
    arrays = {"bf16": (bits16, "bfloat16"), "f32": (bits32, "float32")}
    got = C.spawn(W.staged_p2p_on_gpu, 2, (arrays,), timeout=120.0)
    received = dict(got[1])
    np.testing.assert_array_equal(received["bf16"], bits16)
    np.testing.assert_array_equal(received["f32"], bits32)


def test_pp_train_step_world_of_one_on_the_card_matches_the_host():
    """``make_pp_train_step`` on a mesh of one rank (no process group: the
    pipe and data lines are this process), one float32 step of a small
    dense config on the card (the ``rmsnorm`` and ``flash_attention``
    kernels and their backward kernels) against the same step on the host
    (their plain versions): the loss and every parameter."""
    _need_cuda()
    from repro_torch._tree import leaves
    from repro_torch.launch.mesh import Mesh
    from repro_torch.launch.pp_step import make_pp_train_step
    from repro_torch.optim.adamw import AdamW
    cfg = ModelConfig(name="pp1", family="dense", n_layers=2, d_model=64,
                      n_heads=4, n_kv_heads=4, d_ff=128, vocab_size=256,
                      head_dim=16, dtype="float32", remat=True)
    mesh = Mesh(np.zeros((1, 1, 1), dtype=np.int64), ("pipe", "model",
                                                        "data"))
    rng = np.random.default_rng(1)
    batch = {k: rng.integers(0, 256, (2, 2, 32)) for k in ("tokens_mb",
                                                            "labels_mb")}
    full = init_params(cfg, seed=0, device="cuda")
    opt = AdamW(lr=1e-5)
    out = {}
    launches = {}
    for dev in ("cuda", "cpu"):
        params = {"stages": {k: v.to(dev) for k, v in full["layers"].items()},
                  "shared": {k: full[k].to(dev) for k in (
                      "tok_embed", "final_norm", "lm_head")}}
        step, *_ = make_pp_train_step(cfg, mesh, opt, pipe_axis="pipe",
                                      data_axis="data", n_mb=2)
        fa_before, rn_before = fa.flash_attention.launches, \
            rn.rmsnorm.bwd_launches
        out[dev] = step(params, opt.init(params), batch)
        launches[dev] = (fa.flash_attention.launches - fa_before,
                         rn.rmsnorm.bwd_launches - rn_before)
    # 2 microbatches x 2 layers, forward and remat's recompute; a norm
    # backward a layer twice and the head's, a microbatch
    assert launches == {"cuda": (8, 10), "cpu": (0, 0)}
    assert abs(float(out["cuda"][2]["loss"]) - float(out["cpu"][2]["loss"])) \
        <= 1e-4
    for a, b in zip(leaves(out["cuda"][0]), leaves(out["cpu"][0])):
        torch.testing.assert_close(a.cpu(), b, rtol=1e-4, atol=3e-5)


def test_zero1_step_on_the_card_is_bit_equal_to_the_replicated_step():
    """Two ranks of a ``gloo`` group on the one card (data 2): a bfloat16
    dense step with ``zero1=True`` (the gradients reduce-scattered through
    pinned host memory, AdamW on each rank's moment blocks, the parameter
    blocks gathered back) against the replicated step, both without the
    grad clip: the same loss and every parameter's bits on both ranks;
    the moments stored at the ZeRO-1 spec's shard sizes."""
    _need_cuda()
    import torch_dist_workers as W
    from repro_torch.launch import collectives as C
    cfg = dict(name="z1", family="dense", n_layers=2, d_model=128,
               n_heads=2, n_kv_heads=2, d_ff=256, vocab_size=512,
               head_dim=64, dtype="bfloat16", remat=True)
    rng = np.random.default_rng(5)
    batch = {k: rng.integers(0, 512, (4, 64)) for k in ("tokens", "labels")}
    got = C.spawn(W.zero1_on_gpu, 2, ({"cfg": cfg, "batch": batch},),
                  timeout=240.0)
    for r in got:
        assert r[True]["loss"] == r[False]["loss"]
        for a, b in zip(r[True]["bits"], r[False]["bits"]):
            np.testing.assert_array_equal(a, b)
        assert r["moment_bytes"] == r["moment_spec_bytes"]


#: (b, S, D, N, dt_rank) of the bfloat16 working type: the reference's
#: chunk q = 1, 7, 65 and 100 (S 1, 7, 130, 200), D not a multiple of a
#: block's channels (8 forward, 32 backward), N at 16, 5 and 1.
SCAN_BF16_SHAPES = [(2, 1, 24, 16, 2), (1, 7, 9, 5, 1), (2, 130, 45, 16, 3),
                    (1, 200, 40, 1, 2), (1, 256, 40, 16, 2),
                    (2, 64, 24, 16, 2)]
#: (the last two: q = 128 over two chunks, the kernels' compile-time
#: instance, with D not a multiple of 16 or 32; and q = 64)
#: Kernel against plain with the bfloat16 working type: the state within
#: 2e-4 of ``1 + |h|`` and ``out`` at the float32 form's tolerances (the
#: two compute a, u and the tree alike; y sums over N in another order);
#: the gradients within 1e-2 of their largest magnitude (a float32 ulp
#: between the kernel's and torch's sigmoid, exp or sum order can move a
#: bfloat16 rounding of the tree's gradients a step).
SCAN_BF16_STATE_TOL, SCAN_BF16_BWD_TOL = 2e-4, 1e-2


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("shape", SCAN_BF16_SHAPES, ids=str)
def test_selective_scan_fused_bf16_kernel_matches_plain(shape, dtype):
    """The fused form with ``work_dtype=torch.bfloat16`` on the model's
    views: one launch of the bfloat16 instance (its own shape key), held
    to :func:`selective_scan_chunked_ref`'s fused sequence; its training
    instance keeps the state entering every chunk, bit-equal to itself
    and within the state's tolerance of the plain walk's; ``h_out``
    aliasing ``h0`` is updated in place."""
    _need_cuda()
    args, h0 = _fused_inputs(shape, dtype, sum(shape))
    b, s, d, n, _ = shape
    before = ss.selective_scan.launches
    with torch.no_grad():
        out, h = ss.selective_scan_fused(*args, h0,
                                         work_dtype=torch.bfloat16)
    torch.cuda.synchronize()
    assert ss.selective_scan.launches == before + 1
    assert ss.selective_scan.shapes[
        "fused_bf16", (b, s, d), n, dtype] >= 1
    want_out, want_h, want_bounds = ss.selective_scan_fused_bf16_ref(
        *args, h0)
    tol = 2e-2 if dtype == torch.bfloat16 else 2e-4
    diff = (out.float() - want_out.float()).abs()
    assert bool((diff <= tol + tol * want_out.float().abs()).all()), \
        float(diff.max())
    assert bool(((h - want_h).abs() <= SCAN_BF16_STATE_TOL * (
        1 + want_h.abs())).all()), float((h - want_h).abs().max())
    bounds = ss._bounds_for(args[0], n, True)
    out_b, h_b = ss._fused_fwd_cuda(*args, h0, None, False, bounds,
                                    work_bf16=True)
    state = h0.clone()
    out_s, h_s = ss._fused_fwd_cuda(*args, state, state, False,
                                    work_bf16=True)
    torch.cuda.synchronize()
    assert torch.equal(out_b, out) and torch.equal(h_b, h)
    assert h_s is state and torch.equal(state, h) and torch.equal(out_s, out)
    assert bounds.shape == want_bounds.shape
    assert bool(((bounds - want_bounds).abs() <= SCAN_BF16_STATE_TOL * (
        1 + want_bounds.abs())).all())


@pytest.mark.parametrize("start", ["zero", "h0+dh"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("shape", SCAN_BF16_SHAPES, ids=str)
def test_selective_scan_fused_bf16_bwd_kernel_matches_plain(shape, dtype,
                                                            start):
    """The bfloat16 working type's backward kernel, fed by its forward's
    chunk boundaries, against :func:`selective_scan_fused_bf16_bwd_ref`
    within ``SCAN_BF16_BWD_TOL``; a second call and a CUDA-graph replay
    give the same bits (no atomics)."""
    _need_cuda()
    args, h0 = _fused_inputs(shape, dtype, sum(shape))
    b, s, d, n, _ = shape
    rng = np.random.default_rng(sum(shape) + 1)
    dout = _randn(rng, (b, s, d), dtype)
    dhf = _randn(rng, (b, d, n), torch.float32) if "dh" in start else None
    args = (*args, h0 if "h0" in start else None)
    bounds = ss._bounds_for(args[0], n, True)
    ss._fused_fwd_cuda(*args, None, False, bounds, work_bf16=True)
    before = ss.selective_scan.bwd_launches
    got = ss._bwd_cuda(*args, dout, dhf, bounds, work_bf16=True)
    torch.cuda.synchronize()
    assert ss.selective_scan.bwd_launches == before + 1
    want = ss.selective_scan_fused_bf16_bwd_ref(*args, dout, dhf)
    for name, g, w in zip(("x", "dt", "dt_bias", "B", "C", "A_log", "D",
                           "z", "h0"), got, want):
        if w is None:
            assert g is None
            continue
        assert g.shape == w.shape and g.dtype == w.dtype, name
        assert bool(torch.isfinite(g).all()), name
        err = float((g.float() - w.float()).abs().max())
        assert err <= SCAN_BF16_BWD_TOL * max(
            float(w.float().abs().max()), 1e-30), (name, err)
    again = ss._bwd_cuda(*args, dout, dhf, bounds, work_bf16=True)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        replayed = ss._bwd_cuda(*args, dout, dhf, bounds, work_bf16=True)
    graph.replay()
    torch.cuda.synchronize()
    for g, a, r in zip(got, again, replayed):
        assert (g is None and a is None and r is None) or (
            torch.equal(g, a) and torch.equal(g, r))


#: bfloat16 bit patterns at the edges: +-0, the smallest and largest
#: subnormals, the smallest normal, one, the largest finite, +-inf, quiet
#: and signalling NaN.
BF16_EDGES = [0x0000, 0x8000, 0x0001, 0x8001, 0x007F, 0x807F, 0x0080, 0x8080,
              0x3F80, 0xBF80, 0x7F7F, 0xFF7F, 0x7F80, 0xFF80, 0x7FC0, 0xFFC0,
              0x7F81]


def test_bf16_native_pair_ops_are_float32_rounded():
    """The working type's tree runs ``mul.rn.bf16x2`` and ``add.rn.bf16x2``
    in place of the float32 product and sum rounded to bfloat16: the
    library's probe entry (``selective_scan_bf16_ops_probe``) gives the same
    bits on 2**20 random pairs of bit patterns (every exponent, infinities
    and NaN among them) and on every pair of edge values (subnormals, +-0,
    the largest finite, +-inf, NaN), in both halves of a word."""
    _need_cuda()
    rng = np.random.default_rng(5)
    edges = np.array(BF16_EDGES, dtype=np.uint32)
    ea, eb = np.meshgrid(edges, edges, indexing="ij")
    ea, eb = ea.ravel(), eb.ravel()

    def halves(edge):
        return np.concatenate(
            [rng.integers(0, 1 << 16, 1 << 20, dtype=np.uint32), edge])
    # the edge pairs (ea, eb) in the low halves and (eb, ea) in the high
    a = halves(ea) | (halves(eb) << 16)
    b = halves(eb) | (halves(ea) << 16)
    ta, tb = (torch.from_numpy(v.view(np.int32)).cuda() for v in (a, b))
    out = torch.empty((a.size, 4), dtype=torch.int32, device="cuda")
    _build.launch("selective_scan_bf16_ops_probe", out.get_device(),
                  ta.data_ptr(), tb.data_ptr(), out.data_ptr(), a.size)
    out = out.cpu().numpy().view(np.uint32)
    for name, native, rounded in (("product", out[:, 0], out[:, 1]),
                                  ("sum", out[:, 2], out[:, 3])):
        bad = np.flatnonzero(native != rounded)
        assert bad.size == 0, (name, [(hex(a[i]), hex(b[i]), hex(native[i]),
                                       hex(rounded[i])) for i in bad[:8]])


def test_scan_bf16_kernels_occupancy():
    """The bfloat16 working type's kernels at q = 128 as the card holds
    them: the forward (both instances) 4 blocks of 8 warps an SM (64
    registers), the backward 2 (128 registers)."""
    _need_cuda()
    for dtype in (torch.bfloat16, torch.float32):
        for form, want in (("fused_bf16", 4), ("fused_bf16_bound", 4),
                           ("fused_bf16_bwd", 2)):
            smem, blocks = ss.bwd_occupancy(dtype, form)
            assert blocks >= want and smem <= 100 * 1024, (dtype, form,
                                                           smem, blocks)


def test_scan_dtype_bfloat16_runs_on_the_card():
    """Reduced falcon-mamba-7b's Mamba1 block with ``scan_dtype =
    "bfloat16"`` on the card: the forward launches the bfloat16 instance,
    under a gradient its training instance and its backward kernel
    (``SelectiveScanFusedBf16Fn``), held to the host's block; the decode
    step ignores the knob and runs the float32 step."""
    _need_cuda()
    from repro_torch.models import mamba
    cfg = configs.get("falcon-mamba-7b").reduced(scan_dtype="bfloat16")
    p = {k: v[0] for k, v in init_params(cfg, seed=0, device="cuda")[
        "layers"].items()}
    x = torch.randn((2, 130, cfg.d_model), device="cuda")
    ss.selective_scan.shapes.clear()
    with torch.no_grad():
        y, (h, conv) = mamba.mamba1_block(x, p, cfg)
    host = {k: v.cpu() for k, v in p.items()}
    y_h, (h_h, _) = mamba.mamba1_block(x.cpu(), host, cfg)
    assert float((y.cpu() - y_h).abs().max()) <= 2e-3 * (
        1 + float(y_h.abs().max()))
    assert float((h.cpu() - h_h).abs().max()) <= 2e-3 * (
        1 + float(h_h.abs().max()))
    xl = x.clone().requires_grad_()
    yl, _ = mamba.mamba1_block(xl, p, cfg)
    yl.float().square().sum().backward()
    assert bool(torch.isfinite(xl.grad).all())
    with torch.no_grad():
        y1, _ = mamba.mamba1_block(x[:, 0], p, cfg, h0=h.clone(),
                                   conv0=conv, single_step=True)
    assert bool(torch.isfinite(y1).all())
    shape = (2, 130, cfg.d_inner)
    n, dt = cfg.ssm_state, x.dtype
    assert dict(ss.selective_scan.shapes) == {
        ("fused_bf16", shape, n, dt): 1,
        ("fused_bf16_bound", shape, n, dt): 1,
        ("fused_bf16_bwd", shape, n, dt): 1,
        ("fused", (2, 1, cfg.d_inner), n, dt, True): 1}


def test_quickstart_example_runs_on_the_card():
    """``examples/torch/quickstart.py``'s ``run`` on the card (reduced
    qwen2-7b, 200 SA iterations a candidate, 4 steps): its plan equal,
    apart from the recorded backend, to the same request on the host's
    NumPy backend; the training launched the norm and attention kernels
    and their backward kernels, the plan the group reduce; the losses and
    the greedy tokens are finite and in the vocabulary."""
    _need_cuda()
    import dataclasses
    import importlib.util
    import os
    path = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "examples", "torch", "quickstart.py")
    spec = importlib.util.spec_from_file_location("torch_quickstart", path)
    qs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(qs)
    cfg = configs.get("qwen2-7b").reduced()
    budget = plan.Budget(sa_seconds=600.0, sa_iters=200)
    kernels = (gr.group_min_scale, rn.rmsnorm, fa.flash_attention)
    before = [k.launches for k in kernels]
    bwd_before = [k.bwd_launches for k in kernels[1:]]
    res = qs.run(cfg, init_params(cfg, seed=0, device="cuda"), budget, 4,
                 "cuda")
    torch.cuda.synchronize()
    assert all(k.launches > b for k, b in zip(kernels, before))
    assert all(k.bwd_launches > b for k, b in zip(kernels[1:], bwd_before))
    req, bw, _ = qs.plan_request(cfg, dataclasses.replace(budget,
                                                          backend="numpy"))
    host = plan.Planner(plan.PipetteStrategy(), device="cuda").plan(req, bw)

    def strip(text):
        d = json.loads(text)
        d["provenance"]["budget"].pop("backend")
        return json.dumps(d, sort_keys=True)
    assert strip(res["plan_json"]) == strip(host.to_json())
    assert np.isfinite(res["losses"]).all() and len(res["losses"]) == 4
    assert len(res["tokens"]) == qs.DECODE_STEPS + 1
    assert all(0 <= t < cfg.vocab_size for t in res["tokens"])
