"""Card-only tests of the PyTorch package (marker ``gpu``).

They build the CUDA kernels with ``nvcc``, launch them, and hold them and
the engine on the card against the plain PyTorch versions and the host
NumPy engine.  Without a CUDA device every test here skips with a reason
(decided inside the test, never at import).  This file imports ``torch``
and ``repro_torch`` only, so it also runs on a machine without JAX:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu.py
"""
import json

import numpy as np
import pytest
import torch

from repro_torch.core import annealing, cluster, dedication, plan, simulator
from repro_torch.core.memory import enumerate_confs
from repro_torch.core.torch_engine import TorchDedicationEngine
from repro_torch.kernels import group_reduce as gr
from repro_torch.models.config import ModelConfig

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
