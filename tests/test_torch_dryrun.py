"""The dry run on meta tensors (``launch/dryrun.py``, ``reanalyze.py``), the
kernels' meta branches and the collectives' dry mode.

A handful of cells at full width, one rank of the production mesh each —
a dense, a MoE and a Mamba cell, the ``pp16`` and ``scan-bf16``
variants, a skip — meet the properties the reference's
``tests/test_artifacts.py`` asks of its cells: FLOPs above 0, a known
bottleneck, ``0 < useful_flops_ratio <= 1.5``, collective bytes above 0
for ``train_4k``, multi-pod bytes a device at most 1.05 times
single-pod's for ``train_4k``, and the device count.  A
tiny dense cell's stored bytes and FSDP gather bytes are counted by hand.
``reanalyze`` recomputes the terms and changes nothing on a second run.
The ranks' own counters against the dry run's are in
``tests/test_torch_distributed.py`` and ``test_torch_tensor_parallel.py``
(and on the card, ``chip_smoke.py``'s ``dryrun_vs_card``).
"""
import json

import numpy as np
import pytest
import torch

from repro_torch.kernels import _meta
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import rmsnorm as rn
from repro_torch.kernels import selective_scan as ss
from repro_torch.launch import collectives as C
from repro_torch.launch import dryrun, reanalyze
from repro_torch.launch.mesh import Mesh, make_production_mesh
from repro_torch.models.config import ModelConfig
from repro_torch.models.sharding import ShardCtx

#: (arch, shape, multi-pod, variant)
CELLS = [("qwen2-7b", "train_4k", False, ""),
         ("qwen2-7b", "train_4k", True, ""),
         ("granite-moe-3b-a800m", "prefill_32k", False, ""),
         ("falcon-mamba-7b", "decode_32k", False, ""),
         ("falcon-mamba-7b", "decode_32k", False, "scan-bf16"),
         ("falcon-mamba-7b", "long_500k", True, ""),
         ("gemma3-12b", "train_4k", False, "pp16"),
         ("qwen2-7b", "long_500k", False, "")]


@pytest.fixture(scope="module")
def cells(tmp_path_factory):
    """The cells of :data:`CELLS`, written by the CLI's own path (``main``
    for each) into one directory, and read back."""
    out = tmp_path_factory.mktemp("dryrun")
    for arch, shape, multi, variant in CELLS:
        argv = ["--arch", arch, "--shape", shape, "--out", str(out),
                "--mesh", "multipod" if multi else "pod"]
        if variant:
            argv += ["--variant", variant]
        assert dryrun.main(argv) == 0
    return out, {p.name: json.loads(p.read_text())
                 for p in out.glob("*.json")}


def test_cells_meet_the_reference_artifact_properties(cells):
    _, got = cells
    assert len(got) == len(CELLS)
    skips = [c for c in got.values() if "skipped" in c]
    assert [(c["arch"], c["shape"]) for c in skips] == [
        ("qwen2-7b", "long_500k")]
    assert skips[0]["skipped"] == ("pure full-attention arch: 500k dense KV "
                                   "cache excluded per assignment spec")
    for c in got.values():
        if "skipped" in c:
            continue
        name = (c["arch"], c["shape"], c["mesh"], c["variant"])
        assert c["flops_per_dev"] > 0 and c["hbm_bytes_per_dev"] > 0, name
        assert c["t_compute"] >= 0 and c["t_memory"] > 0, name
        assert c["bottleneck"] in ("compute", "memory", "collective"), name
        assert 0 < c["useful_flops_ratio"] <= 1.5, name
        if c["shape"] == "train_4k":
            assert c["collective_bytes_per_dev"] > 0, name
        assert c["n_devices"] == (512 if c["mesh"] == "2x16x16" else 256)
        assert c["bytes_per_device"] == c["memory"]["argument_bytes"] \
            + c["memory"]["temp_bytes"]
        assert isinstance(c["fits_h100_80g"], bool)
        # the fields with no counterpart are left out, not faked
        assert not {"compile_s", "parse_s", "hlo_bytes_len",
                    "xla_cost_flops_per_dev"} & set(c)
    single = got["qwen2-7b__train_4k__16x16.json"]
    multi = got["qwen2-7b__train_4k__2x16x16.json"]
    assert multi["bytes_per_device"] <= single["bytes_per_device"] * 1.05
    # the kernels ran as meta branches, never as their plain versions
    assert single["kernel_calls"]["flash_attention"] > 0
    assert single["kernel_calls"]["flash_attention_bwd"] > 0
    assert got["falcon-mamba-7b__decode_32k__16x16.json"][
        "kernel_calls"]["selective_scan"] == 64
    pp = got["gemma3-12b__train_4k__16x16-pp16.json"]
    assert pp["variant"] == "pp16" and pp["collectives"][
        "collective-permute"] > 0
    # the pipeline trades the tensor-parallel sums for stage-boundary P2P
    assert pp["collectives_by_kind"]["tp"] == 0
    # a rank of each stage role; the cell reports the slowest stage's
    # counts (the last, with the head and its 262k-word vocabulary), and
    # fits only if every stage does
    stages = {st["stage"]: st for st in pp["stages"]}
    assert sorted(stages) == [0, 1, 15]
    line = make_production_mesh().axis_ranks("model", dryrun.DRY_RANK)
    assert [st["dry_rank"] for st in pp["stages"]] == [line[0], line[1],
                                                       line[15]]
    last = stages[15]
    assert last["flops_per_dev"] > stages[1]["flops_per_dev"]
    assert pp["stage"] == 15 and pp["dry_rank"] == last["dry_rank"]
    for k in dryrun.RANK_FIELDS:
        assert pp[k] == last[k], k
    assert pp["fits_h100_80g"] == all(
        st["bytes_per_device"] <= dryrun.H100_TOTAL_MEMORY
        for st in pp["stages"])


def test_reanalyze_is_idempotent(cells, tmp_path):
    """``reanalyze`` recomputes each cell's terms from its raw counts: the
    values ``run_cell`` wrote, and the same again on a second run; a skip
    is left as it is."""
    out, got = cells
    for name, c in got.items():
        (tmp_path / name).write_text(json.dumps(c))
    n = len([c for c in got.values() if "skipped" not in c])
    assert reanalyze.reanalyze(tmp_path) == n
    first = {p.name: p.read_text() for p in tmp_path.glob("*.json")}
    assert reanalyze.reanalyze(tmp_path) == n
    second = {p.name: p.read_text() for p in tmp_path.glob("*.json")}
    assert first == second
    for name, text in first.items():
        assert json.loads(text) == got[name], name


#: A tiny dense config for the hand count: L 2, d 8, 2 heads of 4 (no KV
#: grouping), d_ff 16, vocabulary 256 (already a multiple of 256), float32.
TINY = dict(name="tiny", family="dense", n_layers=2, d_model=8, n_heads=2,
            n_kv_heads=2, head_dim=4, d_ff=16, vocab_size=256,
            dtype="float32", remat=False)


def test_tiny_cell_counted_by_hand():
    """On a (data 2, model 2) mesh with FSDP, every weight is cut four
    ways but the norms: per rank ``wq, wk, wv`` 2*8*2*4 / 4 = 32 elements
    each, ``wo`` 32, ``gate, up, down`` 2*8*16 / 4 = 64 each, ``ln1,
    ln2`` 16 each whole, ``final_norm`` 8, ``tok_embed`` and ``lm_head``
    256*8 / 4 = 512 each: 1384 float32 elements, 5536 bytes; the moments
    twice that, and the 4-byte step: 16612 bytes stored.  A prefill
    gathers every FSDP weight once over the data axis, each to its
    model-axis cut: ``wq, wk, wv, wo`` 2*64, ``gate, up, down`` 2*128,
    ``tok_embed`` and ``lm_head`` 1024 each — 2688 elements, 10752 bytes
    of kind ``fsdp``; a training step (one microbatch, no remat) gathers
    the same and sums their cotangents back at the same size: 21504."""
    from repro_torch.launch import steps
    from repro_torch.optim.adamw import AdamW
    cfg = ModelConfig(**TINY)
    mesh = Mesh(np.arange(4).reshape(2, 2), ("data", "model"))
    ctx = ShardCtx(mesh=mesh, dp=("data",), tp="model", fsdp=("data",))
    params, state = dryrun.train_meta_state(cfg, ctx, mesh)
    assert dryrun._tree_bytes((params, state)) == 4 * 1384 * 3 + 4 == 16612
    toks = torch.empty((2, 4), dtype=torch.int64, device="meta")
    m = dryrun.measure(steps.make_prefill_step(cfg, ctx),
                       (params, {"tokens": toks}), {"batch": 4})
    assert m["stats"]["fsdp"] == 4 * 2688 == 10752
    m = dryrun.measure(steps.make_train_step(cfg, ctx, AdamW()),
                       (params, state, {"tokens": toks, "labels": toks}))
    assert m["stats"]["fsdp"] == 2 * 10752
    # matmuls and the kernels' own counts: something of each
    assert m["flops"] > m["kernel_flops"] > 0


def test_meta_branches_count_the_bound_and_never_run_the_plain_version(
        monkeypatch):
    """On meta tensors the attention, norm and scan wrappers (and their
    Functions' backward) return their outputs' shapes and add their
    bound's operations and bytes; the plain versions are never called."""
    def boom(*a, **k):
        raise AssertionError("a plain version ran on the meta device")
    for mod, name in ((fa, "flash_attention_ref"), (rn, "rmsnorm_ref"),
                      (rn, "add_rmsnorm_ref"),
                      (ss, "selective_scan_fused_ref")):
        monkeypatch.setattr(mod, name, boom)
    _meta.reset()
    b, h, s, d = 2, 4, 16, 8
    q = torch.empty((b, h, s, d), device="meta", requires_grad=True)
    k = torch.empty((b, 2, s, d), device="meta", requires_grad=True)
    o = fa.flash_attention(q, k, k.clone(), causal=True)
    assert o.shape == q.shape and o.is_meta
    pairs = s * (s + 1) // 2
    assert fa.allowed_pairs(s, s, True, 0) == pairs
    assert _meta.COUNTS["flops"] == 4 * b * h * d * pairs
    o.sum().backward()
    assert q.grad.shape == q.shape and _meta.CALLS["flash_attention_bwd"] == 1
    x = torch.empty((3, 5, 8), device="meta")
    w = torch.empty(8, device="meta")
    assert rn.rmsnorm(x, w).shape == x.shape
    s_, y = rn.add_rmsnorm(x, x.clone(), w)
    assert s_.shape == y.shape == x.shape
    args = [torch.empty(shape, device="meta") for shape in (
        (2, 7, 8), (2, 7, 8), (8,), (2, 7, 4), (2, 7, 4), (8, 4), (8,),
        (2, 7, 8))]
    out, hN = ss.selective_scan_fused(*args)
    assert out.shape == (2, 7, 8) and hN.shape == (2, 8, 4)
    assert _meta.CALLS["selective_scan"] == 1
    assert _meta.CALLS["rmsnorm"] == 2
    # the analytic pair count is the mask's, windows and offsets included
    for sq, sk, causal, window, off in ((5, 9, True, 3, 4), (7, 7, False, 0,
                                                             0),
                                        (4, 12, True, 0, 8)):
        assert fa.allowed_pairs(sq, sk, causal, window, off) == int(
            fa._allowed(sq, sk, causal, window, "cpu", off).sum())


def test_collectives_dry_mode_needs_no_process_group():
    """Inside ``collectives.dry`` each call returns meta tensors of its
    result's shape, counts its bytes as on a rank (by kind and by the
    reference's op names: an all-reduce twice its operand), and
    ``rank()`` is the rank the dry run stands for."""
    mesh = Mesh(np.arange(8).reshape(2, 4), ("data", "model"))
    t = torch.empty((4, 6), dtype=torch.bfloat16, device="meta")
    C.reset_stats()
    with C.dry(5):
        assert C.rank() == 5
        g = C.all_gather(t, mesh, "model", 1, "fsdp")
        assert g.shape == (4, 24) and g.is_meta
        (rs,) = C.reduce_scatter([t], mesh, "data", [0], "mean", "data")
        assert rs.shape == (2, 6)
        C.all_reduce([t], mesh, "model", "sum", "tp")
        C.send(t, 1).wait()
        assert C.recv((3,), torch.float32, "meta", 0).shape == (3,)
    nb = 4 * 6 * 2
    assert C.STATS["fsdp"] == 4 * nb and C.STATS["data"] == nb
    assert C.STATS["tp"] == nb and C.STATS["p2p"] == nb + 12
    assert C.OPS == {"all-reduce": 2 * nb, "all-gather": nb,
                     "reduce-scatter": nb, "all-to-all": 0,
                     "collective-permute": nb}
    assert not C.is_dry()


def test_traffic_counts_the_arguments_once_and_collectives_as_a_rank():
    """The dry peak counts the step's arguments once (``argument_bytes``),
    not again through the views a step takes of them; and a collective's
    device tensors as a rank makes them: an all-gather's received blocks
    beside the joined result, a reduce-scatter's sum beside one received
    row, an all-reduce's flat bucket."""
    mesh = Mesh(np.arange(4).reshape(4, 1), ("data", "model"))
    x = torch.empty((8, 6), dtype=torch.float32, device="meta")
    nb = 8 * 6 * 4
    m = dryrun.measure(lambda t: t.detach()[2:4].t() * 1, (x,))
    assert m["argument_bytes"] == nb and m["temp_bytes"] == 2 * 6 * 4
    m = dryrun.measure(lambda t: C.all_gather(t, mesh, "data", 0), (x,))
    assert m["temp_bytes"] == 2 * 4 * nb
    m = dryrun.measure(lambda t: C.reduce_scatter([t], mesh, "data", [0]),
                       (x,))
    assert m["temp_bytes"] == 2 * nb // 4
    m = dryrun.measure(lambda t: C.all_reduce([t], mesh, "data"), (x,))
    assert m["temp_bytes"] == nb
