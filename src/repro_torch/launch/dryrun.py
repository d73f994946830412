"""Multi-pod dry run on meta tensors.

Port of the JAX package's ``launch/dryrun.py``.  For every (architecture
x input shape x mesh) cell the reference lowers and compiles the real
train / prefill / decode step against ``ShapeDtypeStruct`` stand-ins on
the production mesh (16x16 single-pod, 2x16x16 multi-pod) and reads XLA's
memory and cost analyses and a walk of the HLO.  PyTorch has no HLO: here
the port's own step runs, as one rank (rank 0) of
``make_production_mesh``, on meta tensors of that rank's blocks
(``launch/specs.py``), with nothing allocated, and counts what the rank
would allocate, compute and communicate.  A pipeline cell (``pp16``) runs
as a rank of each stage role (the first stage, the second, the last; the
others match the second) and reports the slowest one's counts, as the
slowest stage sets the pipeline's step; every stage's are kept beside
them, and ``fits_h100_80g`` asks every stage to fit:

* collectives run in ``collectives.dry`` mode: no process group, each
  call's bytes counted as on the card, by the port's kinds (``fsdp``,
  ``tp``, ...) and by the reference's HLO op names (``all-reduce`` twice
  its operand, as the reference's ring multiplier), and the tensors a
  rank makes on its device for a call made alike;
* the kernels' meta branches return their outputs' shapes and count the
  operations and bytes of their bound (``kernels/_meta.py``): never the
  plain versions, whose materialised score matrices the card's kernel
  never makes;
* every other op's FLOPs by ``torch.utils.flop_counter.FlopCounterMode``;
* a ``TorchDispatchMode`` (:class:`Traffic`) adds each op's input and
  output bytes (views and allocations move none) and tracks the peak of
  the live storage the step makes; the arguments' storage (the stored
  state and the batch) is counted once, as ``argument_bytes``, not again
  when a view of it is taken.

The cell's JSON keeps the reference's field names where a counterpart
exists; the roofline terms use one H100 80GB HBM3's datasheet figures at
700 W (:data:`H100_PEAK_FLOPS`, :data:`H100_HBM_BW`, :data:`H100_NVLINK_BW`;
every collective byte is taken to cross NVLink).  The reference's
``compile_s``, ``parse_s``, ``hlo_bytes_len`` and ``xla_cost_*`` have no
counterpart and are left out.

Usage:
  python -m repro_torch.launch.dryrun --arch qwen2-7b --shape train_4k --mesh pod
  python -m repro_torch.launch.dryrun --all --mesh both
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
import weakref
from pathlib import Path
from typing import Any, Dict

import torch
from torch.utils._python_dispatch import TorchDispatchMode

#: One H100 80GB HBM3 SXM at 700 W, datasheet: dense bfloat16 tensor-core
#: FLOP/s, HBM bytes/s, NVLink bytes/s a direction.
H100_PEAK_FLOPS = 989e12
H100_HBM_BW = 3.35e12
H100_NVLINK_BW = 450e9
#: ``torch.cuda.get_device_properties(0).total_memory`` of an H100 80GB
#: HBM3, as ``chip_smoke.py``'s ``dryrun_vs_card`` reads it on one.
H100_TOTAL_MEMORY = 85_017_493_504
CARD = "NVIDIA H100 80GB HBM3, 700 W (datasheet)"

# The reference's §Perf variants, by its names; baseline = no variant.
PERF_VARIANTS = {
    # MoE combine via fp32-accumulating einsum instead of materialising an
    # fp32 (T*k, d) tensor
    "moe-bf16": {"cfg": {"moe_combine_f32_materialize": False}},
    # Megatron-style sequence parallelism for the residual stream
    "seqpar": {"cfg": {"seq_shard_residuals": True}},
    # mamba selective-scan working dtype bf16 (state carry stays fp32)
    "scan-bf16": {"cfg": {"scan_dtype": "bfloat16"}},
    # ZeRO-1: params replicated over data; moments sharded over data
    "zero1": {"fsdp": False, "zero1": True},
    "seqpar-zero1": {"cfg": {"seq_shard_residuals": True},
                     "fsdp": False, "zero1": True},
    "moe-bf16-seqpar": {"cfg": {"moe_combine_f32_materialize": False,
                                "seq_shard_residuals": True}},
    # index-buffer MoE dispatch: no k-times activation repeat
    "moe-gather": {"cfg": {"moe_gather_dispatch": True}},
    "moe-gather-bf16": {"cfg": {"moe_gather_dispatch": True,
                                "moe_combine_f32_materialize": False}},
    # no activation recomputation
    "noremat": {"cfg": {"remat": False}},
    # pipeline parallelism over the 'model' axis, tp=1, dp over 'data'
    "pp16": {"pp": True},
}

#: The rank of the production mesh a cell runs as.
DRY_RANK = 0
#: The reference's pipeline cell: microbatches of its global batch, and
#: the mesh axis its stages run over.
PP_N_MB = 16
PP_AXIS = "model"


def _nbytes(t: torch.Tensor) -> int:
    return t.untyped_storage().nbytes()


class Traffic(TorchDispatchMode):
    """Counts, for every op dispatched inside it, the bytes of its tensor
    inputs and outputs (``bytes``; views and fresh allocations move
    none), and the live storage the ops make: a storage counts from the
    op that makes it until the last tensor seen on it is freed; ``peak``
    is the most at once.  The storages of the tensors in ``held`` (the
    step's arguments, alive throughout and counted by the caller) are
    not counted, whatever views of them the ops take."""

    _FREE = ("empty", "empty_like", "new_empty", "empty_strided",
             "new_empty_strided", "detach", "alias", "lift_fresh")

    def __init__(self, held=()):
        super().__init__()
        self.bytes = 0
        self.live = 0
        self.peak = 0
        self._refs: Dict[int, list] = {}
        self._held = {t.untyped_storage()._cdata for t in _tensors(held)}

    def _seen(self, t: torch.Tensor) -> None:
        st = t.untyped_storage()
        key = st._cdata
        if key in self._held:
            return
        entry = self._refs.get(key)
        if entry is None:
            entry = self._refs[key] = [st.nbytes(), 0]
            self.live += entry[0]
            self.peak = max(self.peak, self.live)
        entry[1] += 1
        weakref.finalize(t, self._drop, key)

    def _drop(self, key: int) -> None:
        entry = self._refs.get(key)
        if entry is None:
            return
        entry[1] -= 1
        if entry[1] == 0:
            self.live -= entry[0]
            del self._refs[key]

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        name = func.overloadpacket.__name__
        outs = [t for t in _tensors(out)]
        if not (func.is_view or name in self._FREE):
            ins = [t for t in _tensors((args, kwargs))]
            self.bytes += sum(t.numel() * t.element_size()  # repro: noqa DET004 -- byte counts are ints; integer addition is order-independent
                              for t in ins + outs)
        for t in outs:
            self._seen(t)
        return out


def _tensors(tree):
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, (list, tuple)):
        for x in tree:
            yield from _tensors(x)
    elif isinstance(tree, dict):
        for x in tree.values():
            yield from _tensors(x)


def _tree_bytes(tree) -> int:
    from .._tree import leaves
    return sum(_nbytes(t) for t in leaves(tree)  # repro: noqa DET004 -- byte counts are ints; integer addition is order-independent
               if isinstance(t, torch.Tensor))


def pp_meta_state(p_spec, o_spec, mesh):
    """A rank's stored state of ``make_pp_train_step`` as meta tensors:
    ``(params, opt_state)`` of the step's spec trees ``p_spec``,
    ``o_spec`` (a stage leaf without its pipe dim)."""
    from ..optim.adamw import AdamWState
    from . import specs as SP

    def tree(t):
        return {"stages": SP.blocks(t["stages"], mesh, lead=1),
                "shared": SP.blocks(t["shared"], mesh)}
    step = torch.zeros((), dtype=torch.int32, device="meta")
    return tree(p_spec), AdamWState(step, tree(o_spec.m), tree(o_spec.v))


def train_meta_state(cfg, ctx, mesh, zero1: bool = False):
    """A rank's stored ``(params, opt_state)`` of ``make_train_step``
    under ``ctx`` as meta tensors (the moments ZeRO-1 blocks with
    ``zero1``)."""
    from . import specs as SP
    return (SP.blocks(SP.params_spec(cfg, ctx), mesh),
            SP.blocks(SP.opt_spec(cfg, ctx, None, zero1=zero1), mesh))


def _inputs(cfg, shape, ctx, mesh, var: dict, n_micro: int):
    """``(step, args, kwargs, stored)``: the cell's step, its meta inputs
    (this rank's blocks) and the trees of parameters and optimizer state
    the rank stores."""
    from ..optim.adamw import AdamW
    from . import specs as SP
    from .steps import make_decode_step, make_prefill_step, make_train_step
    opt = AdamW(lr=1e-4)
    if var.get("pp") and shape.kind == "train":
        from .pp_step import make_pp_train_step
        step, p_spec, o_spec, b_spec = make_pp_train_step(
            cfg, mesh, opt, pipe_axis=PP_AXIS, data_axis="data",
            n_mb=PP_N_MB)
        params, state = pp_meta_state(p_spec, o_spec, mesh)
        batch = SP.blocks(b_spec, mesh)
        return step, (params, state, batch), {}, (params, state)
    if shape.kind == "train":
        zero1 = bool(var.get("zero1"))
        step = make_train_step(cfg, ctx, opt, n_micro=n_micro, zero1=zero1)
        params, state = train_meta_state(cfg, ctx, mesh, zero1)
        batch = SP.blocks(SP.batch_spec(cfg, shape, ctx), mesh)
        return step, (params, state, batch), {}, (params, state)
    params = SP.blocks(SP.params_spec(cfg, ctx), mesh)
    b = shape.global_batch
    if shape.kind == "prefill":
        inputs = SP.blocks(SP.batch_spec(cfg, shape, ctx), mesh)
        inputs = {k: v.long() if not v.is_floating_point() else v
                  for k, v in inputs.items()}
        return (make_prefill_step(cfg, ctx), (params, inputs),
                {"batch": b}, (params,))
    token, cache, _ = SP.decode_inputs(cfg, shape, ctx)
    token = SP.blocks(token, mesh).long()
    cache = SP.blocks(cache, mesh)
    return (make_decode_step(cfg, ctx),
            (params, cache, token, shape.seq_len - 1),
            {"batch": b, "seq_len": shape.seq_len}, (params, cache))


def measure(step, args, kwargs=None, rank: int = DRY_RANK) -> dict:
    """``step(*args, **kwargs)`` on meta tensors as global ``rank`` (inside
    ``collectives.dry``), counted: ``flops`` (``FlopCounterMode``'s and the
    kernels' own), ``hbm_bytes`` (:class:`Traffic`'s and the kernels'),
    ``temp_bytes`` (the peak of the live storage the step made),
    ``argument_bytes`` and ``output_bytes``, ``stats`` and ``ops`` (the
    collectives' bytes by the port's kinds, ``collectives.STATS``, and by
    the reference's op names), the kernels' calls, and ``seconds``."""
    from torch.utils.flop_counter import FlopCounterMode
    from ..kernels import _meta
    from . import collectives as C
    C.reset_stats()
    _meta.reset()
    t0 = time.perf_counter()
    with C.dry(rank), FlopCounterMode(display=False) as fc, \
            Traffic(held=(args, kwargs)) as tr:
        out = step(*args, **(kwargs or {}))
    seconds = time.perf_counter() - t0
    return {"flops": float(fc.get_total_flops()) + _meta.COUNTS["flops"],
            "hbm_bytes": float(tr.bytes) + _meta.COUNTS["bytes"],
            "temp_bytes": tr.peak, "argument_bytes": _tree_bytes(args),
            "output_bytes": _tree_bytes(out), "stats": dict(C.STATS),
            "ops": dict(C.OPS), "kernel_calls": dict(_meta.CALLS),
            "kernel_flops": _meta.COUNTS["flops"],
            "kernel_bytes": _meta.COUNTS["bytes"], "seconds": seconds,
            "out": out}


def terms(d: dict) -> dict:
    """The roofline terms of a rank's raw counts (``flops_per_dev``,
    ``hbm_bytes_per_dev``, ``collective_bytes_per_dev``,
    ``collective_bytes_native``, ``model_flops``, ``n_devices``) under this
    module's constants: the seconds of each term, the ``bottleneck``, and
    ``useful_flops_ratio``."""
    out = {"t_compute": d["flops_per_dev"] / H100_PEAK_FLOPS,
           "t_memory": d["hbm_bytes_per_dev"] / H100_HBM_BW,
           "t_collective": d["collective_bytes_per_dev"] / H100_NVLINK_BW,
           "t_collective_native": d["collective_bytes_native"]
           / H100_NVLINK_BW}
    t = {"compute": out["t_compute"], "memory": out["t_memory"],
         "collective": out["t_collective"]}
    out["bottleneck"] = max(t, key=t.get)
    total = d["flops_per_dev"] * d["n_devices"]
    out["useful_flops_ratio"] = d["model_flops"] / total if total else 0.0
    return out


#: A rank's own counts in a cell (a pipeline cell keeps them per stage).
RANK_FIELDS = ("dry_rank", "lower_s", "flops_per_dev", "hbm_bytes_per_dev",
               "collective_bytes_per_dev", "collective_bytes_native",
               "collectives", "collectives_by_kind", "kernel_calls",
               "kernel_flops", "kernel_bytes", "memory", "bytes_per_device")


def analyze(d: dict) -> dict:
    """A cell's derived fields from its raw counts: :func:`terms` and
    ``fits_h100_80g``.  A cell with ``stages`` (a pipeline's counts per
    stage role) gets each stage's terms, and the slowest stage (its
    longest term the longest) gives the cell's own counts and terms; the
    cell fits when every stage does."""
    out: Dict[str, Any] = {}
    if d.get("stages"):
        stages = [dict(st, **terms(dict(d, **st))) for st in d["stages"]]
        slowest = max(stages, key=lambda st: max(
            st["t_compute"], st["t_memory"], st["t_collective"]))
        out["stages"] = stages
        out["stage"] = slowest["stage"]
        out.update({k: slowest[k] for k in RANK_FIELDS})
        most = max(st["bytes_per_device"] for st in stages)
    else:
        most = d["bytes_per_device"]
    out.update(terms(dict(d, **out)))
    out["fits_h100_80g"] = bool(most <= H100_TOTAL_MEMORY)
    return out


def _rank_counts(m: dict, rank: int) -> dict:
    """The :data:`RANK_FIELDS` of one :func:`measure` as ``rank``."""
    coll = float(sum(m["ops"].values()))  # repro: noqa DET004 -- byte counts are ints; integer addition is order-independent
    return {"dry_rank": rank, "lower_s": round(m["seconds"], 2),
            "flops_per_dev": m["flops"], "hbm_bytes_per_dev": m["hbm_bytes"],
            "collective_bytes_per_dev": coll,
            "collective_bytes_native": coll,
            "collectives": {k: float(v) for k, v in m["ops"].items() if v},
            "collectives_by_kind": m["stats"],
            "kernel_calls": m["kernel_calls"],
            "kernel_flops": m["kernel_flops"],
            "kernel_bytes": m["kernel_bytes"],
            "memory": {"argument_bytes": m["argument_bytes"],
                       "output_bytes": m["output_bytes"],
                       "temp_bytes": m["temp_bytes"],
                       "alias_bytes": 0, "code_bytes": 0},
            "bytes_per_device": m["argument_bytes"] + m["temp_bytes"]}


def run_cell(arch: str, shape_name: str, multi_pod: bool, out_dir: Path,
             n_micro: int, fsdp: bool, variant: str = "",
             tag: str = "") -> dict:
    """One cell: the step of ``shape_name``'s kind for ``arch`` on the
    production mesh, as rank :data:`DRY_RANK` (a pipeline cell: as the
    rank of each stage role on its pipe line), on meta tensors; returns
    the cell's record (``out_dir`` is where ``main`` writes it)."""
    from .. import configs
    from ..core import flops as F
    from ..models.config import SHAPES
    from ..models.sharding import ShardCtx
    from .mesh import make_production_mesh
    del out_dir
    cfg = configs.get(arch)
    var = PERF_VARIANTS.get(variant, {})
    if var.get("cfg"):
        cfg = cfg.replace(**var["cfg"])
    if "fsdp" in var:
        fsdp = var["fsdp"]
    shape = SHAPES[shape_name]
    mesh_name = "2x16x16" if multi_pod else "16x16"
    result: Dict[str, Any] = {"arch": arch, "shape": shape_name,
                              "mesh": mesh_name, "n_micro": n_micro,
                              "fsdp": fsdp, "tag": tag, "variant": variant}
    if shape_name == "long_500k" and not cfg.is_subquadratic:
        result["skipped"] = ("pure full-attention arch: 500k dense KV cache "
                             "excluded per assignment spec")
        return result
    mesh = make_production_mesh(multi_pod=multi_pod)
    dp = ("pod", "data") if multi_pod else ("data",)
    use_fsdp = fsdp and shape.kind == "train"
    ctx = ShardCtx(mesh=mesh, dp=dp, tp="model",
                   fsdp=("data",) if use_fsdp else ())
    step, args, kwargs, stored = _inputs(cfg, shape, ctx, mesh, var,
                                         n_micro)
    train = shape.kind == "train"
    tokens = shape.global_batch * (shape.seq_len if shape.kind != "decode"
                                   else 1)
    result["model_flops"] = F.model_flops(cfg, tokens, train=train)
    result["attn_flops"] = F.attention_flops(cfg, shape.seq_len, tokens,
                                             train=train)
    result.update({"n_devices": int(mesh.size),
                   "stored_bytes": _tree_bytes(stored), "card": CARD})
    if var.get("pp") and train:
        line = mesh.axis_ranks(PP_AXIS, DRY_RANK)
        result["stages"] = [
            dict(_rank_counts(measure(step, args, kwargs, rank=line[st]),
                              line[st]), stage=st)
            for st in sorted({0, 1, len(line) - 1})]
    else:
        result.update(_rank_counts(measure(step, args, kwargs), DRY_RANK))
    result.update(analyze(result))
    return result


def cell_path(out_dir: Path, arch: str, shape: str, mesh: str,
              tag: str = "") -> Path:
    suffix = f"-{tag}" if tag else ""
    return out_dir / f"{arch}__{shape}__{mesh}{suffix}.json"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch")
    ap.add_argument("--shape")
    ap.add_argument("--mesh", choices=["pod", "multipod", "both"],
                    default="pod")
    ap.add_argument("--out", default="build/dryrun")
    ap.add_argument("--n-micro", type=int, default=4)
    ap.add_argument("--no-fsdp", action="store_true")
    ap.add_argument("--tag", default="",
                    help="artifact suffix for perf variants")
    ap.add_argument("--variant", default="",
                    choices=[""] + list(PERF_VARIANTS),
                    help="named perf variant (see PERF_VARIANTS)")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--timeout", type=int, default=3600)
    args = ap.parse_args(argv)

    out_dir = Path(args.out)
    out_dir.mkdir(parents=True, exist_ok=True)

    if args.all:
        from .. import configs
        from ..models.config import SHAPES
        meshes = ["pod", "multipod"] if args.mesh == "both" else [args.mesh]
        cells = [(a, s, m) for a in configs.ARCHS for s in SHAPES
                 for m in meshes]
        failures = []
        for arch, shape, mesh in cells:
            path = cell_path(out_dir, arch, shape,
                             "2x16x16" if mesh == "multipod" else "16x16",
                             args.tag or args.variant)
            if path.exists() and not args.force:
                print("skip (cached):", path.name)
                continue
            cmd = [sys.executable, "-m", "repro_torch.launch.dryrun",
                   "--arch", arch, "--shape", shape, "--mesh", mesh,
                   "--out", str(out_dir), "--n-micro", str(args.n_micro)]
            if args.no_fsdp:
                cmd.append("--no-fsdp")
            if args.tag:
                cmd += ["--tag", args.tag]
            if args.variant:
                cmd += ["--variant", args.variant]
            print(">>>", " ".join(cmd[3:]), flush=True)
            try:
                r = subprocess.run(cmd, timeout=args.timeout)
                if r.returncode != 0:
                    failures.append((arch, shape, mesh, r.returncode))
            except subprocess.TimeoutExpired:
                failures.append((arch, shape, mesh, "timeout"))
        print("failures:", failures if failures else "none")
        return 1 if failures else 0

    if not (args.arch and args.shape):
        ap.error("--arch and --shape required (or --all)")
    multi = args.mesh == "multipod"
    mesh_name = "2x16x16" if multi else "16x16"
    if args.variant and not args.tag:
        args.tag = args.variant
    res = run_cell(args.arch, args.shape, multi, out_dir, args.n_micro,
                   fsdp=not args.no_fsdp, variant=args.variant, tag=args.tag)
    path = cell_path(out_dir, args.arch, args.shape, mesh_name, args.tag)
    path.write_text(json.dumps(res, indent=2))
    print(json.dumps({k: v for k, v in res.items()
                      if k not in ("collectives", "memory", "stages",
                                   "collectives_by_kind", "kernel_calls")},
                     indent=2))
    return 0


if __name__ == "__main__":
    sys.exit(main())
