"""Per-GPU memory: ground truth, the analytical baseline [20], and the
paper's MLP estimator (§VI).

Ground truth models what a Megatron-style framework actually allocates:
weights + optimizer state, 1F1B in-flight activations, logits workspace,
and the framework/library overheads ([21]) that the analytical baseline
misses — CUDA/runtime context, collective buffers, workspace, allocator
fragmentation, and a reproducible per-config residual.  The MLP estimator
is trained ONLY on configs using <= ``fit_nodes`` nodes (paper: 4 nodes /
32 GPUs) and must extrapolate to the full cluster.

Heterogeneous fleets: peak *usage* is tier-independent (the model shards
work, not hardware), so the estimator and its feature layout are untouched
by device tiers — only the capacity side moves.
``MemoryEstimator.fits_spec`` checks the prediction against each GPU's own
memory (the ``spec.mem_floor`` of the tier table), which is what the
search pipeline budgets against by default.
"""
from __future__ import annotations

import hashlib
from dataclasses import dataclass
from typing import Iterable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..models.config import ModelConfig
from . import flops as F
from .._device import DeviceLike, resolve_device
from .cluster import ClusterSpec
from .mlp import init_mlp, mlp_forward, pad_batch_rows, train_mlp
from .partition import Partition, uniform_partition
from .simulator import Conf, Workload, ring_kv_block_bytes


# ---------------------------------------------------------------------------
# ground truth (the "measured" per-GPU peak)
# ---------------------------------------------------------------------------

BYTES_PER_PARAM_STATE = 18.0       # bf16 param+grad, fp32 master+m+v


def _stage_params(cfg: ModelConfig, pp: int) -> float:
    total = F.param_count(cfg)
    embed = 2 * cfg.vocab_size * cfg.d_model
    body = (total - embed) / pp
    return body + embed / min(pp, 2)           # first/last stage holds embed


def _act_bytes_per_mb(cfg: ModelConfig, conf: Conf, seq: int) -> float:
    """In-flight activation bytes of one microbatch; context parallelism
    shards the sequence axis, shrinking activations by ``cp`` (exact no-op
    at ``cp == 1``)."""
    layers_stage = -(-cfg.n_layers // conf.pp)
    per_layer = seq * conf.bs_micro * (34 * cfg.d_model +
                                       5 * max(cfg.n_heads, 1) * seq)
    return layers_stage * per_layer / conf.tp / conf.cp


def _ring_kv_bytes(cfg: ModelConfig, conf: Conf, seq: int) -> float:
    """Ring-attention KV-exchange buffers (Fujii et al. 2411.06465): the
    local K+V block in bf16 (the same :func:`~repro_torch.core.simulator.
    ring_kv_block_bytes` message the latency model prices), double-buffered
    (in-flight recv + resident), per layer on the stage.  Exactly 0 when
    ``cp == 1``."""
    if conf.cp <= 1:
        return 0.0
    layers_stage = -(-cfg.n_layers // conf.pp)
    block = ring_kv_block_bytes(cfg, conf.bs_micro, seq, conf.cp)
    return 2.0 * layers_stage * block


def _config_residual(cfg: ModelConfig, conf: Conf, spec: ClusterSpec,
                     partition: Optional[Partition] = None) -> float:
    """Reproducible 'library variance' component, up to 0.6 GB.

    The hash key only grows ``|cp`` / ``|vpp`` / ``|part`` segments when
    those degrees are active, so every 3D uniform-split configuration
    keeps its historical residual bit-for-bit."""
    key = f"{cfg.name}|{conf.pp}|{conf.tp}|{conf.dp}|{conf.bs_micro}|{spec.name}"
    if conf.cp > 1:
        key += f"|cp{conf.cp}"
    if conf.vpp > 1:
        key += f"|vpp{conf.vpp}"
    if partition is not None:
        key += f"|part{','.join(str(b) for b in partition.boundaries)}"
    h = int(hashlib.sha1(key.encode()).hexdigest()[:8], 16)
    return (h % 1000) / 1000.0 * 0.6e9


def _stage_param_array(cfg: ModelConfig, part: Partition, pp: int,
                       vpp: int) -> np.ndarray:
    """Per-physical-stage resident parameter counts under a chunk
    partition: stage ``x`` hosts chunks ``x, x + pp, ...`` plus the
    weight-tied hybrid shared block (once, if any hosted layer applies
    it), the embedding on stage 0, and the LM head + final norm on the
    last stage."""
    chunk_params = part.stage_sums(F.layer_param_counts(cfg))
    stage_params = chunk_params.reshape(vpp, pp).sum(axis=0)
    sb = float(F.shared_block_params(cfg))
    if sb:
        mask = F.attention_layer_mask(cfg).astype(np.float64)
        has = (part.stage_sums(mask) > 0).reshape(vpp, pp).any(axis=0)
        stage_params = stage_params + has * sb
    embed = float(cfg.vocab_size * cfg.d_model)
    stage_params[0] += embed
    stage_params[pp - 1] += embed + cfg.d_model    # LM head + final norm
    return stage_params


def _layer_act_bytes(cfg: ModelConfig, seq: int, bs_micro: int) -> np.ndarray:
    """Per-layer in-flight activation bytes of one microbatch: the
    ``34 * d`` residual/MLP term on every layer, the ``5 * heads * seq``
    score workspace only on layers that compute attention."""
    per = np.full(cfg.n_layers, 34.0 * cfg.d_model)
    per = per + F.attention_layer_mask(cfg) * \
        (5.0 * max(cfg.n_heads, 1) * seq)
    return seq * bs_micro * per


def _ground_truth_nonuniform(w: Workload, conf: Conf, spec: ClusterSpec,
                             partition: Optional[Partition]) -> float:
    """Worst-stage peak bytes under a non-uniform partition and/or
    interleaved-1F1B.  Per stage: resident weights from the true layer
    assignment, in-flight activations with the per-chunk interleaved
    multiplicity (chunk ``v`` of a stage keeps ``min(pp*vpp - v*pp - x,
    n_mb)`` microbatches alive); the worst stage's total is the number
    the capacity prune must respect."""
    cfg = w.cfg
    pp, vpp = conf.pp, conf.vpp
    n_chunks = pp * vpp
    part = partition if partition is not None \
        else uniform_partition(cfg.n_layers, n_chunks)
    weights_x = _stage_param_array(cfg, part, pp, vpp) / conf.tp \
        * BYTES_PER_PARAM_STATE
    chunk_act = part.stage_sums(_layer_act_bytes(cfg, w.seq, conf.bs_micro)) \
        / conf.tp / conf.cp
    v = np.arange(vpp)[:, None]
    x = np.arange(pp)[None, :]
    inflight = np.minimum(n_chunks - (v * pp + x), conf.n_mb)
    acts_x = (chunk_act.reshape(vpp, pp) * inflight).sum(axis=0)
    wa = float((weights_x + acts_x).max())

    sizes = np.asarray(part.sizes).reshape(vpp, pp).sum(axis=0)
    layers_stage = int(sizes.max())
    ring_kv = 0.0
    if conf.cp > 1:
        block = ring_kv_block_bytes(cfg, conf.bs_micro, w.seq, conf.cp)
        ring_kv = 2.0 * layers_stage * block
    logits = conf.bs_micro * w.seq * cfg.vocab_size * 4.0 * 2 \
        / conf.tp / conf.cp
    framework = (1.1e9                                  # runtime context
                 + 0.15e9                               # collective buffers
                 + 8e6 * (conf.tp + conf.pp)            # per-communicator
                 + 8e6 * (conf.cp - 1)                  # cp ring communicator
                 + 8e6 * (conf.vpp - 1)                 # per-chunk buffers
                 + 24e6 * np.log2(conf.dp + 1)          # ring channels
                 + 0.45e9)                              # kernel workspace
    frag = 0.06 * wa
    residual = _config_residual(cfg, conf, spec, partition)
    return wa + ring_kv + logits + framework + frag + residual


def ground_truth_memory(w: Workload, conf: Conf, spec: ClusterSpec,
                        partition: Optional[Partition] = None) -> float:
    """'Measured' peak bytes per GPU for this configuration.

    With a non-uniform ``partition`` (or ``conf.vpp > 1``) the peak is the
    *worst stage's* (:func:`_ground_truth_nonuniform`); the default is the
    bit-exact legacy uniform-split model."""
    if partition is not None or conf.vpp > 1:
        return _ground_truth_nonuniform(w, conf, spec, partition)
    cfg = w.cfg
    weights = _stage_params(cfg, conf.pp) / conf.tp * BYTES_PER_PARAM_STATE
    inflight = min(conf.pp, conf.n_mb)
    acts = _act_bytes_per_mb(cfg, conf, w.seq) * inflight
    ring_kv = _ring_kv_bytes(cfg, conf, w.seq)
    logits = conf.bs_micro * w.seq * cfg.vocab_size * 4.0 * 2 \
        / conf.tp / conf.cp
    framework = (1.1e9                                  # runtime context
                 + 0.15e9                               # collective buffers
                 + 8e6 * (conf.tp + conf.pp)            # per-communicator
                 + 8e6 * (conf.cp - 1)                  # cp ring communicator
                 + 24e6 * np.log2(conf.dp + 1)          # ring channels
                 + 0.45e9)                              # kernel workspace
    frag = 0.06 * (weights + acts)
    residual = _config_residual(cfg, conf, spec)
    return weights + acts + ring_kv + logits + framework + frag + residual


def rank_state_bytes(cfg: ModelConfig, conf: Conf,
                     partition: Optional[Partition] = None) -> np.ndarray:
    """Per-GPU resident parameter + optimizer-state bytes, by pipeline stage.

    Entry ``x`` is what one GPU serving physical stage ``x`` holds on disk
    and in HBM across restarts: its chunk layers' parameters (interleaved
    stages host chunks ``x, x + pp, ...``), the embedding / LM-head /
    shared-block extras, divided by ``tp`` (tensor parallelism shards every
    weight) and multiplied by :data:`BYTES_PER_PARAM_STATE` (bf16
    param+grad plus fp32 master/m/v).  dp and cp *replicate* this state, so
    the number is per-GPU regardless of those degrees — it is the shard a
    migrated rank must fetch when a re-plan changes its stage or tp slice
    (the migration-cost model in :mod:`~repro_torch.core.migration`).

    Args:
        cfg: model configuration.
        conf: parallelism configuration.
        partition: non-uniform chunk partition (``None`` = the uniform
            ceil-first split).

    Returns:
        ``(pp,)`` float64 array of bytes per GPU.
    """
    part = partition if partition is not None \
        else uniform_partition(cfg.n_layers, conf.pp * conf.vpp)
    stage_params = _stage_param_array(cfg, part, conf.pp, conf.vpp)
    return stage_params / conf.tp * BYTES_PER_PARAM_STATE


def analytical_estimate(w: Workload, conf: Conf) -> float:
    """The baseline estimator [20]: weights + one microbatch of activations.

    It ignores 1F1B in-flight multiplicity, logits workspace and every
    framework/library overhead — which is why it underestimates badly
    (paper Fig. 7: 59-66% MAPE)."""
    cfg = w.cfg
    weights = _stage_params(cfg, conf.pp) / conf.tp * BYTES_PER_PARAM_STATE
    acts = _act_bytes_per_mb(cfg, conf, w.seq)
    return weights + acts


# ---------------------------------------------------------------------------
# MLP estimator (Eq. 7)
# ---------------------------------------------------------------------------

def _features(cfg: ModelConfig, conf: Conf, *,
              with_cp: bool = False) -> np.ndarray:
    return _features_batch(cfg, [conf], with_cp=with_cp)[0]


def _features_batch(cfg: ModelConfig, confs: Sequence[Conf], *,
                    with_cp: bool = False) -> np.ndarray:
    """Feature matrix for many configurations in one shot.

    The single source of the feature order; the scalar :func:`_features` is
    its one-row special case (bit-for-bit — same elementwise ``np.log``
    over float64).  ``with_cp`` appends an 11th ``log(cp)`` column —
    estimators fit on the 3D space (``with_cp=False``, the default) keep
    the historical 10-column layout and therefore reproduce their
    predictions exactly.

    Args:
        cfg: model configuration (shared by all rows).
        confs: parallelism configurations.
        with_cp: include the context-parallel degree as a feature.

    Returns:
        ``(len(confs), 10 or 11)`` float64 array.
    """
    v = np.asarray(
        [[c.n_gpus, cfg.n_layers, cfg.d_model, max(cfg.n_heads, 1),
          c.tp, c.pp, c.dp, c.bs_micro, c.bs_mini, c.bs_global]
         + ([c.cp] if with_cp else [])
         for c in confs], np.float64)
    return np.log(v)


@dataclass
class MemoryEstimator:
    """MLP(n_gpus, n_layers, n_hidden, n_heads, tp, pp, dp, bs_micro,
    bs_mini, bs_global) -> peak bytes, with a soft safety margin.

    ``residual=True`` is a beyond-paper variant: the MLP learns
    log(actual / analytical) instead of log(actual), anchoring the
    extrapolation to the analytical power-law structure (EXPERIMENTS.md
    §Fig7 reports both)."""
    params: list
    x_mean: np.ndarray
    x_std: np.ndarray
    y_mean: float
    y_std: float
    soft_margin: float = 0.92
    residual: bool = False
    workload_seq: int = 2048
    # 4D support: True when the fit included the log(cp) feature column.
    with_cp: bool = False
    # Fit provenance (0 = unknown/legacy) — lets runtime.elastic.replan
    # detect that the cluster it is re-planning for no longer matches the
    # hardware this estimator was fit on.
    fit_gpu_mem: float = 0.0
    fit_gpus_per_node: int = 0

    def _params_on(self, dev: torch.device) -> list:
        """The parameter tensors on ``dev`` (ten small tensors; moved per
        call rather than cached, so ``params`` stays the one copy)."""
        return [{k: torch.as_tensor(t, dtype=torch.float32).to(dev)
                 for k, t in layer.items()} for layer in self.params]

    def predict_batch(self, cfg: ModelConfig, confs: Sequence[Conf], *,
                      device: DeviceLike = None) -> np.ndarray:
        """Predicted peak bytes/GPU for many configurations at once.

        One :func:`~repro_torch.core.mlp.mlp_forward` call on the whole
        ``(N, F)`` feature matrix, zero-padded to a power-of-two row bucket.
        The scalar :meth:`predict` is literally the padded one-row case of
        this path, so the two cannot drift apart.

        Args:
            cfg: model configuration shared by every candidate.
            confs: parallelism configurations to score.
            device: where the forward runs; ``None`` is the CUDA device and
                raises without one.

        Returns:
            ``(len(confs),)`` float64 array of predicted peak bytes/GPU.
        """
        dev = resolve_device(device)
        if not len(confs):
            return np.zeros(0)
        if not self.with_cp and any(c.cp > 1 for c in confs):
            raise ValueError(
                "estimator was fit on the 3D (cp=1) feature space but got a "
                "cp>1 configuration; refit with fit_memory_estimator("
                "max_cp=...) to score 4D candidates")
        x = (_features_batch(cfg, confs, with_cp=self.with_cp)
             - self.x_mean) / self.x_std
        xb = pad_batch_rows(x.astype(np.float32))
        with torch.no_grad():
            out = mlp_forward(self._params_on(dev),
                              torch.as_tensor(xb, device=dev))
        y = out[:len(confs), 0].cpu().numpy().astype(np.float64)
        pred = np.exp(y * self.y_std + self.y_mean)
        if self.residual:
            pred = pred * np.asarray(
                [analytical_estimate(Workload(cfg, self.workload_seq,
                                              c.bs_global), c)
                 for c in confs])
        return pred

    def predict(self, cfg: ModelConfig, conf: Conf, *,
                device: DeviceLike = None) -> float:
        """Scalar API, re-expressed over :meth:`predict_batch`."""
        return float(self.predict_batch(cfg, [conf], device=device)[0])

    def fits(self, cfg: ModelConfig, conf: Conf, mem_limit: float, *,
             device: DeviceLike = None) -> bool:
        return (self.predict(cfg, conf, device=device)
                <= mem_limit * self.soft_margin)

    def fits_spec(self, cfg: ModelConfig, conf: Conf, spec: ClusterSpec, *,
                  device: DeviceLike = None) -> bool:
        """Capacity check against every GPU's *own* memory.

        Pipette's 1:1 dedication places a worker on every GPU, and the
        predicted peak is a worst-GPU number — so "each GPU's capacity"
        collapses to the tightest device tier (``spec.mem_floor``, which is
        exactly ``gpu_mem`` on homogeneous specs).  This is the check the
        search pipeline applies by default on tiered clusters."""
        return self.fits(cfg, conf, spec.mem_floor, device=device)


def enumerate_confs(n_gpus: int, bs_global: int, *, max_tp: int = 0,
                    n_layers: int = 10 ** 9, max_cp: int = 1, seq: int = 0,
                    max_vpp: int = 1, strict: bool = True) -> List[Conf]:
    """All valid (pp, tp, cp, dp, bs_micro) with ``pp*tp*cp*dp == n_gpus``.

    With the default ``max_cp=1`` the context-parallel axis collapses and
    the enumeration order is the historical 3D one.  ``strict`` (default)
    drops configurations the memory-efficient 1F1B schedule cannot fill
    (``n_mb < pp``): the pipeline would idle below depth and the Eq. 3-6
    exposure count ``n_mb / pp`` goes sub-1, silently mis-scoring them
    (Megatron-LM's schedule-validity constraint).  Pass ``strict=False``
    to reproduce the unfiltered space (ablations / legacy comparisons).

    Args:
        n_gpus: total GPU count to factorize.
        bs_global: global batch size (dp must divide it; every divisor of
            the minibatch becomes a microbatch candidate).
        max_tp: optional upper bound on tensor parallelism (0 = unbounded).
        n_layers: pp may not exceed the layer count.
        max_cp: upper bound on context parallelism (1 = 3D space).
        seq: sequence length; required for ``max_cp > 1`` (ring attention
            needs ``seq % cp == 0``), ignored otherwise.
        max_vpp: upper bound on the interleaved-1F1B virtual-pipeline
            factor.  The default (1) emits only plain-1F1B configurations
            in the historical order; larger values append, right after
            each base configuration, its ``vpp`` variants that satisfy
            Megatron's interleaving constraints (``pp > 1``,
            ``n_mb % pp == 0``, ``n_layers >= pp * vpp``).
        strict: filter schedule-invalid ``n_mb < pp`` configurations.

    Returns:
        List of :class:`~repro_torch.core.simulator.Conf`; every entry satisfies
        ``conf.valid()`` and, under ``strict``, ``conf.schedulable()``.
    """
    out = []
    for pp in range(1, n_gpus + 1):
        if n_gpus % pp or pp > n_layers:
            continue
        rest = n_gpus // pp
        for tp in range(1, rest + 1):
            if rest % tp or (max_tp and tp > max_tp):
                continue
            rest_cd = rest // tp
            for cp in range(1, min(max_cp, rest_cd) + 1):
                if rest_cd % cp:
                    continue
                if cp > 1 and (seq <= 0 or seq % cp):
                    continue
                dp = rest_cd // cp
                if bs_global % dp:
                    continue
                bs_mini = bs_global // dp
                for mb in range(1, bs_mini + 1):
                    if bs_mini % mb:
                        continue
                    conf = Conf(pp, tp, dp, mb, bs_global, cp=cp)
                    if strict and conf.n_mb < pp:
                        continue
                    out.append(conf)
                    for vpp in range(2, max_vpp + 1):
                        if pp <= 1 or pp * vpp > n_layers:
                            continue
                        cv = Conf(pp, tp, dp, mb, bs_global, cp=cp, vpp=vpp)
                        if not cv.schedulable():
                            continue
                        out.append(cv)
    return out


def profile_memory_dataset(workloads: Sequence[Workload], spec: ClusterSpec,
                           *, fit_nodes: int = 4,
                           max_cp: int = 1) -> Tuple[np.ndarray, np.ndarray, list]:
    """Profiled (features, log-bytes) pairs from configs on <= fit_nodes.

    ``max_cp > 1`` extends the profiled space to 4D (and switches the
    feature layout to the 11-column ``with_cp`` variant).

    Profiling deliberately uses ``strict=False``: peak memory is
    well-defined for any allocatable configuration (the profiler runs a
    single microbatch, not a full 1F1B iteration), and the extra ``n_mb <
    pp`` points anchor the fit exactly where the batch-size features are
    most extreme.  Only the *search* applies the schedule-validity gate."""
    xs, ys, meta = [], [], []
    with_cp = max_cp > 1
    for w in workloads:
        for g_nodes in range(1, fit_nodes + 1):
            g = g_nodes * spec.gpus_per_node
            for conf in enumerate_confs(g, w.bs_global,
                                        max_tp=spec.gpus_per_node,
                                        n_layers=w.cfg.n_layers,
                                        max_cp=max_cp, seq=w.seq,
                                        strict=False):
                if conf.bs_micro > 16:
                    continue
                xs.append(_features(w.cfg, conf, with_cp=with_cp))
                ys.append(np.log(ground_truth_memory(w, conf, spec)))
                meta.append((w, conf))
    return np.asarray(xs), np.asarray(ys), meta


def fit_memory_estimator(workloads: Sequence[Workload], spec: ClusterSpec, *,
                         fit_nodes: int = 4, steps: int = 20_000,
                         hidden: int = 200, depth: int = 5,
                         seed: int = 0, residual: bool = False,
                         max_cp: int = 1,
                         device: DeviceLike = None) -> MemoryEstimator:
    """Train the §VI MLP memory estimator on small-scale profiles.

    Args:
        workloads: workloads to profile (configs on <= ``fit_nodes`` nodes).
        spec: cluster description.
        fit_nodes: profiling budget in nodes (paper: 4 nodes / 32 GPUs);
            the estimator must extrapolate beyond it.
        steps / hidden / depth: MLP training schedule and architecture
            (paper: 5 layers x 200 hidden units).
        seed: init/training seed.
        residual: beyond-paper variant — learn log(actual / analytical)
            instead of log(actual), anchoring extrapolation.
        max_cp: profile the 4D space up to this context-parallel degree and
            include the log(cp) feature.  The default (1) reproduces the 3D
            estimator; such an estimator refuses cp>1 queries.
        device: where the fit runs; ``None`` is the CUDA device and raises
            without one.  The initial weights are drawn on the host from
            ``seed``, so they do not depend on the device.

    Returns:
        Fitted :class:`MemoryEstimator`.
    """
    dev = resolve_device(device)
    x, y, meta = profile_memory_dataset(workloads, spec, fit_nodes=fit_nodes,
                                        max_cp=max_cp)
    if residual:
        base = np.array([np.log(analytical_estimate(w, c)) for w, c in meta])
        y = y - base
    xm, xs = x.mean(0), x.std(0) + 1e-9
    ym, ys = y.mean(), y.std() + 1e-9
    xn = ((x - xm) / xs).astype(np.float32)
    yn = ((y - ym) / ys).astype(np.float32)
    sizes = [x.shape[1]] + [hidden] * (depth - 1) + [1]
    gen = torch.Generator(device="cpu").manual_seed(seed)
    params = init_mlp(gen, sizes, device=dev)
    params = train_mlp(params, torch.as_tensor(xn, device=dev),
                       torch.as_tensor(yn, device=dev), steps=steps)
    params = [{k: t.cpu() for k, t in layer.items()} for layer in params]
    return MemoryEstimator(params, xm, xs, float(ym), float(ys),
                           residual=residual,
                           workload_seq=workloads[0].seq,
                           with_cp=max_cp > 1,
                           fit_gpu_mem=spec.gpu_mem,
                           fit_gpus_per_node=spec.gpus_per_node)


def mape(pred: Iterable[float], true: Iterable[float]) -> float:
    """Mean absolute percentage error (%), the paper's estimator metric."""
    p = np.asarray(list(pred), float)
    t = np.asarray(list(true), float)
    return float(np.mean(np.abs(p - t) / t) * 100.0)
