"""Pipette core: the paper's automatic fine-grained parallel-training
configurator — latency estimator (Eq. 3-6), MLP memory estimator (§VI),
SA worker dedication (§IV), Algorithm 1 search, the discrete-event cluster
simulator used as the real-cluster stand-in, and the AMP/Varuna/Megatron
baselines.

The search space is 4D: (pp, tp, cp, dp) with context parallelism (ring
attention over sequence shards) as the fourth axis via
``SearchSpace(max_cp=...)``; ``cp == 1`` reproduces the paper's 3D setting
bit-for-bit, and the baselines deliberately stay 3D.

Clusters may be heterogeneous in *compute* as well as interconnect:
``ClusterSpec`` carries an optional per-node :class:`~repro_torch.core.cluster.
DeviceTier` table (``mixed_fleet_spec`` / ``degraded_host_spec`` build
seeded mixed-generation and degraded-host fleets), priced per pipeline
stage by the slowest member GPU throughout the model, engine, and
simulator.  Homogeneous specs keep the historical scalars bit-for-bit,
and the baselines additionally stay compute-blind.

Pipeline stages may carry non-uniform layer counts: ``partition.py``
solves a balanced min-max dynamic program over per-layer cost vectors
(``SearchSpace(partition="dp")``), and interleaved-1F1B virtual-pipeline
scheduling opens via ``SearchSpace(max_vpp=...)``; the uniform split with
plain 1F1B (``Conf.vpp == 1``, ``Profile.partition is None``) reproduces
the historical estimates bit-for-bit.

The public entry point is the Planner API (``plan.py``):
``Planner(strategy, device=...).plan(PlanRequest(...), bw)`` returns a
serializable :class:`~repro_torch.core.plan.Plan` artifact; the legacy
``configure()`` kwarg pile remains as a shim over
``Planner(PipetteStrategy())``.  The SA dedication stage and the memory
estimator run on the CUDA device (``device=None``); the CPU must be asked
for by name."""

from .cluster import (ClusterSpec, DeviceTier, HIGH_END, MID_RANGE,
                      MID_RANGE_DEGRADED, MIXED_A100_V100, TPU_POD,
                      compute_slowdowns, degraded_host_spec,
                      min_group_bw, min_group_bw_batch, mixed_fleet_spec,
                      profile_bandwidth, tier_fingerprint,
                      true_bandwidth_matrix)
from .partition import (PARTITION_MODES, SCHEDULES, Partition,
                        PartitionCache, balanced_partition, make_partition,
                        resolve_partition, uniform_partition)
from .simulator import (Conf, Profile, ProfileCache, Workload, build_profile,
                        default_mapping, dp_allreduce_times,
                        dp_allreduce_times_ref, measure)
from .latency import (amp_latency, default_mapping_latencies, pipette_latency,
                      pipette_latency_ref, varuna_latency)
from .memory import (MemoryEstimator, analytical_estimate, enumerate_confs,
                     fit_memory_estimator, ground_truth_memory, mape,
                     rank_state_bytes)
from .dedication import (DedicationEngine, GroupIndex, PairCache, SAResult,
                         anneal, anneal_multistart, mapping_to_perm,
                         perm_to_mapping, project_perm)
from .migration import (DEFAULT_RESTART_S, PlanDiff, diff_assignments,
                        resolve_model, state_keys)
from .torch_engine import TorchDedicationEngine, np_pairwise_sum
from .annealing import (MovePlan, build_islands, coarse_assign,
                        coarse_orderings, dedicate_candidates,
                        make_move_plan)
from .search import (BatchSearchContext, Candidate, Overhead, SearchResult,
                     configure, run_search)
from .baselines import amp_configure, mlm_configure, varuna_configure
from .plan import (STRATEGIES, AMPStrategy, Budget, ExhaustiveStrategy,
                   MegatronStrategy, Plan, PlanLoadError, Planner,
                   PlanRequest, PipetteStrategy, Provenance, SearchSpace,
                   Strategy, VarunaStrategy, bw_fingerprint)
