"""Fault-tolerant training loop.

A copy of the JAX package's ``runtime/trainer.py`` (host code) over the
port's :class:`~repro_torch.checkpoint.manager.CheckpointManager` and
:class:`~repro_torch.core.plan.Plan`.  The step function it drives is the
port's (``launch/steps.py::make_train_step``); checkpoints restore onto the
devices of the state the run was started with.  One change: ``run`` waits
for a checkpoint still being written when it leaves by an exception too, so
that a restart in the same process (an injected failure) resumes from it.

Production behaviours, exercised by the integration tests:
  * auto-resume from the latest checkpoint (bitwise-deterministic restart:
    the data pipeline is stateless-addressable by step);
  * periodic async checkpoints with keep-k retention;
  * straggler watchdog — EWMA step-time monitor that fires a callback
    (on a real cluster: re-profile links + re-run Pipette's worker
    dedication; here the hook is injectable for tests);
  * failure injection for tests (raise mid-run, restart, verify losses
    continue bitwise);
  * elastic re-plan — on device-count change, ask Pipette for a new Plan
    and reshard the checkpoint (runtime/elastic.py);
  * plan provenance — a :class:`~repro.core.plan.Plan` handed to the loop
    is persisted as ``plan.json`` next to the checkpoints, so a restarted
    (or post-mortem'd) run knows exactly which configuration, worker
    dedication, strategy, and bandwidth snapshot it was launched under.
"""
from __future__ import annotations

import json
import os
import time
from dataclasses import dataclass, field
from typing import TYPE_CHECKING, Callable, Optional

from ..checkpoint.manager import CheckpointManager

if TYPE_CHECKING:                              # pragma: no cover
    from ..core.plan import Plan


@dataclass
class StragglerWatchdog:
    """EWMA step-time monitor.  trigger() fires when a step exceeds
    ``threshold`` x the EWMA — the Pipette-re-dedication hook."""
    alpha: float = 0.1
    threshold: float = 2.0
    warmup_steps: int = 5
    on_straggler: Optional[Callable[[int, float, float], None]] = None
    _ewma: float = field(default=0.0, init=False)
    _n: int = field(default=0, init=False)
    events: list = field(default_factory=list)

    def observe(self, step: int, dt: float) -> bool:
        self._n += 1
        if self._n <= self.warmup_steps:
            self._ewma = dt if self._ewma == 0 else \
                (1 - self.alpha) * self._ewma + self.alpha * dt
            return False
        fired = dt > self.threshold * self._ewma
        if fired:
            self.events.append((step, dt, self._ewma))
            if self.on_straggler:
                self.on_straggler(step, dt, self._ewma)
        else:
            self._ewma = (1 - self.alpha) * self._ewma + self.alpha * dt
        return fired


@dataclass
class TrainLoopConfig:
    total_steps: int
    ckpt_every: int = 50
    ckpt_dir: str = "checkpoints"
    keep: int = 3
    log_every: int = 10
    metrics_path: Optional[str] = None
    #: save after the last step too, whatever ``ckpt_every`` says (the
    #: reference always does); False keeps only the ``ckpt_every`` saves
    save_final: bool = True


class TrainLoop:
    def __init__(self, cfg: TrainLoopConfig, step_fn, loader,
                 watchdog: Optional[StragglerWatchdog] = None,
                 fail_at_step: Optional[int] = None,
                 plan: Optional["Plan"] = None):
        """step_fn(params, opt_state, batch) -> (params, opt_state, metrics)

        ``plan``: the serialized configurator decision this run executes
        (from ``Planner.plan`` or ``Plan.load``).  Persisted to
        ``<ckpt_dir>/plan.json`` on ``run()`` so restarts and audits see
        the same artifact the launcher consumed."""
        self.cfg = cfg
        self.step_fn = step_fn
        self.loader = loader
        self.watchdog = watchdog or StragglerWatchdog()
        self.ckpt = CheckpointManager(cfg.ckpt_dir, keep=cfg.keep)
        self.fail_at_step = fail_at_step
        self.plan = plan
        self.history: list = []

    def plan_path(self) -> str:
        return os.path.join(str(self.cfg.ckpt_dir), "plan.json")

    def run(self, params, opt_state, *, resume: bool = True):
        if self.plan is not None:
            os.makedirs(str(self.cfg.ckpt_dir), exist_ok=True)
            self.plan.save(self.plan_path())
        start = 0
        if resume:
            latest = self.ckpt.latest_step()
            if latest is not None:
                (params, opt_state), _ = self.ckpt.restore((params, opt_state),
                                                           latest)
                start = latest
        metrics_file = (open(self.cfg.metrics_path, "a")
                        if self.cfg.metrics_path else None)
        try:
            for step in range(start, self.cfg.total_steps):
                if self.fail_at_step is not None and step == self.fail_at_step:
                    self.fail_at_step = None
                    raise RuntimeError(f"injected failure at step {step}")
                batch = self.loader.batch_at(step)
                t0 = time.perf_counter()
                params, opt_state, metrics = self.step_fn(params, opt_state,
                                                          batch)
                loss = float(metrics["loss"])
                dt = time.perf_counter() - t0
                self.watchdog.observe(step, dt)
                rec = {"step": step, "loss": loss, "dt": round(dt, 4)}
                self.history.append(rec)
                if metrics_file and step % self.cfg.log_every == 0:
                    metrics_file.write(json.dumps(rec) + "\n")
                    metrics_file.flush()
                if (step + 1) % self.cfg.ckpt_every == 0 or (
                        self.cfg.save_final
                        and (step + 1) == self.cfg.total_steps):
                    self.ckpt.save(step + 1, (params, opt_state))
            return params, opt_state
        finally:
            # a save still being written completes, on failure too, so a
            # restart in this process finds it (the reference waits only
            # after the last step)
            self.ckpt.wait()
            if metrics_file:
                metrics_file.close()
