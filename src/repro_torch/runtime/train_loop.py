"""Fault-tolerant training loop: the counterpart of
``repro.runtime.train_loop``.

Recovery model:
  * checkpoint every ``ckpt_every`` steps (async, atomic, retained; the
    state is copied to host memory before the next step changes it);
  * on (re)start, auto-resume from the latest complete checkpoint; the
    synthetic data pipeline is step-indexed, so data continues exactly
    where the restored step left off;
  * transient step failures (injected in tests via ``failure_hook``)
    trigger restore-from-checkpoint and replay instead of a crash —
    ``max_restarts`` bounds the retry budget.  The restore first lets the
    queued writes finish, so it starts from the newest checkpoint the
    loop asked for, however slow the disk;
  * a straggler monitor flags slow steps.  The ``float(v)`` read of a
    step's metrics is its one host sync, so the monitor's host clock
    covers the step's device work.

Restores write the checkpoint into the caller's parameters and optimizer
state in place.
"""

from __future__ import annotations

import dataclasses
import logging
from typing import Any, Callable, Dict, Optional

import numpy as np

from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.runtime.straggler import StragglerMonitor

log = logging.getLogger("repro_torch.train")


@dataclasses.dataclass
class TrainLoopConfig:
    total_steps: int = 100
    ckpt_every: int = 25
    ckpt_dir: str = "checkpoints"
    keep: int = 3
    log_every: int = 10
    max_restarts: int = 3
    async_ckpt: bool = True


class StepFailure(RuntimeError):
    """Raised by failure hooks to simulate a node fault."""


def fit(
    train_step: Callable,           # (params, opt, batch) -> (p, o, metrics)
    params: Any,
    opt_state: Any,
    batch_at: Callable[[int], Dict[str, np.ndarray]],
    cfg: TrainLoopConfig,
    failure_hook: Optional[Callable[[int], None]] = None,
    monitor: Optional[StragglerMonitor] = None,
    manager: Optional[CheckpointManager] = None,
) -> Dict[str, Any]:
    """Run to cfg.total_steps with checkpoint/restart fault tolerance.
    ``manager`` replaces the one built from ``cfg`` (the caller then
    closes it); the returned dict is JAX's: state, steps, losses,
    restarts, straggler_events."""
    own = manager is None
    mgr = manager or CheckpointManager(cfg.ckpt_dir, keep=cfg.keep,
                                       async_write=cfg.async_ckpt)
    monitor = monitor or StragglerMonitor()

    state = {"params": params, "opt": opt_state}
    start_step = 0
    restored = mgr.restore_latest(state)
    if restored is not None:
        start_step, state, meta = restored
        log.info("resumed from step %d", start_step)

    step = start_step
    restarts = 0
    losses = []
    while step < cfg.total_steps:
        try:
            batch = batch_at(step)
            if failure_hook is not None:
                failure_hook(step)
            monitor.start()
            state["params"], state["opt"], metrics = train_step(
                state["params"], state["opt"], batch)
            metrics = {k: float(v) for k, v in metrics.items()}
            monitor.stop(step)
            losses.append(metrics["loss"])
            step += 1
            if step % cfg.log_every == 0:
                log.info("step %d loss %.4f", step, metrics["loss"])
            if step % cfg.ckpt_every == 0 or step == cfg.total_steps:
                mgr.save(step, state, meta={"loss": metrics["loss"]},
                         block=not cfg.async_ckpt)
        except StepFailure as e:
            restarts += 1
            log.warning("step %d failed (%s); restart %d/%d", step, e,
                        restarts, cfg.max_restarts)
            if restarts > cfg.max_restarts:
                raise
            mgr.wait()            # resume from the newest requested save
            restored = mgr.restore_latest(state)
            if restored is None:
                step = 0          # no checkpoint yet: replay from scratch
            else:
                step, state, _ = restored
    # final synchronous checkpoint so restarts after completion are clean
    mgr.save(step, state, block=True)
    if own:
        mgr.close()
    return {"state": state, "steps": step, "losses": losses,
            "restarts": restarts, "straggler_events": monitor.events}
