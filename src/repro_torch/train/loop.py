"""Fault-tolerant training loop (the counterpart of ``repro.train.loop``).

* auto-resume: on start, restore the latest committed checkpoint and
  continue from its step (the data loader is step-indexed, so no sample is
  duplicated or skipped),
* periodic async checkpoints (atomic commit protocol in repro_torch.ckpt),
* preemption handling: SIGTERM (or an injected preemption) triggers a final
  synchronous checkpoint before ``PreemptionError`` — a restart resumes
  cleanly,
* straggler reports: per-step wall times are tracked; a step exceeding
  ``straggler_factor`` × the running median is recorded and passed to
  ``on_straggler``.

The loss of each step is read with ``.item()``, which waits for the step:
the step times are device times plus the host's share.
"""

from __future__ import annotations

import signal
import statistics
import time
from dataclasses import dataclass, field
from typing import Callable, Optional

from ..ckpt import CheckpointManager


class PreemptionError(RuntimeError):
    """Raised (or signalled) when the node is being reclaimed."""


@dataclass
class LoopConfig:
    total_steps: int
    ckpt_every: int = 50
    keep_ckpts: int = 3
    straggler_factor: float = 3.0


@dataclass
class LoopState:
    step: int = 0
    losses: list = field(default_factory=list)
    step_times: list = field(default_factory=list)
    resumed_from: Optional[int] = None
    stragglers: list = field(default_factory=list)
    preempted_at: Optional[int] = None


class TrainLoop:
    def __init__(self, train_step, params, opt_state, batch_fn,
                 ckpt_dir: str, cfg: LoopConfig,
                 on_straggler: Optional[Callable[[int, float], None]] = None,
                 inject_preemption_at: Optional[int] = None):
        """``batch_fn(step) -> batch``."""
        self.train_step = train_step
        self.params = params
        self.opt_state = opt_state
        self.batch_fn = batch_fn
        self.cfg = cfg
        self.mgr = CheckpointManager(ckpt_dir, keep=cfg.keep_ckpts)
        self.on_straggler = on_straggler
        self.inject_preemption_at = inject_preemption_at
        self.state = LoopState()
        self._preempt = False
        try:
            signal.signal(signal.SIGTERM, self._on_sigterm)
        except ValueError:
            pass  # not the main thread (tests)

    def _on_sigterm(self, *_):
        self._preempt = True

    # ------------------------------------------------------------------
    def try_resume(self) -> bool:
        target = {"params": self.params, "opt": self.opt_state}
        out = self.mgr.restore_latest(target)
        if out is None:
            return False
        step, tree, _ = out
        self.params = tree["params"]
        self.opt_state = tree["opt"]
        self.state.step = step
        self.state.resumed_from = step
        return True

    def _checkpoint(self, sync: bool = False):
        h = self.mgr.save(self.state.step,
                          {"params": self.params, "opt": self.opt_state},
                          extras={"losses_tail": self.state.losses[-5:]})
        if sync:
            h.wait()

    # ------------------------------------------------------------------
    def run(self) -> LoopState:
        self.try_resume()
        st = self.state
        while st.step < self.cfg.total_steps:
            if self._preempt or (self.inject_preemption_at is not None
                                 and st.step == self.inject_preemption_at
                                 and st.resumed_from is None):
                st.preempted_at = st.step
                self._checkpoint(sync=True)
                raise PreemptionError(f"preempted at step {st.step}")

            t0 = time.perf_counter()
            batch = self.batch_fn(st.step)
            self.params, self.opt_state, metrics = self.train_step(
                self.params, self.opt_state, batch)
            loss = float(metrics["loss"].item())
            dt = time.perf_counter() - t0

            st.losses.append(loss)
            st.step_times.append(dt)
            if len(st.step_times) >= 5:
                med = statistics.median(st.step_times[-50:])
                if dt > self.cfg.straggler_factor * med:
                    st.stragglers.append((st.step, dt))
                    if self.on_straggler:
                        self.on_straggler(st.step, dt)

            st.step += 1
            if st.step % self.cfg.ckpt_every == 0:
                self._checkpoint()
        self._checkpoint(sync=True)
        self.mgr.wait()
        return st
