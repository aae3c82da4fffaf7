"""Tick watchdog: per-tick deadline, retry-with-backoff, degradation ladder.

Reuses the fault-supervision policy object
(:class:`repro_torch.telemetry.pipeline.FaultTolerance`) around a whole
tick: when the search attempt fails or blows its deadline, this module
walks a degradation ladder:

1. the configured backend, warm-started from the previous frontier;
2. ``torch`` → ``numpy`` (skipped when the controller already runs numpy);
3. warm → cold (no ``init_frontier`` — a poisoned warm seed or a
   divergent refinement cannot wedge the loop);
4. ladder exhausted → the caller serves its **stale knee, flagged**
   (``TickResult.result == "stale"``) and leaves the watermark where it
   was, so the data stays pending and the operator sees staleness grow
   instead of a crash loop.

The ladder exists to survive *poisoned data* (a clock-skewed shard, a
store the run-level IR cannot carry), not a broken device. A device rung
(any backend but ``numpy``) therefore descends only on
:data:`HOST_DATA_ERRORS`, which the host raises over the store's data:
while the run-level IR is acquired, before anything is packed for the
card, or on the row path the torch backend routes the IR's refusals to. Every other error
of a device rung propagates out of :meth:`TickSupervisor.run`: a kernel
that does not build or launch (:class:`~repro_torch.kernels.KernelError`),
a wrapper's guard (``ValueError``), a CUDA or cuBLAS error, out of memory.
So does a deadline miss on a device rung (:class:`DeviceDeadlineError`),
since the abandoned attempt may still be running on the card. The host
rungs descend on any ``Exception`` but :data:`DEVICE_ERRORS`. The JAX
package's supervisor descends on any exception on every rung, its device
rung included; this is the port's one divergence from it.

Every rung transition is counted via :func:`repro_torch.obs.fallback`
(``repro_fallbacks_total{from=..., to=..., reason=...}``); same-rung
retries count ``repro_live_tick_retries_total`` and abandoned attempts
``repro_live_deadline_misses_total``.

``FaultTolerance.timeout_s`` is the wall-clock budget for the *whole*
ladder walk. When set, each attempt runs on a daemon worker thread and is
abandoned — not killed; Python cannot — once the remaining budget is
spent; the abandoned attempt's result is discarded even if it eventually
finishes. ``timeout_s=None`` (the default) runs attempts inline with zero
threading overhead.
"""
from __future__ import annotations

import dataclasses
import threading
import time
from typing import Callable, Sequence

import torch

import repro_torch.obs as obs
from repro_torch.kernels._build import KernelError
from repro_torch.telemetry.pipeline import FaultTolerance
from repro_torch.telemetry.records import StreamOrderError
from repro_torch.telemetry.storage import ShardReadError
from repro_torch.whatif.ir import IRUnsupportedError

#: default tick supervision: one same-rung retry, no deadline
DEFAULT_TICK_FAULT = FaultTolerance(max_retries=1, timeout_s=None,
                                    backoff_s=0.05)

#: errors of the device path, which propagate instead of descending the
#: ladder: a kernel that does not build, load or launch, an out-of-memory
#: error, and (where the installed torch has the class) any CUDA error
DEVICE_ERRORS: tuple[type[BaseException], ...] = (
    KernelError, torch.OutOfMemoryError,
    *((torch.AcceleratorError,) if hasattr(torch, "AcceleratorError") else ()))

#: the errors on which a device rung descends the ladder: the run-level IR
#: refusing the store's data, a shard that cannot be read under
#: ``strict=True``, and a stream out of time order on the host's row path
#: (e.g. a clock-skewed shard: the IR refuses it, so its configs go to
#: rows, which refuse it too). All are raised on the host by the host's
#: own work on the store's data, never by the card.
HOST_DATA_ERRORS: tuple[type[BaseException], ...] = (IRUnsupportedError,
                                                     ShardReadError,
                                                     StreamOrderError)


class DeviceDeadlineError(RuntimeError):
    """A device rung's attempt outlived the tick's deadline. It may still be
    running on the card, so the tick does not move to the host."""


def descends(rung: "Rung", err: BaseException) -> bool:
    """Whether a failed attempt on ``rung`` may walk down the ladder: on a
    host rung any error but :data:`DEVICE_ERRORS`, on a device rung only
    :data:`HOST_DATA_ERRORS`."""
    if isinstance(err, DEVICE_ERRORS):
        return False
    return rung.backend == "numpy" or isinstance(err, HOST_DATA_ERRORS)


@dataclasses.dataclass(frozen=True)
class Rung:
    """One degradation-ladder step: which backend, and whether the search
    warm-starts from the previous frontier."""

    name: str
    backend: str
    warm: bool


def ladder(backend: str) -> tuple[Rung, ...]:
    """The tick ladder for a configured backend: warm on that backend,
    warm on numpy (when distinct), then cold on numpy."""
    rungs = []
    if backend != "numpy":
        rungs.append(Rung(f"warm_{backend}", backend, True))
    rungs.append(Rung("warm_numpy", "numpy", True))
    rungs.append(Rung("cold_numpy", "numpy", False))
    return tuple(rungs)


class TickSupervisor:
    """Run one tick attempt function down the degradation ladder.

    ``attempt`` is called with a :class:`Rung` and must either return the
    tick's result or raise; :meth:`run` returns ``(result, rung, None)`` on
    the first success, or ``(None, None, last_error)`` when every rung is
    exhausted (the serve-stale signal). An error on which the rung may not
    descend (:func:`descends`) propagates at once, and a deadline miss on a
    device rung raises :class:`DeviceDeadlineError`. Deterministic apart
    from wall-clock timeouts: with
    no deadline and a deterministic ``attempt``, the rung walk is a pure
    function of which rungs raise.
    """

    def __init__(self, fault: FaultTolerance | None = None,
                 backend: str = "torch",
                 rungs: Sequence[Rung] | None = None):
        self.fault = fault or DEFAULT_TICK_FAULT
        self.rungs = tuple(rungs) if rungs is not None else ladder(backend)
        if not self.rungs:
            raise ValueError("supervisor needs at least one ladder rung")

    def run(self, attempt: Callable[[Rung], object]):
        fault = self.fault
        deadline = (time.monotonic() + fault.timeout_s
                    if fault.timeout_s is not None else None)
        last_err: BaseException | None = None
        prev_rung: Rung | None = None
        for rung in self.rungs:
            if prev_rung is not None:
                reason = ("deadline" if last_err is None
                          else type(last_err).__name__)
                obs.fallback(prev_rung.name, rung.name, reason)
            for try_no in range(fault.max_retries + 1):
                budget = None
                if deadline is not None:
                    budget = deadline - time.monotonic()
                    if budget <= 0:
                        return None, None, last_err
                ok, value, err, timed_out = _call(attempt, rung, budget)
                if ok:
                    return value, rung, None
                if timed_out:
                    # a hung attempt: don't retry the rung that hung —
                    # descend with whatever budget remains, unless it may
                    # still be running on the card
                    obs.counter(
                        "repro_live_deadline_misses_total",
                        help="tick attempts abandoned at the per-tick "
                             "deadline")
                    if rung.backend != "numpy":
                        raise DeviceDeadlineError(
                            f"{rung.name} did not finish within the tick's "
                            f"{fault.timeout_s} s deadline")
                    last_err = None
                    break
                if not descends(rung, err):
                    raise err
                last_err = err
                if try_no < fault.max_retries:
                    obs.counter(
                        "repro_live_tick_retries_total",
                        help="tick attempts that failed and were retried "
                             "on the same ladder rung")
                    if fault.backoff_s > 0:
                        time.sleep(min(fault.backoff_s * (2 ** try_no), 2.0))
            prev_rung = rung
        return None, None, last_err


def _call(attempt: Callable[[Rung], object], rung: Rung,
          budget_s: float | None):
    """One attempt, optionally under a wall-clock budget. Returns
    ``(ok, value, error, timed_out)``."""
    if budget_s is None:
        try:
            return True, attempt(rung), None, False
        except Exception as e:
            return False, None, e, False
    box: dict = {}

    def runner() -> None:
        try:
            box["value"] = attempt(rung)
        except BaseException as e:      # noqa: BLE001 — shipped to caller
            box["error"] = e

    t = threading.Thread(target=runner, daemon=True,
                         name=f"live-tick-{rung.name}")
    t.start()
    t.join(budget_s)
    if t.is_alive():
        return False, None, None, True
    if "error" in box:
        if not isinstance(box["error"], Exception):
            raise box["error"]
        return False, None, box["error"], False
    return True, box.get("value"), None, False
