"""Shared effect algebra for counterfactual policy replay.

A policy's counterfactual for one time-ordered segment is an **effect**: a
power transform (the counterfactual board-power series, plus an optional
residency override) composed with a **time dilation** (seconds of modeled
lost progress, carried as sample-proportional partial sums plus integer
event counts priced at finalize). Effects form a monoid under
:func:`compose`:

* ``compose(a, b)`` is *b applied downstream of a* — ``b`` was computed on
  the segment view produced by ``a``, so the composed power series is
  ``b``'s, residency is the last override, throttled masks union, and the
  dilation terms add;
* :func:`identity_effect` (the recorded segment, no dilation) is a two-sided
  identity: ``compose(identity, e)`` and ``compose(e, identity_of(e))`` are
  bit-identical to ``e`` (``0.0 + x == x`` and ``0 | m == m`` exactly);
* composition is associative: power/residency take the last value, masks
  union, and the dilation sums are left-folded the same way by either
  bracketing (integer event counts are exactly associative; float partial
  sums are folded in a fixed left-to-right order by every caller).

:class:`SegmentEffect` is the scalar form (one policy config per segment),
:class:`BatchEffect` the config-axis form (one policy *family* per segment,
row-compressed). Both were previously private to ``whatif.policies``; they
live here so :class:`~repro_torch.whatif.policies.CompositePolicy` and the
replayers share one definition.

Event pricing
-------------
Event-priced dilations (downscale restores, parking wakes) stay integer
counts until finalize so totals are chunking-invariant. A policy prices its
events through **channels**: a leaf policy has one channel priced at
``event_penalty_s``; a composite concatenates its parts' channels, so a
"park the rest + downscale the active" composite prices parking wakes at
the resume latency and downscale restores at the clock-switch cost — in one
replay. :func:`policy_event_prices` / :func:`policy_event_channels` adapt
any :class:`~repro_torch.whatif.policies.Policy` (leaf policies need no changes),
and :func:`price_events` turns (prices, counts) into seconds with a fixed
left-fold so scalar and batched finalization perform identical float ops.
"""
from __future__ import annotations

import dataclasses
from typing import TYPE_CHECKING, Any

import numpy as np

if TYPE_CHECKING:
    from repro_torch.telemetry.records import TelemetryFrame


@dataclasses.dataclass
class SegmentEffect:
    """One policy's counterfactual for one time-ordered segment."""

    #: counterfactual board power per sample (W)
    power_w: np.ndarray
    #: counterfactual residency, or None when unchanged from the recording
    resident: np.ndarray | None
    #: samples the policy affected (downscaled / parked / capped)
    throttled: np.ndarray
    #: penalty partial-sum for sample-proportional penalty models; partials
    #: are fsum'd at finalize so totals are chunking-invariant
    penalty_partial_s: float = 0.0
    #: events priced at finalize via ``Policy.event_penalty_s`` (restores,
    #: wake-ups); integer counts keep the pricing chunking-invariant
    wake_events: int = 0
    downscale_events: int = 0
    #: per-channel event counts for multi-channel pricing (composites), or
    #: None for the single-channel leaf form ``[wake_events]``
    events: np.ndarray | None = None

    def event_vector(self, n_channels: int = 1) -> np.ndarray:
        """Counts in channel space: ``events`` when present, else the leaf
        form (wake events in channel 0 of ``n_channels``)."""
        if self.events is not None:
            return self.events
        v = np.zeros(n_channels, dtype=np.int64)
        if n_channels:
            v[0] = self.wake_events
        return v


@dataclasses.dataclass
class BatchEffect:
    """One family batch's counterfactual for one segment, row-compressed.

    ``row_of[c]`` maps member config ``c`` to a row of ``power_rows`` /
    ``throttled_rows`` (and ``resident_rows`` when present); ``-1`` means the
    config leaves this stream untouched (counterfactual == recorded series,
    so the replayer aliases it to the shared baseline integration). Distinct
    configs may share a row — every parking config that parks a device
    produces the *same* counterfactual series — so integration cost scales
    with distinct rows, not grid size.
    """

    #: counterfactual board power rows (W), [R, n]
    power_rows: np.ndarray
    #: samples each row's policy affected, [R, n]
    throttled_rows: np.ndarray
    #: config -> row index, or -1 for identity (cf == recorded), [C]
    row_of: np.ndarray
    #: counterfactual residency rows, or None when unchanged for every row
    resident_rows: np.ndarray | None
    #: per-config penalty partial-sums (fsum'd at finalize), [C]
    penalty_partial_s: np.ndarray
    #: per-config event counts priced at finalize, [C]
    wake_events: np.ndarray
    downscale_events: np.ndarray
    #: per-config per-channel event counts ([C, K]) for multi-channel
    #: pricing (composites), or None for the single-channel leaf form
    events_rows: np.ndarray | None = None


def identity_effect(seg: "TelemetryFrame",
                    n_channels: int = 1) -> SegmentEffect:
    """The recorded segment unchanged — the monoid identity of
    :func:`compose` (zero dilation, no throttling, no events)."""
    n = len(seg)
    return SegmentEffect(
        power_w=np.asarray(seg["power"], dtype=np.float64),
        resident=None,
        throttled=np.zeros(n, dtype=bool),
        events=np.zeros(n_channels, dtype=np.int64),
    )


def compose(first: SegmentEffect, second: SegmentEffect) -> SegmentEffect:
    """``second`` applied downstream of ``first`` (on ``first``'s output).

    Power takes the downstream series, residency the last override,
    throttled masks union, and every dilation term adds. Both effects must
    live in the same event-channel space (lift leaf effects with
    :meth:`SegmentEffect.event_vector` / an offset first — see
    :meth:`CompositePolicy.apply <repro_torch.whatif.policies.CompositePolicy>`).
    """
    if (first.events is None) != (second.events is None):
        raise ValueError("compose() requires both effects in the same "
                         "event-channel space; lift the leaf effect first")
    if first.events is not None and first.events.shape != second.events.shape:
        raise ValueError(
            f"compose() channel mismatch: {first.events.shape} vs "
            f"{second.events.shape}")
    return SegmentEffect(
        power_w=second.power_w,
        resident=(second.resident if second.resident is not None
                  else first.resident),
        throttled=first.throttled | second.throttled,
        penalty_partial_s=first.penalty_partial_s + second.penalty_partial_s,
        wake_events=first.wake_events + second.wake_events,
        downscale_events=first.downscale_events + second.downscale_events,
        events=(None if first.events is None
                else first.events + second.events),
    )


def effect_view(seg: "TelemetryFrame", effect: SegmentEffect):
    """The segment as the next policy in a composition sees it: power (and
    residency, when overridden) replaced by the effect's counterfactual,
    every signal column shared with the recording.

    The low-activity memo (``seg._low_cache``) is shared between base and
    view: the predicate reads only signal columns, which the view aliases,
    so downstream parts reuse (and extend) the same per-segment cache.
    """
    from repro_torch.telemetry.records import TelemetryFrame

    cols = dict(seg.columns)
    cols["power"] = np.asarray(effect.power_w, dtype=np.float64)
    if effect.resident is not None:
        cols["program_resident"] = np.asarray(effect.resident)
    view = TelemetryFrame(cols)
    cache = getattr(seg, "_low_cache", None)
    if cache is None:
        cache = seg._low_cache = {}
    view._low_cache = cache
    return view


# --------------------------------------------------------------------------- #
# Event pricing (finalize-time, chunking-invariant)
# --------------------------------------------------------------------------- #
def policy_event_channels(policy: Any) -> int:
    """Number of event-pricing channels: ``policy.n_event_channels`` when the
    policy defines it (composites), else 1 (every leaf policy)."""
    return int(getattr(policy, "n_event_channels", 1))


def policy_event_prices(policy: Any, plat: Any) -> np.ndarray:
    """Per-channel event prices (seconds/event): ``policy.event_prices_s``
    when defined (composites), else the leaf adapter
    ``[policy.event_penalty_s(plat)]``."""
    fn = getattr(policy, "event_prices_s", None)
    if fn is not None:
        return np.asarray(fn(plat), dtype=np.float64)
    return np.array([policy.event_penalty_s(plat)], dtype=np.float64)


def price_events(prices: np.ndarray, counts: np.ndarray) -> float:
    """Seconds of event-priced dilation: ``sum_k counts[k] * prices[k]`` as a
    fixed left-fold, so the scalar and batched finalize paths perform the
    identical float operations (and a single channel reduces to the legacy
    ``wakes * price`` bit-exactly: ``0.0 + x == x``)."""
    if len(prices) != len(counts):
        raise ValueError(
            f"event pricing mismatch: {len(counts)} count channels vs "
            f"{len(prices)} price channels")
    total = 0.0
    for c, p in zip(counts, prices):
        total += float(c) * float(p)
    return total
