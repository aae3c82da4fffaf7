"""Workload-class job generators for the academic-cluster simulator (§2-4).

Each job is a sequence of phases (deep-idle setup, active bursts,
execution-idle intervals) whose statistics are calibrated to the paper:

* exec-idle interval durations: median 9 s / p90 44 s / p99 836 s (Fig 8)
  via a 4-component lognormal mixture,
* per-job exec-idle fractions per class (Fig 5 / Fig 7): serving ~61% of
  in-execution time, training ~13%, batch inference ~12%, others ~5%, with
  right-skewed per-job spread,
* pre-idle causes: PCIe 48% / compute-to-idle 33% / NIC 17% / NVLink 2%
  (Fig 9) — the tail of each active burst carries the cause's signal
  signature (NVLink causes only on NVLink platforms: A100/H100/B200),
* deep-idle setup ~24% of job-attributed time (Fig 3b).
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core.power_model import PlatformSpec

# ---------------------------------------------------------------------------
# exec-idle interval duration mixture (calibrated against Fig 8)
# ---------------------------------------------------------------------------
INTERVAL_MIX = (
    # (weight, ln-median, sigma)
    (0.63, np.log(7.6), 0.40),
    (0.28, np.log(18.0), 0.55),
    (0.075, np.log(95.0), 0.80),
    (0.015, np.log(1250.0), 0.60),
)
MIN_INTERVAL_S, MAX_INTERVAL_S = 5.0, 3600.0


def sample_interval(rng: np.random.Generator) -> float:
    w = np.array([m[0] for m in INTERVAL_MIX])
    i = rng.choice(len(INTERVAL_MIX), p=w / w.sum())
    _, mu, sigma = INTERVAL_MIX[i]
    return float(np.clip(rng.lognormal(mu, sigma), MIN_INTERVAL_S, MAX_INTERVAL_S))


# ---------------------------------------------------------------------------
# pre-idle causes (Fig 9)
# ---------------------------------------------------------------------------
CAUSES = ("pcie", "compute", "nic", "nvlink")
#: global target shares (paper Fig 9): pcie .48 / compute .33 / nic .17 /
#: nvlink .02. NVLink onsets exist only on NVLink platforms (~13% of the
#: fleet), so the per-platform rates below are chosen to hit the global mix.
CAUSE_P_NVLINK = (0.42, 0.28, 0.15, 0.15)
CAUSE_P_PLAIN = (0.49, 0.335, 0.175, 0.0)
NVLINK_PLATFORMS = frozenset({"a100", "h100", "b200"})


def sample_cause(rng: np.random.Generator, platform: str) -> str:
    p = np.array(CAUSE_P_NVLINK if platform in NVLINK_PLATFORMS
                 else CAUSE_P_PLAIN)
    return str(rng.choice(CAUSES, p=p / p.sum()))


# ---------------------------------------------------------------------------
# workload classes
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class WorkloadClass:
    name: str
    #: probability a job belongs to this class (by count; serving = 14.6%, §4.2)
    count_share: float
    #: per-job exec-idle fraction sampler params: mixture of two Betas
    beta_lo: tuple[float, float]
    beta_hi: tuple[float, float]
    hi_weight: float
    #: job duration lognormal (s)
    dur_median_s: float
    dur_sigma: float
    #: active-phase utilization range
    util_range: tuple[float, float]


CLASSES: dict[str, WorkloadClass] = {
    "serving": WorkloadClass(
        name="serving", count_share=0.146,
        beta_lo=(2.2, 1.7), beta_hi=(5.0, 1.8), hi_weight=0.30,
        dur_median_s=2.8 * 3600, dur_sigma=0.30, util_range=(0.08, 0.35)),
    "training": WorkloadClass(
        name="training", count_share=0.40,
        beta_lo=(0.5, 15.0), beta_hi=(2.2, 2.2), hi_weight=0.17,
        dur_median_s=2.6 * 3600, dur_sigma=0.5, util_range=(0.22, 0.62)),
    "batch_inference": WorkloadClass(
        name="batch_inference", count_share=0.25,
        beta_lo=(0.5, 15.0), beta_hi=(2.2, 2.2), hi_weight=0.15,
        dur_median_s=2.4 * 3600, dur_sigma=0.45, util_range=(0.2, 0.58)),
    "other": WorkloadClass(
        name="other", count_share=0.204,
        beta_lo=(0.6, 20.0), beta_hi=(1.5, 2.0), hi_weight=0.02,
        dur_median_s=2.2 * 3600, dur_sigma=0.5, util_range=(0.2, 0.62)),
}


def sample_class(rng: np.random.Generator) -> WorkloadClass:
    names = list(CLASSES)
    p = np.array([CLASSES[n].count_share for n in names])
    return CLASSES[str(rng.choice(names, p=p / p.sum()))]


def sample_job_idle_fraction(rng: np.random.Generator, klass: WorkloadClass) -> float:
    if rng.random() < klass.hi_weight:
        a, b = klass.beta_hi
    else:
        a, b = klass.beta_lo
    return float(np.clip(rng.beta(a, b), 0.003, 0.97))


# ---------------------------------------------------------------------------
# phase stream
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class Phase:
    kind: str          # "deep" | "active" | "idle"
    duration_s: int
    util: float = 0.0
    cause: str = ""    # cause signature carried by the END of an active phase


def job_phases(rng: np.random.Generator, klass: WorkloadClass,
               platform: PlatformSpec) -> tuple[list[Phase], float]:
    """Generate one job's phase list. Returns (phases, duration_s)."""
    duration = float(np.clip(rng.lognormal(np.log(klass.dur_median_s),
                                           klass.dur_sigma), 1800, 36 * 3600))
    f_idle = sample_job_idle_fraction(rng, klass)
    setup_frac = float(np.clip(rng.uniform(0.08, 0.34), 0, 0.5))

    phases: list[Phase] = [Phase("deep", max(30, int(duration * setup_frac)))]
    remaining = duration * (1 - setup_frac)

    # alternate active/idle with E[active] set by the target fraction
    mean_idle = 26.0   # mean of the interval mixture (s)
    mean_active = mean_idle * (1 - f_idle) / max(f_idle, 1e-3)
    while remaining > 5:
        active_s = float(np.clip(rng.lognormal(
            np.log(max(mean_active, 3.0)), 0.6), 3, remaining))
        cause = sample_cause(rng, platform.name)
        util = float(rng.uniform(*klass.util_range))
        phases.append(Phase("active", int(active_s), util, cause))
        remaining -= active_s
        if remaining <= 5:
            break
        idle_s = float(min(sample_interval(rng), remaining))
        phases.append(Phase("idle", int(idle_s)))
        remaining -= idle_s
    return phases, duration
