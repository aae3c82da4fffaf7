"""Telemetry: Table-1 records, the runtime sampler, per-job and fleet
analysis, and the shard store."""
from repro_torch.telemetry.records import TelemetryFrame, FIELDS, SCHEMA  # noqa: F401
from repro_torch.telemetry.sampler import RuntimeSampler  # noqa: F401
from repro_torch.telemetry.pipeline import (  # noqa: F401
    analyze_job,
    analyze_fleet,
    analyze_store,
    classify_frame,
    per_job_fraction_cdf,
    tail_share,
    FleetAccumulator,
    JobAnalysis,
    FleetAnalysis,
)
from repro_torch.telemetry.storage import (  # noqa: F401
    ShardReadError,
    TelemetryStore,
)
