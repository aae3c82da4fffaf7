"""Telemetry: Table-1 records, the runtime sampler and per-job analysis."""
from repro_torch.telemetry.records import TelemetryFrame, FIELDS, SCHEMA  # noqa: F401
from repro_torch.telemetry.sampler import RuntimeSampler  # noqa: F401
from repro_torch.telemetry.pipeline import analyze_job, classify_frame, JobAnalysis  # noqa: F401
