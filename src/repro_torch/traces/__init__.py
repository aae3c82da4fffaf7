"""Industry serving-trace models (paper §2.3)."""
from repro_torch.traces.models import TRACES, TraceSpec, generate_trace, get_trace  # noqa: F401
