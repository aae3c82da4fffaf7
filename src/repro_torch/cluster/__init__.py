"""Academic-cluster telemetry simulator (paper §2.1 deployment, regenerated)."""
from repro_torch.cluster.simulator import generate_cluster, ClusterSample  # noqa: F401
