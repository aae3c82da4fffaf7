"""Live fleet controller: the always-on ingest → extend → search loop.

The offline what-if engine answers "what should the fleet do" from a
frozen store; this package keeps the answer fresh against a store that
never stops growing, and keeps its failure behavior boring:

* :mod:`~repro_torch.live.controller` — the tick loop (poll watermark →
  coalesce pending shards into one IR extend → warm-started
  ``search_frontier`` on the card → checkpoint → publish knee);
* :mod:`~repro_torch.live.checkpoint` — atomic checkpoints (shard
  watermark + serialized frontier + tick counter) with the crash-point
  ordering that makes ``kill -9`` at any instant resume to a bit-identical
  frontier;
* :mod:`~repro_torch.live.supervisor` — the tick watchdog: per-tick
  deadline, retry-with-backoff, degradation ladder (torch→numpy,
  warm→cold, serve-stale-knee-with-flag) for poisoned data; on the card
  only the host's IR data errors descend, every other error propagates;
* :mod:`~repro_torch.live.producer` — what feeds it: the simulator
  drip-fed by window, a fleet-scale synthetic stream generator, and the
  DCGM / ``power.json`` real-telemetry adapter.

``python -m repro_torch.launch.live`` runs it as a daemon.
"""
from repro_torch.live.checkpoint import (Checkpoint, load_checkpoint,
                                         remove_checkpoint, save_checkpoint,
                                         watermark_valid)
from repro_torch.live.controller import (LiveConfig, LiveController,
                                         TickResult, fault_hook)
from repro_torch.live.producer import (DcgmDirectoryProducer,
                                       SimulatorProducer, SyntheticProducer,
                                       parse_power_json)
from repro_torch.live.supervisor import (DEFAULT_TICK_FAULT, Rung,
                                         TickSupervisor, ladder)

__all__ = [
    "Checkpoint", "DEFAULT_TICK_FAULT", "DcgmDirectoryProducer",
    "LiveConfig", "LiveController", "Rung", "SimulatorProducer",
    "SyntheticProducer", "TickResult", "TickSupervisor", "fault_hook",
    "ladder", "load_checkpoint", "parse_power_json", "remove_checkpoint",
    "save_checkpoint", "watermark_valid",
]
