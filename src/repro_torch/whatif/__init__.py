"""What-if policy engine: counterfactual mitigation sweeps over stored
fleet telemetry.

Replays any :class:`~repro_torch.telemetry.storage.TelemetryStore` (cluster
simulator output, DES/serving traces) under execution-idle mitigation
policies — Algorithm-1 downscaling, k-of-n consolidation parking, power
capping, and sequential :class:`~repro_torch.whatif.policies.CompositePolicy`
combinations of them — fully out-of-core, and reports the energy/perf
trade-off :class:`~repro_torch.whatif.sweep.Frontier`. Policies are values in
the :mod:`repro_torch.whatif.effects` algebra. The run-level IR replays them
on the card through :mod:`repro_torch.whatif.backend` (``backend="torch"``,
the default) with two hand-written kernels: the cap-bucket scan and the
Algorithm-1 cooldown chain. ``backend="numpy"`` is the host oracle: the IR
where it can carry a config, the config-axis batched row replay where it
cannot. :func:`~repro_torch.whatif.search.search_frontier` is the
closed-loop search around the frontier's knee under a penalty budget, on
either backend; it evaluates the same configs in the same order as the JAX
package's search.
"""
from repro_torch.whatif.effects import (  # noqa: F401
    BatchEffect,
    SegmentEffect,
    compose,
    effect_view,
    identity_effect,
    policy_event_channels,
    policy_event_prices,
    price_events,
)
from repro_torch.whatif.policies import (  # noqa: F401
    BatchDownscaleCarry,
    CompositeBatch,
    CompositePolicy,
    DownscaleBatch,
    DownscaleCarry,
    DownscalePolicy,
    FallbackBatch,
    NoOpBatch,
    NoOpPolicy,
    ParkingBatch,
    ParkingPolicy,
    Policy,
    PolicyBatch,
    PowerCapBatch,
    PowerCapPolicy,
    RunBatchResult,
    batched_downscale_decisions,
    downscale_decisions,
    downscale_trigger_index,
    low_activity_series,
    make_batches,
)
from repro_torch.whatif.ir import (  # noqa: F401
    IRBuilder,
    IRConfig,
    IRUnsupportedError,
    RunIR,
    StreamIR,
    build_ir,
    get_ir,
    ir_config_for,
    ir_supported,
    load_sidecar,
    save_sidecar,
)
from repro_torch.whatif.replay import (  # noqa: F401
    BatchedPolicyReplayer,
    JobReplay,
    ReplayResult,
    replay_ir,
)
from repro_torch.whatif.sweep import (  # noqa: F401
    Frontier,
    PolicyOutcome,
    assemble_frontier,
    default_policy_grid,
    evaluate,
    pareto_flags,
    run_sweep,
)
from repro_torch.whatif.search import (  # noqa: F401
    CategoricalAxis,
    ContinuousAxis,
    PenaltyBudget,
    PolicyFamily,
    RoundRecord,
    SearchResult,
    achievable_saving,
    default_families,
    find_knee,
    search_frontier,
    seed_points,
)
from repro_torch.whatif.report import (  # noqa: F401
    format_frontier,
    format_search_trace,
    frontier_from_dict,
    frontier_to_dict,
    load_frontier,
    save_frontier,
)
