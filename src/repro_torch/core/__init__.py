"""repro_torch.core: the batch-major event engine (the port of ``repro.core``).

Entities are dataclasses of tensors; every engine function takes a leading
scenario axis, and one scenario is the ``B = 1`` case.
"""
from repro_torch.core.entities import (
    INF,
    SPACE_SHARED,
    TIME_SHARED,
    Cloudlets,
    Hosts,
    Market,
    Outages,
    Policy,
    Scenario,
    SimResult,
    SimState,
    TensorTree,
    VMRequests,
    finished_mask,
    resolve_device,
)
from repro_torch.core.energy import PowerModel, Topology
from repro_torch.core.engine import (
    History,
    init_state,
    is_batched,
    scenario_row,
    simulate,
    simulate_history,
    simulate_instrumented,
    simulate_trace,
)
from repro_torch.core.step import (
    AutoscaleInstrument,
    Instrument,
    MigrationInstrument,
    ReliabilityInstrument,
    StepEvent,
    TraceInstrument,
    UtilizationTimelineInstrument,
    batch_event_step,
)
from repro_torch.core.campaign import (
    broadcast_campaign,
    run_campaign,
    run_campaign_sharded,
    stack_scenarios,
)
from repro_torch.core.reducers import (
    ArgBestReducer,
    CampaignReducer,
    HistogramReducer,
    MeanReducer,
    SumReducer,
    ValuesReducer,
)
from repro_torch.core import (
    energy,
    kvserve,
    policies,
    provision,
    reducers,
    scenarios,
    search,
    segments,
    step,
    workload,
)

__all__ = [
    "INF", "SPACE_SHARED", "TIME_SHARED",
    "Cloudlets", "Hosts", "Market", "Outages", "Policy", "PowerModel",
    "Scenario", "SimResult", "SimState", "TensorTree", "Topology",
    "VMRequests",
    "finished_mask", "resolve_device", "History",
    "AutoscaleInstrument", "Instrument", "MigrationInstrument",
    "ReliabilityInstrument", "StepEvent", "TraceInstrument",
    "UtilizationTimelineInstrument",
    "batch_event_step", "init_state", "is_batched", "scenario_row",
    "simulate", "simulate_history", "simulate_instrumented", "simulate_trace",
    "broadcast_campaign", "run_campaign", "run_campaign_sharded",
    "stack_scenarios",
    "ArgBestReducer", "CampaignReducer", "HistogramReducer", "MeanReducer",
    "SumReducer", "ValuesReducer",
    "energy", "kvserve", "policies", "provision", "reducers", "scenarios",
    "search", "segments", "step", "workload",
]
