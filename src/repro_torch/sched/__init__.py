from repro_torch.sched.tasks import (TaskSpec, Scenario, StreamScenario,
                                     make_burst_scenario,
                                     make_mixed_burst_scenario,
                                     make_restart_scenario, make_scenario,
                                     make_streaming_scenario)
from repro_torch.sched.registry import (ARRIVALS, DEADLINES, RESTARTS,
                                        URGENCY, WORKLOADS, build_scenario)
from repro_torch.sched.simulator import (Simulator, SimConfig, SimResult,
                                         TaskTable)
from repro_torch.sched.schedulers import (SCHEDULERS, IMMSchedScheduler,
                                          IsoSchedScheduler, LTSScheduler,
                                          get_scheduler)
from repro_torch.sched.metrics import (frontend_stats,
                                       latency_bound_throughput,
                                       pipeline_tier_rates, speedup_table,
                                       energy_efficiency)
