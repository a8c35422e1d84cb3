"""Interruptible multi-DNN serving: an urgent task arrives unannounced
while the array is saturated; IMMSched preempts by largest slack, runs
the real PSO-Ullmann matcher on the freed engine subgraph, and the urgent
task meets its deadline. The same scenario under the serial-matching
baseline (IsoSched-like) and an LTS baseline (MoCA-like) is shown for
contrast.

    PYTHONPATH=src python -m repro_torch.examples.interruptible_serving \
        [--device cpu]

IMMSched's matcher service runs on the card unless given ``--device
cpu``; the two baselines run in analytic mode.
"""
import argparse

from repro_torch.accel.platform import EDGE
from repro_torch.core.pso import PSOConfig
from repro_torch.sched import SimConfig, Simulator, get_scheduler
from repro_torch.sched.tasks import fixed_scenario
from repro_torch.workloads.zoo import get_workload

#: (scheduler, matcher mode) in the order the rows are printed
RUNS = (("immsched", "real"), ("isosched", "analytic"),
        ("moca", "analytic"))


def main(argv=None):
    """Run the scenario under each of ``RUNS``; returns ``{scheduler:
    SimResult}``."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    device = ap.parse_args(argv).device
    # three background nets saturate the array, then an urgent MobileNet
    workloads = [get_workload("unet"), get_workload("resnet50"),
                 get_workload("unet"), get_workload("mobilenetv2")]
    scenario = fixed_scenario(workloads, urgent_last=True)
    urgent = [t for t in scenario.tasks if t.urgent][0]
    print(f"urgent task: {urgent.name} arrives t={urgent.arrival * 1e3:.2f} ms "
          f"deadline t={urgent.deadline * 1e3:.2f} ms")

    results = {}
    for name, mode in RUNS:
        cfg = SimConfig(platform=EDGE, matcher_mode=mode,
                        pso_cfg=PSOConfig(num_particles=32, epochs=2,
                                          inner_steps=6),
                        window_stages=2, device=device)
        r = Simulator(cfg, get_scheduler(name)).run(scenario)
        results[name] = r
        print(f"{name:9s} urgent deadline met: {r.urgent_met}/{r.urgent_total}"
              f"  mean latency {r.avg_total_latency * 1e3:8.3f} ms"
              f"  mean sched time {r.avg_sched_time * 1e6:9.1f} us"
              f"  energy/task {r.work_energy_per_task * 1e3:8.4f} mJ")
    return results


if __name__ == "__main__":
    main()
