"""Fault tolerance via the paper's own mechanism: when engines fail
mid-run, drop them from the target graph G and re-run the subgraph matcher
to remap the workload onto the surviving engine DAG.

    PYTHONPATH=src python -m repro_torch.examples.fault_tolerant_rematch \
        [--device cpu]

Runs on the card unless given ``--device cpu``.
"""
import argparse

import numpy as np

from repro_torch.accel.platform import EDGE
from repro_torch.runtime.ft import elastic_mesh_shape, remap_on_failure
from repro_torch.workloads.zoo import get_workload


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    device = ap.parse_args(argv).device
    wl = get_workload("resnet50")

    print("healthy array:")
    mapping, target = remap_on_failure(EDGE, wl, failed_engines=[],
                                       device=device)
    assert mapping is not None
    print(f"  mapped {mapping.shape[0]} tiles onto {target.n} engines")

    # fail a whole NoC row (engines 0..7) plus two more
    failed = list(range(8)) + [21, 42]
    print(f"after failing engines {failed}:")
    mapping, target = remap_on_failure(EDGE, wl, failed_engines=failed,
                                       device=device)
    assert mapping is not None, "re-match failed"
    engine_ids = target.weights.astype(int)
    used = sorted(int(engine_ids[j]) for j in np.where(mapping)[1])
    assert not (set(used) & set(failed)), "mapped onto a failed engine!"
    print(f"  re-mapped {mapping.shape[0]} tiles onto "
          f"{target.n} surviving engines; none failed: OK")

    # the pod-level analogue: elastic mesh rebuild after losing hosts
    for n in (512, 496, 256, 240):
        shape, axes = elastic_mesh_shape(n)
        print(f"  {n} live devices -> mesh {shape} {axes}")


if __name__ == "__main__":
    main()
