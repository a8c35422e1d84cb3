"""Running the gloo worlds of the sharded tests' module fixtures.

A fixture hands ``run_in_turn`` its calls: the reference's JAX process
first, then one call per world of ranks. The calls run one after
another, so that no more processes are live than one call needs, and
each has its own deadline: the seconds it takes alone on an 8-core CPU
(each file's ``ALONE_S``) times ``LOAD_FACTOR``, and at least
``MIN_DEADLINE_S``. Each call's seconds are printed, so a fixture that
fails shows which call ran long.
"""
import math
import time

from repro_torch.launch import mesh as mesh_lib

#: how much slower a call runs under the suite's ``-n 6 --dist loadfile``
#: than alone. Measured with the five ``test_torch_shard_*`` files that
#: run worlds beside seven other heavy files on 8 cores: 1.1 to 6.3 (the
#: largest a world of 4 of ``test_torch_shard_moe.py``, 60.3 s against
#: 9.6 s alone; ``test_torch_shard_odd.py``'s reference process 3.3,
#: 311.8 s against 93.9 s), so 8 leaves room
LOAD_FACTOR = 8.0
#: a call's least deadline: starting a process alone takes seconds
MIN_DEADLINE_S = 60


def run_in_turn(calls, *, env, cwd):
    """Run each ``(name, commands, alone_s)`` of ``calls`` through
    ``run_ranks``, one call after another, each with a deadline of
    ``alone_s * LOAD_FACTOR`` seconds (at least ``MIN_DEADLINE_S``).
    Returns ``{name: outputs}``, the ``(returncode, stdout, stderr)`` of
    each command."""
    outs = {}
    for name, cmds, alone_s in calls:
        deadline = max(MIN_DEADLINE_S, math.ceil(alone_s * LOAD_FACTOR))
        t0 = time.monotonic()
        outs[name] = mesh_lib.run_ranks(cmds, timeout_s=deadline, env=env,
                                        cwd=cwd)
        print(f"{name}: {len(cmds)} processes, "
              f"{time.monotonic() - t0:.1f} s of {deadline} s")
    return outs
