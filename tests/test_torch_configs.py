"""The port's configs (``repro_torch.configs``) against the JAX package's:
every architecture field for field, the training policies, the shape
cells and ``input_specs``, and the scheduler bridge (each architecture
lowered to a workload and a preemptible DAG equal to the reference's)."""
import dataclasses

import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.accel import EDGE as JEDGE
from repro.core import preemptible_dag as jpd
from repro.workloads.zoo import lm_workload_from_config as jlower
from repro_torch import configs as tconfigs
from repro_torch.accel.platform import EDGE as TEDGE
from repro_torch.core import preemptible_dag as tpd
from repro_torch.workloads.zoo import lm_workload_from_config as tlower

_DTYPES = {"int32": torch.int32, "bfloat16": torch.bfloat16}


def test_the_registry_lists_the_reference_s_architectures():
    assert tconfigs.ARCHS == jconfigs.ARCHS
    assert tconfigs.VLM_PATCH_TOKENS == jconfigs.VLM_PATCH_TOKENS
    assert tconfigs.AUDIO_FRAME_RATIO == jconfigs.AUDIO_FRAME_RATIO


@pytest.mark.parametrize("arch", jconfigs.ARCHS)
def test_every_config_equals_the_reference_field_for_field(arch):
    t, j = tconfigs.get_config(arch), jconfigs.get_config(arch)
    assert dataclasses.asdict(t) == dataclasses.asdict(j)
    assert t.resolved_head_dim == j.resolved_head_dim
    assert (dataclasses.asdict(tconfigs.get_train_config(arch))
            == dataclasses.asdict(jconfigs.get_train_config(arch)))
    assert ([dataclasses.asdict(s) for s in tconfigs.arch_shapes(arch)]
            == [dataclasses.asdict(s) for s in jconfigs.arch_shapes(arch)])
    for s in tconfigs.arch_shapes(arch):
        assert (tconfigs.parallelism_profile(arch, s.name)
                == jconfigs.parallelism_profile(arch, s.name))


@pytest.mark.parametrize("arch", jconfigs.ARCHS)
def test_abstract_input_specs_match_on_the_meta_device(arch):
    for shape in jconfigs.arch_shapes(arch):
        want = jconfigs.input_specs(arch, shape, abstract=True)
        got = tconfigs.input_specs(arch, shape, abstract=True)
        assert sorted(got) == sorted(want)
        for k, w in want.items():
            assert got[k].device.type == "meta"
            assert tuple(got[k].shape) == tuple(w.shape), (arch, shape, k)
            assert got[k].dtype == _DTYPES[str(w.dtype)]


def test_concrete_input_specs_are_zeros_on_the_device():
    shape = tconfigs.DECODE_32K
    got = tconfigs.input_specs("qwen2-vl-7b", shape, abstract=False,
                               batch_override=2, device="cpu")
    want = jconfigs.input_specs("qwen2-vl-7b", shape, abstract=False,
                                batch_override=2)
    for k, w in want.items():
        assert got[k].device.type == "cpu"
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(w))


@pytest.mark.parametrize("arch", jconfigs.ARCHS)
def test_every_arch_lowers_to_the_reference_s_scheduler_workload(arch):
    """The port's twin of ``tests/test_workloads.py``'s
    ``test_every_arch_lowers_to_scheduler_workload``, through the port's
    configs, zoo and preemptible DAG, with graphs equal to the
    reference's."""
    twl = tlower(tconfigs.get_config(arch), block_group=2)
    jwl = jlower(jconfigs.get_config(arch), block_group=2)
    twl.validate()
    assert twl.total_macs == jwl.total_macs
    assert twl.total_bytes == jwl.total_bytes
    cap = TEDGE.engine_tile_capacity_macs()
    assert cap == JEDGE.engine_tile_capacity_macs()
    td = tpd.build_preemptible_dag([(0, twl, 0)], tile_capacity_macs=cap,
                                   window_stages=2)
    jd = jpd.build_preemptible_dag([(0, jwl, 0)], tile_capacity_macs=cap,
                                   window_stages=2)
    assert td.n > 0 and td.graph.is_dag()
    for f in ("adj", "types", "weights"):
        a, b = getattr(td.graph, f), getattr(jd.graph, f)
        assert a.dtype == b.dtype and a.shape == b.shape
        assert a.tobytes() == b.tobytes()
    assert td.task_tiles == jd.task_tiles
