"""``HardwareProfile.h100`` (the port's counterpart of the reference's
``tpu_v5e``: a replica that is a model-parallel group of cards), held
as ``tests/test_runtime.py`` holds ``tpu_v5e``: the payload follows the
profile's precision, and a round of qwen2-0.5b prices to a finite
time; a group of cards scales the compute term."""
import pytest

from repro_torch.core.runtime import (HardwareProfile, RuntimeModel,
                                      WorkloadProfile)


def test_model_bits_follows_hardware_precision():
    wl = WorkloadProfile(1_000_000, 1e9)
    assert wl.model_bits(HardwareProfile()) == 1_000_000 * 4 * 8
    assert wl.model_bits(HardwareProfile.h100()) == 1_000_000 * 2 * 8
    hw4, hw2 = HardwareProfile(), HardwareProfile.h100()
    t4 = RuntimeModel(hw4, wl).comm_time("fedavg", 1, 1)
    assert t4 == pytest.approx(wl.model_bits(hw4) / hw4.b_d2c)
    t2 = RuntimeModel(hw2, wl).comm_time("fedavg", 1, 1)
    assert t2 == pytest.approx(wl.model_bits(hw2) / hw2.b_d2c)


def test_h100_profile_round_trip():
    hw = HardwareProfile.h100(2)
    wl = WorkloadProfile(494_000_000, 6 * 494e6 * 65536)
    rt = RuntimeModel(hw, wl)
    t = rt.round_time("ce_fedavg", 2, 8, 10)
    assert 0 < t < 3600


@pytest.mark.parametrize("gpus", [1, 2, 4, 16])
def test_h100_group_scales_compute(gpus):
    """The compute term of a group of cards is the one card's over the
    group's size; the links are a card's."""
    wl = WorkloadProfile(494_000_000, 6 * 494e6 * 65536)
    one = RuntimeModel(HardwareProfile.h100(1), wl)
    group = RuntimeModel(HardwareProfile.h100(gpus), wl)
    assert group.compute_time(4) == pytest.approx(one.compute_time(4) / gpus)
    assert group.comm_time("ce_fedavg", 8, 10) == \
        one.comm_time("ce_fedavg", 8, 10)
    assert HardwareProfile.h100(gpus).device_flops == 989e12 * gpus
