"""On the card, at each cell's own size: a short run is correct, and the
control (the reference with fp8 towers in the port's place) is not.

    python3 -m pytest portbench/tests -m card -q
"""

import time

import pytest

from portbench import readings, run
from portbench.registry import Registry

pytestmark = pytest.mark.card
SEED = 2**32 + 77


def cells():
    return [w["name"] for w in Registry().spec["workloads"]]


@pytest.mark.parametrize("cell", cells())
def test_a_short_run_on_the_card_is_correct(cuda_device, cell):
    line, info = run.run_cell(Registry(), cell, seed=SEED, seconds=3.0,
                              trace=False, device=cuda_device,
                              t_process0=time.perf_counter())
    assert line["correct"] is True, (line["check"], info)
    assert line["device"]["platform"] == "gpu"
    assert all(m["value"] > 0 for m in line["metrics"].values())


@pytest.mark.parametrize("cell", cells())
def test_the_control_fails_on_the_card(cuda_device, cell):
    reg = Registry()
    limits = reg.cell(cell)["limits"]
    nums = readings.control_numbers(reg, cell, SEED, 3.0, cuda_device)
    assert any(nums[k] > lim for k, lim in limits.items()), nums
