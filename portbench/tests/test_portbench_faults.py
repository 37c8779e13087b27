"""A run whose timed path is broken underneath comes out not correct, for
each fault a serving cell can have (``faults.py``), at the tiny size; and
the control, the reference with fp8 towers in the port's place, is not
correct either."""

import pytest
import torch

from portbench import faults, readings
from portbench.registry import Registry
from portbench.tests.test_portbench_run import cells, tiny_run


@pytest.mark.parametrize("cell", cells())
@pytest.mark.parametrize("fault", sorted(faults.FAULTS))
def test_a_broken_path_is_not_correct(tiny_root, cell, fault):
    line, _ = tiny_run(tiny_root, cell, fault=faults.FAULTS[fault])
    assert line["correct"] is False
    failing = [k for k, v in line["check"].items()
               if v["limit"] is not None and v["value"] > v["limit"]]
    assert failing, line["check"]


@pytest.mark.parametrize("cell", cells())
def test_the_fp8_control_is_not_correct(tiny_root, cell):
    reg = Registry(tiny_root, tiny_root / "portbench")
    limits = reg.cell(cell)["limits"]
    nums = readings.control_numbers(reg, cell, 2**35 + 1, 1.0,
                                    torch.device("cpu"))
    assert any(nums[k] > lim for k, lim in limits.items()), nums
