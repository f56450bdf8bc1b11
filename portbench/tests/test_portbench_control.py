"""On the card, at the cell's own size: the program passes its check, and
the control (the reference in fp8, the precision below the configuration's)
and each fault the cell can have fail it.

    python -m pytest -m gpu portbench/tests
"""

from __future__ import annotations

import pytest

from conftest import CELLS
from portbench import calibrate
from portbench.harness import check, manifest


@pytest.mark.gpu
@pytest.mark.parametrize("cell", CELLS)
def test_control_and_faults_fail_the_check_and_the_program_passes(cell, cuda_device):
    c = manifest.cell(cell)
    records = []
    calibrate.calibrate(c, [calibrate.FIRST_SEED + 1], 1, cuda_device, records.append)
    by_side = {r["side"]: r["numbers"] for r in records}
    assert set(by_side) == {"program", *calibrate.FAULTS}
    limits = c.spec["limits"]
    assert check.judge(by_side["program"], limits), by_side["program"]
    for fault in calibrate.FAULTS:
        assert not check.judge(by_side[fault], limits), (fault, by_side[fault])
