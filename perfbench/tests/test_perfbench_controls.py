"""The check of `correct` fails what it must, at a small size on the CPU:
the control (the plain reference one precision below the configuration's,
in the program's place) and each fault a cell can have, planted in the
timed path: a step that leaves its state unchanged, half of the batch left
out, an answer altered where it is produced, and (CoCoA) rows skipped only
in the longest passes, the fewest workers', with v and da kept in step."""
import pytest

import pb_tiny

CONTROLS = [("danube.train.seq4k", "fp8"),
            ("epsilon.cocoa.elastic", "bfloat16")]
FAULTS = [("danube.train.seq4k", f)
          for f in ("frozen", "half_batch", "double_leaf")]
FAULTS += [("epsilon.cocoa.elastic", f)
           for f in ("frozen", "half_batch", "altered", "long_pass_skip")]


@pytest.mark.parametrize("workload,program", CONTROLS)
def test_control_is_not_correct(workload, program):
    res = pb_tiny.run(workload, program=program)
    assert not res["correct"], res["compared"]


@pytest.mark.parametrize("workload,fault", FAULTS)
def test_fault_is_not_correct(workload, fault):
    res = pb_tiny.run(workload, fault=fault)
    assert not res["correct"], res["compared"]
