"""A run with its timed path broken underneath comes out not correct:
for each fault a cell can have (a state left unchanged, half the batch
left out, an answer altered where it is produced), and for the control,
the reference one precision below in the program's place.  The runs skip
the look for a card and drive the rest of a run on the CPU at tiny size,
held to the cells' own limits."""

import pytest

from lavbench import faults
from lavbench.tests.helpers import run_cell

AGENT = "agent.int8.e16"
DISTILL = "distill.f32.b32"


@pytest.mark.parametrize("fault", faults.FAULTS)
def test_agent_fault_is_not_correct(tiny, fault):
    with faults.planted(fault, "agent"):
        rc, line = run_cell(tiny, AGENT, seconds=1.5)
    assert rc == 0 and line["correct"] is False, line["check"]


@pytest.mark.parametrize("fault", faults.FAULTS)
def test_distill_fault_is_not_correct(tiny, fault):
    with faults.planted(fault, "distill"):
        rc, line = run_cell(tiny, DISTILL, seconds=1.5)
    assert rc == 0 and line["correct"] is False, line["check"]


@pytest.mark.parametrize("cell", [AGENT, DISTILL, "agent.f32.e16"])
def test_sound_run_is_correct(tiny, cell):
    rc, line = run_cell(tiny, cell, seconds=1.5)
    assert rc == 0 and line["correct"] is True, line["check"]


def test_int4_control_is_not_correct(tiny):
    rc, line = run_cell(tiny, AGENT, seconds=1.5, control=True)
    assert rc == 0 and line["correct"] is False, line["check"]


@pytest.mark.card
@pytest.mark.parametrize("cell", [AGENT, DISTILL, "agent.f32.e16"])
def test_control_is_not_correct_on_the_card(card, tmp_path, cell):
    """The control at a size a test run holds (2 egos, 4 rows): int4 for
    the int8 cell; f32 with TF32 on for the f32 cells, which exists only
    on the card."""
    from lavbench.tests.helpers import tiny_root
    from lavbench import run

    root = tiny_root(tmp_path / "checkout")
    import io
    import json
    buf = io.StringIO()
    rc = run.main(["--workload", cell, "--seed", "77", "--seconds", "1",
                   "--trace", "0"], root=root, device=card, control=True,
                  out=buf)
    line = json.loads(buf.getvalue().strip().splitlines()[-1])
    assert rc == 0 and line["correct"] is False, line["check"]
