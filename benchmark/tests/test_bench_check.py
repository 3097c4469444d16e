"""What decides `correct`, at the configuration's rehearsal size on the
CPU (the port's plain versions; the card's readings at the cell's own size
are in PERF.md): a sound run is correct; with the control, the plain
reference computed in bfloat16, in the program's place, the harness's own
verdict is false; and with each fault the cell can have planted in the
timed path (`tools/readings.py` FAULTS), the run drives through to a
result whose `correct` is false. One chip (no exchange between chips to
leave out). These runs take about a minute each."""

import pytest

from benchmark.tools import readings

CELL = "fr3_office.chunked"
SEED = 1207


def test_sound_run_is_correct():
    rec = readings.read(CELL, SEED, 8, rehearse=True, with_control=False)
    assert rec["rc"] == 0
    assert rec["correct"] is True, rec


def test_control_is_not_correct():
    rec = readings.read(CELL, SEED, 8, rehearse=True,
                        harness_sees="control")
    assert rec["rc"] == 0
    assert rec["correct"] is False, rec


@pytest.mark.parametrize("fault", sorted(readings.FAULTS))
def test_fault_is_not_correct(fault, monkeypatch):
    readings.plant(fault, monkeypatch.setattr)
    rec = readings.read(CELL, SEED, 8, rehearse=True, with_control=False)
    assert rec["rc"] == 0
    assert rec["correct"] is False, rec
