"""Each cell's run, driven whole on the CPU at a tiny size with the
program's native core in the card's place: correct as it stands, and not
correct under the control or under any of the faults (a call that
returns its input unchanged, half of the blocks left out, one byte of
every answer altered, one byte of one block's answer altered, answers
that differ between calls, calls that fail)."""

import pytest

from gpubench import core, faults

from .helpers import TINY, entry


@pytest.mark.parametrize("mode", ("sound", "control") + faults.FAULTS)
@pytest.mark.parametrize("cell", sorted(TINY))
def test_the_check_finds_the_control_and_every_fault(cell, mode):
    r = core.run_cell(cell, 2**31 + 11, 0.6, False, on_card=False,
                      overrides=TINY[cell],
                      wrap=entry(cell, mode))
    assert r["attempted"] >= 1
    assert r["failed"] == (r["attempted"] if mode == "raises" else 0)
    assert r["correct"] is (mode == "sound"), r["checks"]
    assert list(r)[-1] == "checks"
    assert all(c["limit"] == 0 for c in r["checks"].values())
    if mode == "one_block":  # found whatever blocks the sample draws
        found = r["checks"].get("undecodable_blocks",
                                r["checks"]["bad_blocks"])["value"]
        assert found == (1 if "undecodable_blocks" in r["checks"]
                         else r["attempted"])


@pytest.mark.parametrize("cell", sorted(TINY))
def test_a_traced_run_reports_its_per_layer_metrics(cell):
    r = core.run_cell(cell, 99, 0.6, True, on_card=False,
                      overrides=TINY[cell],
                      wrap=entry(cell, "sound"))
    assert r["correct"]
    assert r["device"]["window_s"] > 0 and "breakdown" in r
    # on the CPU no device operation runs: the device readers read nothing
    assert r["metrics"] == {}
