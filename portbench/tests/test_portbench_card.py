"""On the card: each cell runs through `portbench/run.py` and prints a
result line of the contract's shape, and the fp8 control fails the cell's
limits at the cell's own size while the program passes them.  Run on the
card with `python -m pytest portbench/tests -m card`."""

import json
import subprocess
import sys

import pytest

from portbench import compare, readings, run

CELLS = [w["name"] for w in run.benchmark()["workloads"]]


@pytest.mark.card
@pytest.mark.parametrize("name", CELLS)
def test_a_cell_runs_on_the_card(card, name):
    out = subprocess.run([sys.executable, str(run.ROOT / "portbench" / "run.py"), "--workload",
                          name, "--seed", str(2 ** 31 + 5), "--seconds", "1", "--trace", "0"],
                         capture_output=True, text=True, timeout=900, check=True)
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["correct"] and res["device"]["platform"] == "gpu"
    assert res["device"]["kind"] == card and res["device"]["count"] == 1
    assert "setup_s" in res["metrics"] and list(res)[-1] == "checks"


@pytest.mark.card
@pytest.mark.parametrize("name", CELLS)
def test_the_control_fails_at_the_cells_size(card, name):
    for seed in (2 ** 31 + 11, 2 ** 31 + 12, 2 ** 31 + 13):
        got = readings.readings(name, seed, 1.0)
        lims = compare.limits(name)
        assert compare.judge(got["program"], lims)[0], got["program"]
        assert not compare.judge(got["control"], lims)[0], got["control"]
