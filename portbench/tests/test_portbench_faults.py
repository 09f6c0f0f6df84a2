"""The check catches each fault a cell can have: the rest of a run (no
look for a card; a tiny size on the CPU, float32 products) with the timed
path broken underneath comes out not correct, against the cell's own
limits; the same run unbroken comes out correct.  And the controls: the
lower-precision reference reads its numbers (here) and fails the limits
at the cell's size (on the card)."""

import pytest

from portbench.harness import cells, faults
from portbench.harness.runner import result
from conftest import context, tiny

CELLS = ["iq_big.serve_stream_b256", "iq_big.train_b512"]
CASES = [(c, k) for c in CELLS
         for k in (None, *faults.FAULTS[
             cells.find_cell(c).traffic["entry"]])]


@pytest.mark.parametrize("name,fault", CASES)
def test_faults_are_not_correct(bench, name, fault):
    cell = tiny(cells.find_cell(name, bench))
    ctx = context(cell, seed=2 ** 32 + 3, units=3)
    mod = cells.entry(cell.traffic)
    if fault is None:
        res = mod.run(ctx)
    else:
        with faults.plant(fault, cell.traffic["entry"]):
            res = mod.run(ctx)
    out = result(cell, res, False, {})
    assert out["correct"] is (fault is None), out["checks"]


@pytest.mark.parametrize("seed", [11, 2 ** 40 + 5, 3 ** 30])
def test_one_slot_fault_is_in_every_sample(bench, seed):
    """The token fault alters one slot of each batch; the check's whole
    batch holds every slot, however few requests it draws besides."""
    cell = tiny(cells.find_cell("iq_big.serve_stream_b256", bench))
    cell.traffic = dict(cell.traffic, check_requests=1)
    ctx = context(cell, seed=seed, units=6)
    with faults.plant("token", "serve_stream"):
        res = cells.entry(cell.traffic).run(ctx)
    out = result(cell, res, False, {})
    assert out["correct"] is False, out["checks"]


def test_serving_control_reads_on_the_cpu(bench):
    cell = tiny(cells.find_cell("iq_big.serve_stream_b256", bench))
    ctx = context(cell, control=True)
    res = cells.entry(cell.traffic).run(ctx)
    r = res["readings"]
    assert r["control_widest_gap"] > r["widest_gap"] >= 0.0


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["iq_big.serve_stream_b256",
                                  "iq_big.train_b512",
                                  "iq_big_vit.serve_stream_b256"])
def test_control_fails_at_the_cell_size(card, bench, name):
    """On the card, at the cell's own size, on three seeds: the float8
    reference in the program's place fails one of the cell's numbers."""
    import sys
    from portbench.entries import train_step
    from portbench.harness.runner import RunContext
    from portbench.reference.iq import fp8_gradient, fp8_operand
    cell = cells.find_cell(name, bench)
    for seed in (101, 102, 103):
        ctx = RunContext(cell, seed, 0.0, False, card, 0.0,
                         log=lambda s: print(s, file=sys.stderr))
        if cell.traffic["entry"] == "train_step":
            got = train_step.compare(
                train_step.reference_readings(ctx, operand=fp8_operand,
                                              gradient=fp8_gradient),
                train_step.reference_readings(ctx))
            readings = {k: got[k] for k in cell.limits}
        else:
            ctx.control = True
            res = cells.entry(cell.traffic).run(ctx)
            readings = {"widest_gap": res["readings"]["control_widest_gap"]}
        assert any(readings[k] > cell.limits[k] for k in readings), readings
