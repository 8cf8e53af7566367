"""A run's ``correct`` at a size a CPU holds: true for the sound program,
false for each fault the cell can have planted under the timed path, and
false for the precision control put in the program's place.

The program runs in float32 here, so that a sound run reads round-off
against the reference; the cells' limits are those of the card at full
size.  ``test_control_on_the_card`` runs the control at a cell's own size
on a card."""

import copy

import pytest

from portbench import controls, harness
from portbench.test_portbench_harness import tiny_hourglass, tiny_hrnet

# every cell of BENCHMARK.json: (configuration, traffic mix)
CELLS = {w["name"]: (w["config"], w["traffic"])
         for w in harness.manifest()["workloads"]}
# the cell each traffic kind's faults are planted in
BY_KIND = {"train": "hg_fpd_mpii.train",
           "crops": "hrnet_fpd_coco.serve_crops"}


def tiny(cell: str):
    """(config, traffic, limits) of ``cell`` cut to a CPU's size."""
    config, traffic = CELLS[cell]
    cfg = copy.deepcopy(harness.data("configs", config))
    mix = dict(harness.data("traffic", traffic))
    s = cfg["student"]
    s["TPU"]["COMPUTE_DTYPE"] = "float32"
    s["TRAIN"]["BATCH_SIZE_PER_GPU"] = s["TEST"]["BATCH_SIZE_PER_GPU"] = 4
    if s["MODEL"]["NAME"] == "hourglass":
        s["MODEL"].update(tiny_hourglass(stacks=2, features=16))
        cfg["teacher"]["MODEL"].update(tiny_hourglass(stacks=2, features=32))
    else:
        s["MODEL"].update(tiny_hrnet(8))
        cfg["teacher"]["MODEL"].update(tiny_hrnet(12))
    if mix["kind"] == "crops":
        mix.update(crops_per_call=8, pool_calls=2, sample_crops=8)
    return cfg, mix, harness.data("limits", cell)


CASES = [("train", None), ("train", "unchanged"), ("train", "half_batch"),
         ("crops", None), ("crops", "half_batch"), ("crops", "altered")]


@pytest.mark.parametrize("kind,fault", CASES,
                         ids=[f"{k}-{f or 'sound'}" for k, f in CASES])
def test_correct_catches_each_fault(kind, fault):
    cell = BY_KIND[kind]
    cfg, mix, lim = tiny(cell)
    r = harness.run_cell(cell, 2 ** 31 + 7, 0.5, False, "cpu",
                         config=cfg, traffic=mix, limits=lim, fault=fault)
    assert r["correct"] is (fault is None), r["checks"]
    assert r["attempted"] >= 1 and list(r)[-1] == "checks"


@pytest.mark.parametrize("cell", sorted(CELLS))
def test_control_fails(cell):
    """The reference with fp8 operands in the program's place comes out
    not correct, through the harness's own comparison."""
    cfg, mix, lim = tiny(cell)
    r = harness.run_cell(cell, 11, 0.2, False, "cpu", config=cfg,
                         traffic=mix, limits=lim, control=True)
    assert r["correct"] is False, r["checks"]


@pytest.mark.card
@pytest.mark.parametrize("cell", sorted(
    w["name"] for w in harness.manifest()["workloads"]))
def test_control_on_the_card(card, cell):
    """At each cell's own size on the card."""
    r = controls.control(cell, 3, 0.5, card)
    assert r["correct"] is False, r["checks"]
