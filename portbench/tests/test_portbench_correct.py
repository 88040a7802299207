"""`correct` against its controls and faults, on the CPU.

The controls (the reference in the precision below the configuration's, in
the program's place) come out not correct at the published widths, cut in
batch size so that a test holds them. Each fault a cell can have, planted
under a whole run that skips only the look for a chip, makes `correct`
false.
"""

import pytest
import torch

from portbench import correct, harness
from portbench.kinds import infer
from portbench.tests.tiny import edit, run_cell, tiny_copy


@pytest.fixture(scope="module")
def wide(tmp_path_factory):
    """The published widths and depths; two rows a batch."""
    torch.set_num_threads(4)
    root = tiny_copy(tmp_path_factory.mktemp("wide"))
    b = root / "portbench"
    net = dict(network_g__num_feat=64, network_g__num_grow_ch=32, network_g__num_block=23)
    edit(b / "configs/esrgan_8s2.json", lr_size=32, **net)
    edit(b / "traffic/batch64_f32.json", batch_size=2, pool_batches=2, sample_batches=1)
    return root


WORKLOAD = "infer-esrgan_8s2-b64-f32"


@pytest.mark.parametrize("trunk_only", [False, True], ids=["every_conv", "trunk_only"])
def test_the_control_is_not_correct(wide, trunk_only):
    """TF32 in every conv, and in the dense blocks alone: the trunk carries
    enough of the output that a trunk computed in TF32 shows."""
    cell = harness.load_cell(WORKLOAD, wide)
    numbers = infer.control(cell, 2 ** 31 + 3, "cpu", trunk_only=trunk_only)
    ok, checks = correct.judge(numbers, cell.limits)
    assert not ok, checks


def test_a_sound_run_at_the_published_widths_is_correct(wide):
    rc, line = run_cell(wide, WORKLOAD)
    assert rc == 0 and line["correct"], line["checks"]


@pytest.mark.parametrize("fault", ["swapped_answers", "dropped_block"])
def test_a_fault_under_a_run_is_not_correct(wide, fault):
    cell = harness.load_cell(WORKLOAD, wide)
    with infer.FAULTS[fault](cell):
        rc, line = run_cell(wide, WORKLOAD)
    assert rc == 0 and line["correct"] is False, line["checks"]


def test_every_fault_is_listed():
    assert set(infer.FAULTS) == {"swapped_answers", "dropped_block"}
