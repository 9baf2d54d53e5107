"""The control, one precision below the configuration's (int16 labels and
counts; bfloat16 maps), put in the program's place at a size a test can
hold: it comes out not correct where the program comes out correct."""

from __future__ import annotations

import pytest

from benchmark import control, harness
from benchmark.tests.toy_cells import toy_root


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return toy_root(tmp_path_factory.mktemp("bench"))


@pytest.mark.parametrize("cell", ["toy.segment.b32", "toy.refine.relief.b8",
                                  "toy.refine.q16tunnel.b8"])
@pytest.mark.parametrize("seed", [5, 2**31 + 3])
def test_the_control_fails_where_the_program_passes(root, cell, seed):
    spec = harness.load_spec(root, cell)
    ctl = control.control_readings(root, spec, seed, "cpu")
    assert any(v > lim for v, lim in ctl.values()), ctl
    prog = control.program_readings(root, spec, seed, "cpu")
    assert all(v <= lim for v, lim in prog.values()), prog
