"""On the card, at each cell's own size and load with a short window: the
program's runs are correct, and the control (the configuration's
``control_precision``, the next precision below the one it states) is not,
on three seeds.  Skips without a card; on the card:

    python -m pytest --noconftest -m cuda oct_bench/tests/test_oct_bench_card.py
"""

from __future__ import annotations

import pytest

from oct_bench import run
from oct_bench.catalog import Catalog
from oct_bench.tests.tiny import REPO

pytestmark = pytest.mark.cuda
CELLS = [w["name"] for w in Catalog(REPO).bench["workloads"]]
SEEDS = (4_100_000_001, 4_100_000_002, 4_100_000_003)


@pytest.fixture(scope="module")
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    run.fix_cache_dirs(REPO)


def _run(workload, seed, precision=None):
    argv = ["--workload", workload, "--seed", str(seed), "--seconds", "3"]
    return run.execute(run.parse(argv + (["--precision", precision] if precision else [])),
                       REPO)


@pytest.mark.parametrize("workload", CELLS)
def test_program_is_correct_and_its_control_is_not(card, workload):
    assert _run(workload, SEEDS[0])["correct"] is True
    control = Catalog(REPO).cell(workload).config["control_precision"]
    for seed in SEEDS:
        out = _run(workload, seed, control)
        assert out["correct"] is False, (seed, out["checks"])
