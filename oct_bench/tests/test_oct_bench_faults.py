"""A run with the timed path broken underneath reads ``correct`` false:
once for each fault a cell can have (half of a volume's frames left out,
the rest reconstructed twice; a stale answer, the volume before; a volume
frame altered where it is produced), planted in each function of the
program that the cell's traffic kind names as its timed path
(``small/kinds/<kind>.json``).  The look for a card is skipped; the rest of
a run is driven on the CPU at the tiny size."""

from __future__ import annotations

import pytest
import torch

from oct_bench.catalog import Catalog
from oct_bench.tests.test_oct_bench_harness import CELLS, root, run_cpu  # noqa: F401
from oct_bench.tests.tiny import small


def _half(fn):
    def wrapper(frames, *a, **kw):
        n = frames.shape[0]
        return fn(frames[torch.arange(n) % max(1, n // 2)], *a, **kw)
    return wrapper


def _stale(fn):
    prev = {}

    def wrapper(*a, **kw):
        vol = fn(*a, **kw)
        last, prev["vol"] = prev.get("vol"), vol.clone()
        return vol if last is None else last
    return wrapper


def _frame_altered(fn):
    def wrapper(*a, **kw):
        vol = fn(*a, **kw).clone()
        vol[0] = vol[1]
        return vol
    return wrapper


FAULTS = [(w, f) for w in CELLS for f in (_half, _stale, _frame_altered)]


def run_broken(root, monkeypatch, capsys, workload, fault):
    """A tiny run of ``workload`` with ``fault`` planted in every function
    its traffic kind's ``timed`` names."""
    import importlib
    for module, name in small(root, "kinds", Catalog(root).cell(workload).traffic["kind"])["timed"]:
        mod = importlib.import_module(module)
        monkeypatch.setattr(mod, name, fault(getattr(mod, name)))
    return run_cpu(root, monkeypatch, capsys, workload)


def assert_not_correct(rc, out):
    assert rc == 0 and out["correct"] is False
    assert any(c["value"] is None or c["value"] > c["limit"] for c in out["checks"].values())


@pytest.mark.parametrize("workload,fault", FAULTS,
                         ids=[f"{w}-{f.__name__[1:]}" for w, f in FAULTS])
def test_a_broken_timed_path_is_not_correct(root, monkeypatch, capsys,  # noqa: F811
                                            workload, fault):
    rc, out, _ = run_broken(root, monkeypatch, capsys, workload, fault)
    assert_not_correct(rc, out)
