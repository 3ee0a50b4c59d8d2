"""A run with the timed path broken underneath reads ``correct`` false:
once for each fault a cell can have (half of a volume's frames left out,
the rest reconstructed twice; a stale answer, the volume before; a volume
frame altered where it is produced).  The look for a card is skipped; the rest of a run is driven on
the CPU at the tiny size."""

from __future__ import annotations

import pytest
import torch

from oct_bench.tests.test_oct_bench_harness import root, run_cpu  # noqa: F401


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


CSCAN = ("fdoct_tpu_torch.parallel.sharded", "sharded_cscan_volume")
FAULTS = [(w, CSCAN, f) for w in ("flagship-cscan512", "flir-cscan512")
          for f in (_half, _stale, _frame_altered)]


@pytest.mark.parametrize("workload,where,fault", FAULTS,
                         ids=[f"{w}-{f.__name__[1:]}" for w, _, f in FAULTS])
def test_a_broken_timed_path_is_not_correct(root, monkeypatch, capsys,  # noqa: F811
                                            workload, where, fault):
    import importlib
    mod = importlib.import_module(where[0])
    monkeypatch.setattr(mod, where[1], fault(getattr(mod, where[1])))
    rc, out, _ = run_cpu(root, monkeypatch, capsys, workload)
    assert rc == 0 and out["correct"] is False
    assert any(c["value"] is None or c["value"] > c["limit"] for c in out["checks"].values())
