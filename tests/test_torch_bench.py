"""``fdoct-torch bench`` (fdoct_tpu_torch/bench.py) against the JAX package's
``bench.py`` at a small shape on the CPU: the group steps of its rows, the
keys of its JSON line, its publication checks and its C++ baseline.

The group steps are compared on the same numpy frames and one operator (the
port's calibration made from the JAX one's leaves; the int8 rows on one plan):
uint8 displays within one level (the kernels' plain versions sum in another
order than XLA).  Timings on the CPU say nothing about the card, so the
cases that run ``main`` replace its clock by one that charges each chained
run its number of groups (every row still runs); the clock itself, CUDA
events, is read only on the card.
"""

import ast
import dataclasses
import json
import os
from pathlib import Path

import numpy as np
import pytest
import torch

jnp = pytest.importorskip("jax.numpy")   # the JAX reference; without it (a GPU-only host) skip

from fdoct_tpu.calibration import Calibration as JaxCalibration
from fdoct_tpu.config import PipelineConfig as JaxConfig
from fdoct_tpu.int8direct import Int8DirectPlan as JaxPlan
from fdoct_tpu.int8direct import reconstruct_int8_direct as jax_int8
from fdoct_tpu.int8direct import shift_u8_to_s8 as jax_shift
from fdoct_tpu.pipeline import form_bscan as jax_form_bscan
from fdoct_tpu.pipeline import reconstruct as jax_reconstruct
from fdoct_tpu_torch import bench, cli
from fdoct_tpu_torch.calibration import Calibration
from fdoct_tpu_torch.graphs import NoHostSync
from fdoct_tpu_torch.int8direct import Int8DirectPlan

ROOT = Path(__file__).resolve().parent.parent
SMALL = bench.Shape(rows=32, cols=256, nfft=256, ndisp=64, batch=2, g1=2, g2=4,
                    batched_g1=2, batched_g2=4, repeats=2)
CAL_LEAVES = ("op_re", "op_im", "window", "nearest_idx", "frac", "phase", "lambdas", "k",
              "klinear")
PLAN_LEAVES = ("oq_re", "oq_im", "s_re", "s_im", "row_gain_inv", "const_re", "const_im",
               "bg_rank1_resid")


def bench_py_keys() -> set[str]:
    """Every key bench.py's JSON line can carry: the ``out`` literal's and
    every ``out["..."]`` assigned (bench.py:347-378)."""
    tree = ast.parse((ROOT / "bench.py").read_text())
    keys = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Assign) and isinstance(node.value, ast.Dict) and any(
                isinstance(t, ast.Name) and t.id == "out" for t in node.targets):
            keys |= {k.value for k in node.value.keys}
        if isinstance(node, ast.Subscript) and isinstance(node.value, ast.Name) \
                and node.value.id == "out" and isinstance(node.slice, ast.Constant):
            keys.add(node.slice.value)
    return keys


@pytest.fixture(scope="module")
def pair():
    """(JAX config, calibration and plan; the port's harness on the same M
    and plan) at SMALL."""
    tcfg = bench.config(SMALL)
    jcfg = JaxConfig(**dataclasses.asdict(tcfg))
    jcal = JaxCalibration.create(jcfg)
    tcal = Calibration.from_arrays({n: np.asarray(getattr(jcal, n)) for n in CAL_LEAVES},
                                   tcfg, "cpu")
    jplan = JaxPlan.create(jcal, jcfg.replace(matmul_precision="int8_direct"),
                           bench.synthetic_background(SMALL),
                           np.zeros((SMALL.rows, SMALL.cols)))
    tplan = Int8DirectPlan.from_arrays({n: np.asarray(getattr(jplan, n)) for n in PLAN_LEAVES},
                                       "cpu")
    harness = dataclasses.replace(bench.Harness.create(SMALL, "cpu"), calib=tcal, plan=tplan)
    return jcfg, jcal, jplan, harness


def frames(groups: int, seed: int = 0) -> np.ndarray:
    return np.random.default_rng(seed).integers(
        0, 255, (groups, SMALL.batch, SMALL.rows, SMALL.cols)).astype(np.uint8)


def assert_within_one_level(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.dtype == want.dtype == np.uint8 and got.shape == want.shape
    assert np.abs(got.astype(int) - want.astype(int)).max() <= 1


def test_group_step_matches_jax(pair):
    """The headline's group step (kernel 1's route) against bench.py's
    ``group_step`` (bench.py:102-106) on the same frames."""
    jcfg, jcal, _, harness = pair
    bg = jnp.full((SMALL.rows, SMALL.cols), 128.0, jnp.float32)
    pi = jnp.zeros((SMALL.rows, SMALL.cols), jnp.float32)
    for fr in frames(3):
        mags = jax_reconstruct(jnp.asarray(fr), bg, pi, jcal, jcfg, method="fused")
        want = jax_form_bscan(mags.sum(axis=0), jcfg, averages=SMALL.batch).bscandisp
        assert_within_one_level(harness.group_step(torch.as_tensor(fr)).numpy(), want)


def test_int8_step_matches_jax(pair):
    """The int8_direct group step against bench.py's (bench.py:287-296) on
    one plan."""
    jcfg, _, jplan, harness = pair
    for fr in frames(3, seed=1):
        m = jax_int8(jax_shift(jnp.asarray(fr)), jplan)
        want = jax_form_bscan(m.sum(axis=0), jcfg, averages=SMALL.batch).bscandisp
        assert_within_one_level(harness.int8_step(torch.as_tensor(fr)).numpy(), want)


def test_batched_displays_equal_the_scan_rows(pair):
    """The batched rows compute each group's display as the scan-chained
    rows do."""
    harness = pair[3]
    all_frames = torch.as_tensor(frames(3, seed=2))
    np.testing.assert_array_equal(harness.batched_displays(all_frames).numpy(),
                                  np.stack([harness.group_step(f).numpy() for f in all_frames]))
    np.testing.assert_array_equal(harness.int8_batched_displays(all_frames).numpy(),
                                  np.stack([harness.int8_step(f).numpy() for f in all_frames]))


def test_chained_runs_carry_every_display(pair):
    """scan_groups carries the sum of every group's display, as bench.py's
    scan does."""
    harness = pair[3]
    all_frames = torch.as_tensor(frames(2, seed=3))
    want = sum(int(harness.group_step(f).sum()) for f in all_frames)
    assert float(harness.scan_groups(all_frames)) == want
    want8 = sum(int(harness.int8_step(f).sum()) for f in all_frames)
    assert float(harness.int8_groups(all_frames)) == want8


@pytest.mark.parametrize("chain", ["_scan_chain", "_int8_chain", "_ref_chain", "_batched_chain",
                                   "_int8_batched_chain"])
def test_chains_make_no_host_synchronisation(pair, chain):
    """On the card each chained row is one replay of its chain's CUDA graph,
    the counterpart of bench.py's ``jax.jit`` of a ``lax.scan``; a graph
    captures a chain that reads no device value on the host, which
    NoHostSync shows here.  The row's method gives the chain's value."""
    harness = pair[3]
    all_frames = torch.as_tensor(frames(2, seed=5))
    with NoHostSync():
        got = getattr(harness, chain)(all_frames)
    assert got.ndim == 0
    row = {"_scan_chain": "scan_groups", "_int8_chain": "int8_groups", "_ref_chain": "ref_groups",
           "_batched_chain": "batched_groups", "_int8_batched_chain": "int8_batched"}[chain]
    assert float(getattr(harness, row)(all_frames)) == float(got)


def test_reference_product_keeps_float32_sums(pair):
    """The bare-matmul reference: bf16 frames times the bf16 operator pair
    with float32 sums (bench.py:138-143)."""
    harness = pair[3]
    all_frames = torch.as_tensor(frames(1, seed=4))
    z = all_frames[0].reshape(-1, SMALL.cols).double()
    want = sum(float((z @ op.double()).sum()) for op in
               (harness.calib.op_re_bf16, harness.calib.op_im_bf16))
    np.testing.assert_allclose(float(harness.ref_groups(all_frames)), want, rtol=1e-4)


def test_gen_frames_are_seeded_u8():
    a, b = bench.gen_frames(SMALL, 2, torch.device("cpu")), bench.gen_frames(SMALL, 2, "cpu")
    assert a.dtype == torch.uint8 and a.shape == (2, SMALL.batch, SMALL.rows, SMALL.cols)
    assert torch.equal(a, b) and int(a.max()) <= 254


@pytest.fixture(scope="module")
def baseline_dir(tmp_path_factory):
    """One build directory for the module's C++ baseline (built once)."""
    return tmp_path_factory.mktemp("build")


def group_clock(fn, fr):
    """Runs the chained ``fn`` and charges it 1 ms a group."""
    fn(fr)
    return len(fr) * 1e-3


@pytest.fixture
def run_main(monkeypatch, baseline_dir, capsys):
    """``bench.main`` at SMALL on the CPU with :func:`group_clock`; returns
    (exit status, the JSON line, stderr)."""
    monkeypatch.setattr(bench, "FLAGSHIP", SMALL)
    monkeypatch.setattr(bench, "BUILD_DIR", baseline_dir)
    monkeypatch.setattr(bench, "BASELINE_SECONDS", 0.2)
    monkeypatch.setattr(bench, "run_seconds", group_clock)

    def run(argv=("bench", "--device", "cpu")):
        rc = cli.main(list(argv))
        out = capsys.readouterr()
        lines = out.out.strip().splitlines()
        return rc, json.loads(lines[-1]), out.err

    return run


def test_json_line_has_every_bench_py_key(run_main):
    rc, out, err = run_main()
    assert rc == 0
    keys = bench_py_keys()
    assert keys == set(bench.BENCH_PY_KEYS)           # chip_smoke.py checks the card's by it
    assert {k for row in bench.ROW_KEYS.values() for k in row} <= keys
    assert keys <= set(out)
    assert out["metric"] == "ascans_per_sec_per_chip_2048px" and out["unit"] == "ascans/s"
    # 1 ms a group, 2 x 32 A-scans a group
    assert out["value"] == SMALL.batch * SMALL.rows / 1e-3
    assert out["dropped"] == {} and out["timer"] == "host_clock"
    assert out["device"]["power_limit_w"] is None          # no card: nothing made up
    assert out["vs_baseline"] > 0 and "baseline_error" not in out
    for row in ("headline", "headline_ref", "batched", "int8_direct", "int8_batched"):
        assert out[f"{row}_spread"] == 0.0
    # every headline group ran (the CPU calls count no launch)
    assert out["headline_groups"] == (1 + SMALL.repeats) * (SMALL.g1 + SMALL.g2)
    assert out["headline_launches"] == 0
    assert "host-inclusive streaming" in err


def test_a_row_failing_a_check_is_dropped_with_its_reason(run_main, monkeypatch):
    """A batched row whose medians do not difference positively is named in
    "dropped" with the check's words, its keys left out; the other rows
    stand."""
    def clock(fn, fr):
        fn(fr)
        slow = getattr(fn, "__name__", "") == "batched_groups"
        return (10 - len(fr) if slow else len(fr)) * 1e-3

    monkeypatch.setattr(bench, "run_seconds", clock)
    rc, out, _ = run_main()
    assert rc == 0
    assert set(out["dropped"]) == {"batched"}
    assert out["dropped"]["batched"].startswith("inconsistent batched timings t(2)=")
    assert not set(bench.ROW_KEYS["batched"]) & set(out)
    assert bench_py_keys() - set(out) == set(bench.ROW_KEYS["batched"])
    assert out["int8_batched_ref_ratio"] == 1.0


@pytest.mark.parametrize("case,match", [
    ("inconsistent", "inconsistent row timings"),
    ("ref-spread", "row ref timings untrustworthy"),
    ("ratio", "row ratio 4.00 outside the physical"),
])
def test_publication_checks(monkeypatch, case, match):
    """The three checks of bench.py's per_group_paired (bench.py:209-226)."""
    samples = {("fn", 2): [2.0], ("fn", 4): [1.0 if case == "inconsistent" else 4.0],
               ("ref", 2): [1.0, 1.0, 1.6] if case == "ref-spread" else [1.0],
               ("ref", 4): [2.0] if case != "ratio" else [1.5]}
    calls = {}

    def clock(fn, fr):
        key = (fn.__name__, len(fr))
        i = calls.get(key, 0)
        calls[key] = i + 1
        return samples[key][i % len(samples[key])]

    def fn(fr):
        pass

    def ref(fr):
        pass

    monkeypatch.setattr(bench, "run_seconds", clock)
    with pytest.raises(bench.Dropped, match=match):
        bench.per_group_paired("row", fn, ref, [0, 0], [0, 0, 0, 0], repeats=3)


def test_inconsistent_headline_exits_1(run_main, monkeypatch):
    monkeypatch.setattr(bench, "run_seconds", lambda fn, fr: 1.0 / len(fr))
    with pytest.raises(SystemExit) as e:
        run_main()
    assert e.value.code == 1


def test_failing_gxx_gives_null_baseline(run_main, monkeypatch, tmp_path):
    """Where the C++ baseline cannot be built, vs_baseline is null and
    baseline_error says why: no constant from another machine."""
    fake = tmp_path / "bin"
    fake.mkdir()
    (fake / "g++").write_text("#!/bin/sh\necho 'no compiler here' >&2\nexit 1\n")
    (fake / "g++").chmod(0o755)
    monkeypatch.setenv("PATH", f"{fake}{os.pathsep}{os.environ['PATH']}")
    monkeypatch.setattr(bench, "BUILD_DIR", tmp_path / "build")
    rc, out, err = run_main()
    assert rc == 0
    assert out["vs_baseline"] is None
    assert "CalledProcessError" in out["baseline_error"]
    assert "no compiler here" in out["baseline_error"]
    assert "15359" not in json.dumps(out)
    assert "baseline compile/run failed" in err
    assert not list((tmp_path / "build").glob("*.json"))       # a failure is not cached


def test_cpp_baseline_builds_runs_and_caches(baseline_dir, monkeypatch):
    monkeypatch.setattr(bench, "BASELINE_SECONDS", 0.2)
    val, why = bench.cpp_baseline_ascans_per_sec(SMALL, baseline_dir)
    assert why is None and val > 0
    cached = list(baseline_dir.glob("cpu_baseline-*-32x256x256x64.json"))
    assert len(cached) == 1 and json.loads(cached[0].read_text())["ascans_per_sec"] == val
    assert not list(baseline_dir.glob("*.tmp"))
    monkeypatch.setattr(bench.subprocess, "run", None)          # the cache answers
    assert bench.cpp_baseline_ascans_per_sec(SMALL, baseline_dir) == (val, None)


def test_cli_bench_without_a_card_fails_loudly():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device runs")
    with pytest.raises(SystemExit, match="--device cuda: torch.cuda.is_available"):
        cli.main(["bench"])


def test_bench_takes_only_device(capsys):
    """`fdoct bench` has no argument; the port's adds --device alone."""
    with pytest.raises(SystemExit):
        cli.main(["bench", "--groups", "4"])
    assert "unrecognized arguments: --groups" in capsys.readouterr().err
