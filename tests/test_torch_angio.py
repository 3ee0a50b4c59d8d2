"""OCT angiography (SSADA, ``fdoct_tpu_torch.angio``) against the plain
reference ``oct_bench/reference/ssada_ref.py`` on the CPU, at a small size.

    python -m pytest tests/test_torch_angio.py -q

The split-spectrum operator, the volume in float64 and float32, its
precision policy, the mesh contract, ``cscan --angio``, the spans and
counters, and the full-band operator M of the benchmark's configurations,
bit for bit the chain as it was written before the split-spectrum
operator shared it.  This file imports no JAX.
"""

from __future__ import annotations

import json
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from fdoct_tpu_torch import angio, calibration, cli, pipeline
from fdoct_tpu_torch.config import PipelineConfig
from fdoct_tpu_torch.ops import windows
from fdoct_tpu_torch.ops.resample import resample_matrix
from fdoct_tpu_torch.parallel import sharded_angio_volume
from fdoct_tpu_torch.utils import profiling
from fdoct_tpu_torch.utils.imageio import read_png
from fdoct_tpu_torch.utils.profiling import StageTimer
from oct_bench import frames as bench_frames
from oct_bench.reference import ssada_ref
from oct_bench.reference.oct_ref import RefConfig

ROOT = Path(__file__).resolve().parents[1]
CPU = torch.device("cpu")
SMALL = dict(width=256, height=24, numfftpoints=256, numdisplaypoints=96,
             lambdamin=7.99e-7, lambdamax=8.81e-7, averages=1)
#: a second shape: ×2 spectral zero-pad and the exact (non-compat) resample
PADDED = dict(SMALL, width=128, numfftpoints=384, increasefftpointsmultiplier=2, compat=False)
FRAMES = 8
SEED = 3_000_000_019
#: float32 'highest' against the float64 reference.  Each magnitude is a
#: float32 product over 256 camera samples, whose rounding leaves ~3e-7 of
#: the B-scan's largest magnitude; D divides (Aₙ − Aₙ₊₁)² by Aₙ² + Aₙ₊₁²,
#: which magnifies that above the floor to ~4e-6.  The bounds keep ~30× room;
#: bf16-rounded operands ('default' on the card) read ~2e-3 and ~2e-2.
F32_STRUCTURE_TOL = 1e-5
F32_DECORR_TOL = 1e-4


def cfg_of(shape=SMALL, **kw) -> PipelineConfig:
    return PipelineConfig(**{**shape, **kw}).validate()


def ref_cfg(shape=SMALL) -> RefConfig:
    names = set(RefConfig.__dataclass_fields__)
    return RefConfig(**{k: v for k, v in shape.items() if k in names})


def volume_inputs(cfg, seed: int = SEED, n: int = FRAMES, repeats: int = 2):
    """Seeded position-major frames (each repeat after the first keeps half
    of the first's rows), S(k) floored at 1 and a zero π, float64."""
    g = bench_frames.generator(seed, CPU)
    raw = bench_frames.sample_frames(cfg, n, g, CPU)
    v = raw.view(n // repeats, repeats, cfg.height, cfg.width)
    keep = torch.rand((n // repeats, repeats - 1, cfg.height, 1), generator=g) < 0.5
    v[:, 1:] = torch.where(keep, v[:, :1], v[:, 1:])
    bg = torch.clamp_min(bench_frames.background_frames(cfg, 1, g, CPU)[0].double(), 1.0)
    return raw, bg, torch.zeros_like(bg)


def program(cfg, raw, bg, pi, acfg=angio.AngioConfig()):
    """(structure, decorrelation) of ``sharded_angio_volume`` on one device."""
    dt = getattr(torch, cfg.dtype)
    op = angio.SplitSpectrumOperator.create(cfg, acfg, CPU)
    return tuple(sharded_angio_volume(raw, bg.to(dt), pi.to(dt), op, cfg, acfg=acfg))


def reference(shape, raw, bg, pi):
    return ssada_ref.angio_volume(raw.to(torch.int32), bg, pi, ref_cfg(shape),
                                  ssada_ref.RefAngio())


def gaps(got, want):
    """(max |Δstructure| / max structure, max |ΔD| where the reference's
    structure is above the floor)."""
    (s, d), (rs, rd) = got, want
    mask = ssada_ref.mask(rs)
    return (float((s.double() - rs).abs().max() / rs.abs().max()),
            float((d.double() - rd).abs()[mask].max()))


# ---------------------------------------------------------------------------
# the operator


@pytest.mark.parametrize("shape", [SMALL, PADDED], ids=["small", "padded"])
def test_stacked_operator_is_the_references_stepwise_route(shape):
    """Each block of [M | M₁ … M₄] applied to ratio rows equals the
    reference's steps for its band (DC removal, × barthann for the full
    band, resample, × gₘ for a band, inverse FFT, |·|)."""
    cfg = cfg_of(shape, dtype="float64")
    acfg = angio.AngioConfig()
    op = angio.SplitSpectrumOperator.create(cfg, acfg, CPU)
    rows = torch.rand((40, cfg.width), generator=torch.Generator().manual_seed(7),
                      dtype=torch.float64) + 0.5
    got = torch.sqrt((rows @ op.op_re) ** 2 + (rows @ op.op_im) ** 2)
    rc = ref_cfg(shape)
    want = ssada_ref.band_mags(rows, rc, ssada_ref.RefAngio(), ssada_ref.grids(rc, CPU),
                               ssada_ref.band_weights(rc, ssada_ref.RefAngio(), CPU))
    assert op.op_re.shape == (cfg.width, 5 * rc.ndisp)
    got = got.view(40, 5, rc.ndisp)
    for b in range(5):
        err = (got[:, b] - want[:, b]).abs().max() / want[:, b].abs().max()
        assert err < 1e-10, (b, float(err))


def test_full_band_block_is_the_calibrations_m():
    cfg = cfg_of(dtype="float64")
    op = angio.SplitSpectrumOperator.create(cfg, angio.AngioConfig(), CPU)
    cal = calibration.Calibration.create(cfg, CPU)
    assert torch.equal(op.op_re[:, :cfg.numdisplaypoints], cal.op_re)
    assert torch.equal(op.op_im[:, :cfg.numdisplaypoints], cal.op_im)
    assert op.op_re_bf16.dtype == torch.bfloat16
    assert torch.equal(op.op_re_bf16, op.op_re.to(torch.bfloat16))


def _fused_operator_as_written_before(cfg, g):
    """``calibration._fused_operator`` as it was before the split-spectrum
    operator shared its chain, line for line."""
    opw = cfg.opw
    mult = max(cfg.increasefftpointsmultiplier, 1)
    nfft = cfg.numfftpoints
    ndisp = min(cfg.numdisplaypoints, nfft)
    win = windows.get_window(cfg.window, opw).astype(np.float64)
    if cfg.dispersion_a2 or cfg.dispersion_a3:
        kl = g["klinear"]
        x = (kl - (kl[0] + kl[-1]) / 2) / ((kl[-1] - kl[0]) / 2)
        phase = cfg.dispersion_a2 * x**2 + cfg.dispersion_a3 * x**3
    else:
        phase = np.zeros(nfft)
    E = np.eye(opw)
    X = (E - E.mean(axis=-1, keepdims=True)) * win
    X = calibration._np_zeropad_rowwise(X, mult, cfg.bandpassfilter)
    X = X @ resample_matrix(g["nearest_idx"], g["frac"], opw * mult, compat=cfg.compat)
    F = np.exp((2j * np.pi / nfft) * (np.arange(nfft)[:, None] * np.arange(ndisp)[None, :]))
    if phase.any():
        F = np.exp(1j * phase)[:, None] * F
    M = X.astype(complex) @ F
    return dict(window=win, phase=phase, op_re=M.real, op_im=M.imag)


@pytest.mark.parametrize("name", ["flagship-2048-u8", "flir-spinjnt-720-u16", "dispersion"])
def test_the_benchmarks_operators_are_bit_for_bit_as_before(name):
    if name == "dispersion":
        cfg = cfg_of(SMALL, dispersion_a2=3.0, dispersion_a3=-1.5, window="tukey")
    else:
        conf = json.loads((ROOT / "oct_bench/configs" / f"{name}.json").read_text())
        cfg = PipelineConfig(**conf["pipeline"]).validate()
    g = calibration.reference_grids(cfg)
    got = calibration._fused_operator(cfg, g)
    want = _fused_operator_as_written_before(cfg, g)
    assert set(got) == set(want)
    for key in want:
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)


def test_gaussian_bands():
    """Each band peaks at 1 on its centre and is half that a half width away."""
    w = calibration.gaussian_bands(256, [32.0, 160.0], 100.0)
    assert w.shape == (2, 256) and w[0, 32] == 1.0 and w[1, 160] == 1.0
    np.testing.assert_allclose(w[:, [82, 110]].diagonal(), [0.5, 0.5], rtol=1e-15)
    assert angio.AngioConfig().centres() == (0.125, 0.375, 0.625, 0.875)


# ---------------------------------------------------------------------------
# the volume against the reference


@pytest.mark.parametrize("shape", [SMALL, PADDED], ids=["small", "padded"])
def test_float64_volume_matches_the_reference(shape):
    cfg = cfg_of(shape, dtype="float64", matmul_precision="highest")
    raw, bg, pi = volume_inputs(cfg)
    s, d = program(cfg, raw, bg, pi)
    rs, rd = reference(shape, raw, bg, pi)
    assert s.shape == d.shape == (FRAMES // 2, cfg.numdisplaypoints, cfg.height)
    assert s.dtype == d.dtype == torch.float64
    np.testing.assert_allclose(s.numpy(), rs.numpy(), rtol=1e-9, atol=1e-9 * float(rs.max()))
    np.testing.assert_allclose(d.numpy(), rd.numpy(), rtol=1e-9, atol=1e-9)
    assert 0.02 < float(rd.mean()) < 0.98               # the repeats do decorrelate


def test_float32_highest_holds_the_tolerance_and_default_on_the_card_does_not(monkeypatch):
    cfg = cfg_of(dtype="float32", matmul_precision="highest")
    raw, bg, pi = volume_inputs(cfg)
    want = reference(SMALL, raw, bg, pi)
    got = program(cfg, raw, bg, pi)
    assert got[0].dtype == torch.float32
    s_gap, d_gap = gaps(got, want)
    assert s_gap < F32_STRUCTURE_TOL and d_gap < F32_DECORR_TOL, (s_gap, d_gap)
    # 'default' as the card runs it: the products on bf16-rounded operands
    use_bf16 = pipeline.use_bf16
    monkeypatch.setattr(pipeline, "use_bf16",
                        lambda precision, dtype, device: use_bf16(precision, dtype,
                                                                  torch.device("cuda")))
    s_gap, d_gap = gaps(program(cfg_of(dtype="float32", matmul_precision="default"),
                               raw, bg, pi), want)
    assert s_gap > F32_STRUCTURE_TOL and d_gap > F32_DECORR_TOL, (s_gap, d_gap)


def test_identical_repeats_do_not_decorrelate():
    cfg = cfg_of(dtype="float32", matmul_precision="highest")
    raw, bg, pi = volume_inputs(cfg)
    raw[1::2] = raw[0::2]
    s, d = program(cfg, raw, bg, pi)
    assert float(d.abs().max()) <= 1e-12
    rs, rd = reference(SMALL, raw, bg, pi)
    assert float(rd.abs().max()) <= 1e-12


def test_zero_magnitudes_count_as_agreeing():
    mags = torch.zeros((4, 2, 5 * 3))                    # 2 positions × 2 repeats, 2 rows
    mags[2:, :, 3:] = torch.arange(1.0, 13.0)           # position 1: bands non-zero
    mags[3, :, 3:] = 0.0                                 # … and its second repeat zero
    s, d = angio.ssada(mags, 2, 4)
    assert torch.equal(d[0], torch.zeros(2, 3))          # both repeats zero: D = 0
    assert torch.equal(d[1], torch.ones(2, 3))           # one repeat zero: D = 1
    ref = ssada_ref.ssada(mags.double().view(2, 2, 2, 5, 3), ssada_ref.RefAngio())
    assert torch.equal(ref[1], d.double())


def test_three_repeats_average_the_pairs():
    cfg = cfg_of(dtype="float64", matmul_precision="highest")
    raw, bg, pi = volume_inputs(cfg, n=9, repeats=3)
    acfg = angio.AngioConfig(repeats=3)
    s, d = program(cfg, raw, bg, pi, acfg)
    rs, rd = ssada_ref.angio_volume(raw.to(torch.int32), bg, pi, ref_cfg(),
                                    ssada_ref.RefAngio(repeats=3))
    assert s.shape == (3, cfg.numdisplaypoints, cfg.height)
    np.testing.assert_allclose(d.numpy(), rd.numpy(), rtol=1e-9, atol=1e-9)


@pytest.mark.parametrize("precision", angio.INT8_PRECISIONS)
def test_int8_precisions_are_refused(precision):
    cfg = cfg_of(dtype="float32", matmul_precision=precision)
    raw, bg, pi = volume_inputs(cfg)
    with pytest.raises(ValueError, match="no int8 band tables"):
        program(cfg, raw, bg, pi)


def test_angiogram_masks_as_octa_bscan_does():
    s = torch.tensor([[[1.0, 10.0], [0.5, 2.0]]])
    d = torch.full_like(s, 0.75)
    got = angio.angiogram(s, d)
    assert got.tolist() == [[[0.0, 0.75], [0.0, 0.75]]]  # 1.0 is not above 0.1 × 10
    ref = torch.where(ssada_ref.mask(s.double()), d.double(), 0.0)
    assert torch.equal(ref.float(), got)


def test_views_match_the_references():
    cfg = cfg_of(dtype="float64", matmul_precision="highest")
    raw, bg, pi = volume_inputs(cfg)
    s, d = program(cfg, raw, bg, pi)
    got = angio.angio_views(s, d)
    want = ssada_ref.angio_views(*reference(SMALL, raw, bg, pi))
    for key in ("angio_enface", "structure_mip"):
        assert got[key].dtype == torch.uint8 and got[key].shape == (FRAMES // 2, cfg.height)
        assert torch.equal(got[key], want[key]), key


def test_config_from_a_file_object():
    conf = json.loads((ROOT / "oct_bench/configs/octa500-6mm-ssada.json").read_text())
    acfg = angio.AngioConfig.from_dict(conf["angio"])
    assert acfg == angio.AngioConfig()
    assert ssada_ref.RefAngio.from_config(conf["angio"]) == ssada_ref.RefAngio()
    with pytest.raises(ValueError, match="method"):
        angio.AngioConfig.from_dict({"method": "cmOCT"})
    with pytest.raises(ValueError, match="maximum projection"):
        angio.AngioConfig.from_dict({"projection": "mean"})
    with pytest.raises(ValueError, match="repeats"):
        angio.AngioConfig(repeats=1).validate()


@pytest.mark.parametrize("key", ["band_centres", "band_width", "floor_frac"])
def test_settings_with_one_value_are_refused_as_keys(key):
    """The band centres, band width and noise floor are constants of the
    program and of the reference, not settings of a configuration file."""
    with pytest.raises(ValueError, match=key):
        angio.AngioConfig.from_dict({"repeats": 2, key: 0.4})
    with pytest.raises(ValueError, match=key):
        ssada_ref.RefAngio.from_config({"repeats": 2, key: 0.4})
    assert angio.BAND_WIDTH == ssada_ref.BAND_WIDTH == 0.4
    assert angio.FLOOR_FRAC == ssada_ref.FLOOR_FRAC == 0.1


# ---------------------------------------------------------------------------
# sharded_angio_volume: the mesh contract


def test_sharded_volume_stacks_structure_and_decorrelation():
    cfg = cfg_of(dtype="float32", matmul_precision="highest")
    raw, bg, pi = volume_inputs(cfg)
    acfg = angio.AngioConfig()
    op = angio.SplitSpectrumOperator.create(cfg, acfg, CPU)
    vol = sharded_angio_volume(raw, bg.float(), pi.float(), op, cfg)
    yr = pipeline.apodize_ratio(pipeline.preprocess(raw, cfg), bg.float(), pi.float(), cfg)
    s, d = (x.transpose(-1, -2) for x in angio.ratio_ssada(yr, op, acfg, "highest"))
    assert vol.shape == (2, FRAMES // 2, cfg.numdisplaypoints, cfg.height)
    assert vol.is_contiguous() and torch.equal(vol[0], s) and torch.equal(vol[1], d)


def test_a_one_by_one_mesh_equals_no_mesh():
    from fdoct_tpu_torch.parallel import WorldOfOne, make_mesh, shard_frames
    cfg = cfg_of(dtype="float32", matmul_precision="highest")
    raw, bg, pi = volume_inputs(cfg)
    op = angio.SplitSpectrumOperator.create(cfg, angio.AngioConfig(), CPU)
    want = sharded_angio_volume(raw, bg.float(), pi.float(), op, cfg)
    with WorldOfOne("cpu"):
        mesh = make_mesh(1, 1, device_type="cpu")
        got = sharded_angio_volume(shard_frames(raw.numpy(), mesh), bg.float(), pi.float(), op,
                                   cfg, mesh, gather_full=True)
    assert torch.equal(got, want)


def test_a_block_that_splits_a_repeat_group_raises():
    cfg = cfg_of(dtype="float32", matmul_precision="highest")
    raw, bg, pi = volume_inputs(cfg)
    op = angio.SplitSpectrumOperator.create(cfg, angio.AngioConfig(), CPU)
    with pytest.raises(ValueError, match="repeats"):
        sharded_angio_volume(raw[:FRAMES - 1], bg.float(), pi.float(), op, cfg)
    with pytest.raises(ValueError, match="repeats"):
        sharded_angio_volume(raw[:6], bg.float(), pi.float(), op, cfg,
                             acfg=angio.AngioConfig(repeats=4))


# ---------------------------------------------------------------------------
# cscan --angio


@pytest.mark.parametrize("mesh", [[], ["--mesh", "1x1"]], ids=["one-device", "mesh-1x1"])
def test_cscan_angio_writes_what_the_function_returns(tmp_path, capsys, mesh):
    from fdoct_tpu_torch.sources import SyntheticSource
    conf = tmp_path / "small.json"
    conf.write_text(json.dumps(dict(SMALL, dirdescr="angio")))
    assert cli.main(["cscan", "--device", "cpu", "--config", str(conf), "--frames", "6",
                     "--angio", "--format", "npz", "--outdir", str(tmp_path), *mesh]) == 0
    assert "OCT-A (3, 96, 24)" in capsys.readouterr().out
    run = next(p for p in tmp_path.iterdir() if p.is_dir())
    saved = np.load(run / "BscanFFT.npz")

    cfg = cli._load_cfg(cli.build_parser().parse_args(["cscan", "--config", str(conf)]))
    src = SyntheticSource(height=cfg.height, width=cfg.width, lambda0=cfg.lambda0,
                          dlambda=cfg.lambdabw * 2.3548 / 4.0)
    it = cli._frame_iter(src)
    raw = torch.as_tensor(np.stack([next(it) for _ in range(6)]))
    bg, pi = cli._background(src.background(), cfg, CPU)
    acfg = angio.AngioConfig()
    vol = sharded_angio_volume(raw, bg, pi, angio.SplitSpectrumOperator.create(cfg, acfg, CPU),
                               cfg)
    np.testing.assert_array_equal(saved["structure"], vol[0].numpy())
    np.testing.assert_array_equal(saved["decorrelation"], vol[1].numpy())
    views = angio.angio_views(vol[0], vol[1], cfg.compat)
    for key in ("angio_enface", "structure_mip"):
        np.testing.assert_array_equal(read_png(run / f"{key}.png"), views[key].numpy())


def test_cscan_angio_on_a_2x2_mesh_of_four_processes(tmp_path):
    """Four gloo ranks on a 2 × 2 mesh (frames over 'data', each rank two
    whole positions; rows over 'ascan'), every rank but 0 with a source of
    other frames: rank 0 alone reads and writes, and its volumes are the
    single-process command's (float64, relative 1e-9)."""
    sys.path.insert(0, str(ROOT / "tests"))
    from torch_mesh_worker import spawn_cli

    conf = tmp_path / "c.json"
    conf.write_text(json.dumps(dict(SMALL, dtype="float64", dirdescr="angio")))

    def argv(who, *mesh):
        return ["cscan", "--device", "cpu", "--config", str(conf), "--frames", "8", "--angio",
                "--format", "npz", "--outdir", str(tmp_path / who), *mesh]

    reports = spawn_cli(tmp_path, 4, [argv("rank{rank}", "--mesh", "2x2")], 120)
    assert [r[0]["sources"] for r in reports] == [1, 0, 0, 0]
    assert all(r[0]["all_gather"] > 0 for r in reports)
    assert cli.main(argv("single")) == 0
    (got,) = (tmp_path / "rank0").iterdir()
    (want,) = (tmp_path / "single").iterdir()
    assert not (tmp_path / "rank1").exists()
    with np.load(got / "BscanFFT.npz") as g, np.load(want / "BscanFFT.npz") as w:
        for name in ("structure", "decorrelation"):
            np.testing.assert_allclose(g[name], w[name], rtol=0,
                                       atol=1e-9 * np.abs(w[name]).max())


def test_cscan_angio_takes_the_dispersion_sweeps_a2(tmp_path, monkeypatch, capsys):
    from fdoct_tpu_torch import autofocus
    seen = []
    create = angio.SplitSpectrumOperator.create

    def spy(cfg, acfg, device):
        seen.append((cfg.dispersion_a2, cfg.dispersion_a3))
        return create(cfg, acfg, device)
    monkeypatch.setattr(angio.SplitSpectrumOperator, "create", spy)
    monkeypatch.setattr(autofocus, "sweep_volume", lambda *a, **k: (None, 1.5))
    conf = tmp_path / "small.json"
    conf.write_text(json.dumps(dict(SMALL, dispersion_a3=0.5)))
    assert cli.main(["cscan", "--device", "cpu", "--config", str(conf), "--frames", "4",
                     "--angio", "--dispersion-sweep", "--format", "npz",
                     "--outdir", str(tmp_path)]) == 0
    assert "a2 = +1.50" in capsys.readouterr().out and seen == [(1.5, 0.0)]


@pytest.mark.parametrize("argv,message", [
    (["--frames", "5"], "whole number of positions"),
    (["--frames", "6", "--precision", "int8"], "no int8 band tables"),
    (["--frames", "6", "--method", "gather"], "--method fused only"),
])
def test_cscan_angio_refuses_what_it_cannot_do(tmp_path, argv, message):
    conf = tmp_path / "small.json"
    conf.write_text(json.dumps(SMALL))
    with pytest.raises(SystemExit, match=message):
        cli.main(["cscan", "--device", "cpu", "--config", str(conf), "--angio",
                  "--outdir", str(tmp_path), *argv])


# ---------------------------------------------------------------------------
# spans and counters


@pytest.fixture
def spans(monkeypatch):
    fresh = StageTimer()
    monkeypatch.setattr(profiling, "SPANS", fresh)
    return fresh


def test_spans_and_counters_record_only_under_a_profiler(spans):
    cfg = cfg_of(dtype="float32", matmul_precision="highest")
    raw, bg, pi = volume_inputs(cfg)
    op = angio.SplitSpectrumOperator.create(cfg, angio.AngioConfig(), CPU)
    sharded_angio_volume(raw, bg.float(), pi.float(), op, cfg)
    assert spans.snapshot() == {"spans": {}, "counters": {}}
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        sharded_angio_volume(raw, bg.float(), pi.float(), op, cfg)
    snap = spans.snapshot()
    assert {k: v["count"] for k, v in snap["spans"].items()} == {
        "angio.volume": 1, "angio.products": 1, "angio.decorrelation": 1}
    assert snap["spans"]["angio.products"]["parent"] == "angio.volume"
    assert snap["spans"]["angio.decorrelation"]["parent"] == "angio.volume"
    # the product tensors: re and im, F·rows × (1 + 4)·ndisp float32 each;
    # the CPU's route counts no kernel frames
    assert snap["counters"] == {"angio.frames": FRAMES, "angio.kernel_frames": 0,
                                "angio.product_bytes": 2 * FRAMES * cfg.height * 5 * 96 * 4}
    names = {e.name for e in prof.events()}
    assert {"fdoct.angio.volume", "fdoct.angio.products", "fdoct.angio.decorrelation"} <= names


def test_the_readers_read_the_spans(spans):
    from oct_bench.catalog import Catalog
    cat = Catalog(ROOT)
    layer = {"kind": "angio", "trace": {"units": 2, "kernel_us": 4000.0}, "bound_s": 1e-3}
    assert cat.reader("angio.compute_roofline")(layer) == 50.0
    assert cat.reader("angio.product_gb")(layer) is None        # nothing recorded yet
    spans.add("angio.product_bytes", 6_000_000_000)
    with spans.stage("angio.volume"), spans.stage("to_host.wait"):
        pass
    with spans.stage("angio.volume"):
        pass
    assert cat.reader("angio.product_gb")(layer) == 3.0
    assert cat.reader("angio.d2h_wait_ms")(layer) >= 0.0
    assert cat.reader("angio.compute_roofline")(dict(layer, kind="cscan")) is None
    share = cat.reader("angio.kernel_frame_share")
    assert share(layer) is None                                 # no frames recorded yet
    spans.add("angio.frames", 800)
    assert share(layer) is None                                 # a program that counts none
    spans.add("angio.kernel_frames", 0)
    assert share(layer) == 0.0                                  # the kernel never took them
    spans.add("angio.kernel_frames", 400)
    assert share(layer) == 0.5
    assert share(dict(layer, kind="cscan")) is None and share(dict(layer, trace=None)) is None


# --------------------------------------------------------------------------
# the route of the split-spectrum product


class _Stack:
    """What kernel_applies reads of a ratio stack: its device and type."""

    def __init__(self, device: str, dtype: torch.dtype):
        self.device, self.dtype = torch.device(device), dtype


@pytest.mark.parametrize("device,dtype,precision,takes", [
    ("cuda", torch.float32, "highest", True),
    ("cuda", torch.float32, "default", False),
    ("cuda", torch.float32, "bf16", False),
    ("cuda", torch.float64, "highest", False),
    ("cpu", torch.float32, "highest", False),
])
def test_the_kernel_takes_only_highest_float32_on_cuda(device, dtype, precision, takes):
    cfg = cfg_of(dtype="float32")
    op = angio.SplitSpectrumOperator.create(cfg, angio.AngioConfig(), CPU)
    assert op.op_tf32 is not None and op.op_tf32.shape == (2, 2, 5 * 96, cfg.width)
    assert angio.kernel_applies(_Stack(device, dtype), op, precision) is takes
    op64 = angio.SplitSpectrumOperator.create(cfg_of(dtype="float64"), angio.AngioConfig(), CPU)
    assert op64.op_tf32 is None
    assert not angio.kernel_applies(_Stack(device, dtype), op64, precision)


@pytest.mark.parametrize("dtype,precision", [("float32", "highest"), ("float64", "highest"),
                                             ("float32", "default")])
def test_the_cpu_volume_keeps_the_operator_pair(monkeypatch, dtype, precision):
    """On the CPU, in float64 and at 'default' the product runs in
    pipeline._op_matmul_pair, once a volume, and the kernel's launch count
    stays 0."""
    from fdoct_tpu_torch.ops import kernels
    cfg = cfg_of(dtype=dtype, matmul_precision=precision)
    raw, bg, pi = volume_inputs(cfg)
    calls = []
    pair = angio._op_matmul_pair
    monkeypatch.setattr(angio, "_op_matmul_pair", lambda *a: calls.append(a) or pair(*a))
    kernels.reset_launches()
    program(cfg, raw, bg, pi)
    assert len(calls) == 1 and calls[0][2] == precision
    assert kernels.LAUNCHES["split_spectrum_mags"] == 0


def test_the_kernel_route_counts_its_frames_and_writes_only_the_magnitudes(monkeypatch, spans):
    """The kernel's route, taken on the CPU (the wrapper's plain version):
    no operator pair, the counters of the magnitudes, and the volume of the
    pair's route to float32 rounding."""
    cfg = cfg_of(dtype="float32", matmul_precision="highest")
    raw, bg, pi = volume_inputs(cfg)
    want = program(cfg, raw, bg, pi)
    monkeypatch.setattr(angio, "kernel_applies", lambda yr, op, precision: True)
    monkeypatch.setattr(angio, "_op_matmul_pair", None)          # never called on this route
    with profile(activities=[ProfilerActivity.CPU]):
        got = program(cfg, raw, bg, pi)
    snap = spans.snapshot()
    assert {k: v["count"] for k, v in snap["spans"].items()} == {
        "angio.volume": 1, "angio.products": 1, "angio.decorrelation": 1}
    # the magnitudes: F·rows × (1 + 4)·ndisp float32, half the pair's bytes
    assert snap["counters"] == {"angio.frames": FRAMES, "angio.kernel_frames": FRAMES,
                                "angio.product_bytes": FRAMES * cfg.height * 5 * 96 * 4}
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=1e-5, atol=1e-6 * float(w.max()))


@pytest.mark.cuda
def test_cuda_highest_launches_the_kernel_once_a_volume_and_the_cscan_never():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")
    from fdoct_tpu_torch.ops import kernels
    from fdoct_tpu_torch.parallel import sharded_cscan_volume
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    cfg = cfg_of(dtype="float32", matmul_precision="highest")
    raw, bg, pi = volume_inputs(cfg)
    op = angio.SplitSpectrumOperator.create(cfg, angio.AngioConfig(), dev)
    kernels.reset_launches()
    for _ in range(2):
        got = sharded_angio_volume(raw.to(dev), bg.float().to(dev), pi.float().to(dev), op, cfg)
    torch.cuda.synchronize()
    assert {k: v for k, v in kernels.LAUNCHES.items() if v} == {"split_spectrum_mags": 2}
    s_gap, d_gap = gaps((got[0].cpu(), got[1].cpu()), reference(SMALL, raw, bg, pi))
    assert s_gap < F32_STRUCTURE_TOL and d_gap < F32_DECORR_TOL, (s_gap, d_gap)
    # the C-scan volume at 'highest' takes the same kernel against M alone,
    # once a volume (sharded.cscan_kernel_route)
    kernels.reset_launches()
    sharded_cscan_volume(raw.to(dev), bg.float().to(dev), pi.float().to(dev),
                         calibration.Calibration.create(cfg, dev), cfg)
    torch.cuda.synchronize()
    assert {k: v for k, v in kernels.LAUNCHES.items() if v} == {"split_spectrum_mags": 1}
