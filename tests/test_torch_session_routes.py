"""The group routes of the session's dark variant and ``saveframes`` ring:
``pipeline.reconstruct_group(..., dark=...)`` (the dark frame folded into
kernel 1's pi, or subtracted before kernel 2) and
``pipeline.reconstruct_group_frames`` (one launch per frame, summed in frame
order), on the CPU against the JAX chain, and on the card.

Tolerances: float64 'highest' against the JAX chain, rtol = atol/max 1e-9.
Cases marked ``cuda`` (they skip here) hold each route on the card against
the same route on the CPU, which runs the kernels' plain versions: rtol =
atol/max 1e-5 for the bf16 operator (both round the same ratio, only the
order of the f32 sums differs), 1e-4 for the f32 one (3xTF32 against f32),
with one launch per group and one per frame; and a saveinterferograms
session behind ``run_streaming`` with a slowed step, whose ring and saved
raw frames equal the source's exactly.
"""

import dataclasses

import numpy as np
import pytest
import torch

from fdoct_tpu_torch import pipeline as tpl
from fdoct_tpu_torch.calibration import Calibration
from fdoct_tpu_torch.config import PipelineConfig
from fdoct_tpu_torch.ops import kernels
from fdoct_tpu_torch.session import Session
from fdoct_tpu_torch.sinks import RunWriter
from fdoct_tpu_torch.sources.synthetic import SyntheticSource
from fdoct_tpu_torch.utils.imageio import read_png

I8 = dict(width=256, height=32, averages=4, numfftpoints=512, numdisplaypoints=160,
          lambdamin=816e-9, lambdamax=884e-9, dtype="float32", compat=True)
TS = 1_700_000_000.0


def allclose(got, want, rtol):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    np.testing.assert_allclose(got, want, rtol=rtol, atol=rtol * np.abs(want).max())


def route_case(device, normalize: bool):
    src = SyntheticSource(height=32, width=256, noise=0.02, seed=6)
    it = src.frames()
    frames = torch.as_tensor(np.stack([next(it) for _ in range(4)])).to(device)
    cfg = PipelineConfig(**{**I8, "averages": 4, "donotnormalize": not normalize})
    calib = Calibration.create(cfg, device)
    rng = np.random.default_rng(1)
    mk = lambda a: torch.as_tensor(a, dtype=torch.float32).to(device)   # noqa: E731
    return (frames, mk(np.maximum(src.background(), 1)), mk(rng.uniform(0, 8, (32, 256))),
            calib, cfg, mk(rng.uniform(0, 4, (32, 256))))


@pytest.mark.parametrize("normalize", [False, True], ids=["raw_kernel", "ratio_kernel"])
def test_dark_routes_match_the_jax_chain(normalize):
    """reconstruct_group(dark=...) against the JAX chain: preprocess − yd,
    apodize_ratio, |· @ M| summed (session.py:595, 1143-1145)."""
    jnp = pytest.importorskip("jax.numpy")
    from fdoct_tpu.calibration import Calibration as JaxCalibration
    from fdoct_tpu.config import PipelineConfig as JaxConfig
    from fdoct_tpu.pipeline import apodize_ratio, ascan_mags, preprocess

    raw, bg, pi, calib, cfg, dark = route_case("cpu", normalize)
    jcfg = JaxConfig(**{**dataclasses.asdict(cfg), "dtype": "float64",
                        "matmul_precision": "highest"})
    tcfg = cfg.replace(dtype="float64", matmul_precision="highest")
    tcal = Calibration.create(tcfg, "cpu")
    jcal = JaxCalibration.create(jcfg)
    yr = apodize_ratio(preprocess(jnp.asarray(raw.numpy()), jcfg) - jnp.asarray(dark.double()),
                       jnp.asarray(bg.double()), jnp.asarray(pi.double()), jcfg)
    want = np.asarray(ascan_mags(yr, jcal, "fused", "highest").sum(0))
    got = tpl.reconstruct_group(raw, bg.double(), pi.double(), tcal, tcfg, dark=dark.double())
    allclose(got.numpy(), want, 1e-9)
    total, mags = tpl.reconstruct_group_frames(raw, bg.double(), pi.double(), tcal, tcfg,
                                               dark=dark.double())
    assert len(mags) == 4
    allclose(total.numpy(), want, 1e-9)


def test_dark_raw_route_folds_the_dark_frame_into_pi(monkeypatch):
    """On the raw kernel's route the dark frame rides in π: one launch with
    pi = yp + yd, no preprocess."""
    raw, bg, pi, calib, cfg, dark = route_case("cpu", normalize=False)
    seen = []
    orig = tpl.fused_recon_raw_accumulate
    monkeypatch.setattr(tpl, "fused_recon_raw_accumulate",
                        lambda r, p, *a: seen.append(p) or orig(r, p, *a))
    monkeypatch.setattr(tpl, "preprocess", lambda *a, **k: pytest.fail("preprocessed"))
    tpl.reconstruct_group(raw, bg, pi, calib, cfg, dark=dark)
    assert len(seen) == 1 and torch.equal(seen[0], pi + dark)


def test_dark_session_folds_pi_once_per_capture(monkeypatch):
    """The dark session forms yp + yd once per capture: every group of one
    calibration hands the raw kernel the same π tensor, and a capture that
    rebinds ``data_yd`` forms a new one."""
    raw, bg, pi, calib, cfg, dark = route_case("cpu", normalize=False)
    seen = []
    orig = tpl.fused_recon_raw_accumulate
    monkeypatch.setattr(tpl, "fused_recon_raw_accumulate",
                        lambda r, p, *a: seen.append(p) or orig(r, p, *a))
    s = Session(cfg, "cpu", variant="dark", calib=calib)
    s.data_yb, s.data_yp, s.data_yd = bg, pi, dark
    s.process_group(raw)
    s.process_group(raw)
    for f in raw:
        s.process(f)
    assert len(seen) == 6 and all(p is seen[0] for p in seen)
    assert torch.equal(seen[0], pi + dark)
    s.data_yd = dark * 2                                  # as an 'o' capture rebinds it
    s.process_group(raw)
    assert seen[-1] is not seen[0] and torch.equal(seen[-1], pi + dark * 2)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("normalize", [False, True], ids=["raw_kernel", "ratio_kernel"])
@pytest.mark.parametrize("precision", ["default", "highest"])
def test_cuda_dark_and_per_frame_routes_match_their_plain_versions(cuda, normalize, precision):
    """The dark fold route and the per-frame (saveframes) route on the card
    against the same routes on the CPU, which run the kernels' plain
    versions: one launch per group, one per frame."""
    raw, bg, pi, calib, cfg, dark = route_case(cuda, normalize)
    cfg = cfg.replace(matmul_precision=precision)
    host = [t.cpu() for t in (raw, bg, pi)]
    ccal = Calibration.create(cfg, "cpu")
    bf16 = tpl.use_bf16(precision, torch.float32, cuda)
    pcfg = cfg.replace(matmul_precision="bf16" if bf16 else "highest")
    kernels.reset_launches()
    got = tpl.reconstruct_group(raw, bg, pi, calib, cfg, dark=dark)
    total, mags = tpl.reconstruct_group_frames(raw, bg, pi, calib, cfg, dark=dark)
    torch.cuda.synchronize()
    name = "fused_recon_accumulate" if normalize else "fused_recon_raw_accumulate"
    assert {k: v for k, v in kernels.LAUNCHES.items() if v} == {name: 5}
    want = tpl.reconstruct_group(*host, ccal, pcfg, dark=dark.cpu())
    want_total, want_mags = tpl.reconstruct_group_frames(*host, ccal, pcfg, dark=dark.cpu())
    tol = 1e-5 if bf16 else 1e-4
    for g, w in [(got, want), (total, want_total)] + list(zip(mags, want_mags)):
        np.testing.assert_allclose(g.cpu().numpy(), w.numpy(), rtol=tol,
                                   atol=tol * float(w.abs().max()))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [np.uint8, np.uint16], ids=["u8", "u16"])
def test_cuda_streamed_saveinterferograms_ring_holds_the_source_frames(cuda, tmp_path, dtype):
    """A saveinterferograms session behind run_streaming, its step slowed so
    that pinned slots are refilled while copies are in flight: after each
    group the inactive ring holds exactly that group's source frames, and an
    's' save writes them; 8-bit frames and 12-bit counts in uint16."""
    from fdoct_tpu_torch.streaming import run_streaming

    cfg = PipelineConfig(**{**I8, "donotnormalize": True, "saveinterferograms": True})
    rng = np.random.default_rng(0)
    frames = rng.integers(0, 255 if dtype == np.uint8 else 4095, (48, 32, 256)).astype(dtype)
    frames[:, 0, :8] = np.arange(48)[:, None]                     # every frame differs
    sink = RunWriter(tmp_path, "stream", timestamp=TS)
    s = Session(cfg, device=cuda, sink=sink)
    weight = torch.randn(1024, 1024, device=cuda)
    held = []

    def step(batch):
        x = batch.float().reshape(-1, 1024)
        for _ in range(4):                                         # keep the card busy
            x = torch.tanh(x @ weight)
        out = s.process_group(batch)
        held.append([r.cpu().numpy() for r in s._rings[1 if s.zeroisactive else 0]["raw"]])
        return out, x.sum()

    got, stats = run_streaming(iter(list(frames[:40])), step, batch=4, n_batches=10,
                               device=cuda)
    assert stats.batches_done == 10 and stats.dropped == 0
    for g, ring in enumerate(held):
        np.testing.assert_array_equal(np.stack(ring), frames[4 * g:4 * g + 4])
    s.key("s")
    for f in frames[40:44]:
        s.process(f)
    for ii in range(4):
        np.testing.assert_array_equal(read_png(sink.dir / f"rawframe001-{ii:03d}.png"),
                                      frames[36 + ii])
