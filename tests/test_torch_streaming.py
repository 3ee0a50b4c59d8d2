"""The port's streaming ingest (``fdoct_tpu_torch.streaming``) and the
session's ingest seam (``utils.to_device`` on the session's device).

``FrameStreamer`` is held to the JAX class's cases (tests/test_streaming.py:
ordering, drop-oldest under backpressure, rate limiting, timeout → None) and
to the rest of its contract (a producer's exception re-raised, ``None``
frames skipped, a short final batch, ``out`` slots).  ``run_streaming`` on the
CPU is held to the JAX function on the same seeded frames (float32, rtol
1e-5, atol 1e-5·max), and a CPU ``Session`` behind it to a direct
``process_group`` bit for bit.  Cases marked ``cuda`` run the pinned blocks of
the caching host allocator on the card and skip here.
"""

import itertools
import threading
import time

import numpy as np
import pytest
import torch

from fdoct_tpu_torch import pipeline as tp
from fdoct_tpu_torch import utils
from fdoct_tpu_torch.calibration import Calibration
from fdoct_tpu_torch.config import PipelineConfig
from fdoct_tpu_torch.session import Session
from fdoct_tpu_torch.sources.synthetic import SyntheticSource
from fdoct_tpu_torch.streaming import FrameStreamer, run_streaming

H, W = 8, 64
SMALL = dict(width=W, height=H, averages=4, numfftpoints=128, numdisplaypoints=40,
             dtype="float32")


def frame_gen(h=H, w=W):
    i = 0
    while True:
        yield np.full((h, w), i % 251, np.uint8)
        i += 1


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


# ---------------------------------------------------------------------------
# FrameStreamer


def test_lossless_ordering():
    s = FrameStreamer(itertools.islice(frame_gen(), 20), maxsize=8).start()
    b1 = s.get_batch(4)
    b2 = s.get_batch(4)
    s.stop()
    assert b1[0, 0, 0] == 0 and b1[3, 0, 0] == 3
    assert b2[0, 0, 0] == 4
    assert s.stats.dropped == 0


def test_drop_oldest_under_backpressure():
    s = FrameStreamer(itertools.islice(frame_gen(), 50), maxsize=4, drop_oldest=True).start()
    s._thread.join(timeout=10.0)                 # the producer outruns the consumer
    batch = s.get_batch(2)
    s.stop()
    assert batch is not None
    assert s.stats.dropped == 46
    assert [int(f[0, 0]) for f in batch] == [46, 47]     # the newest frames won


def test_rate_limiting():
    s = FrameStreamer(itertools.islice(frame_gen(), 100), maxsize=100, rate_fps=200.0).start()
    time.sleep(0.25)
    s.stop()
    assert 20 <= s.stats.frames_in <= 80         # ~50 at 200 fps


def test_timeout_returns_none():
    s = FrameStreamer(iter([]), maxsize=4).start()
    assert s.get_batch(1, timeout_s=0.05) is None
    s.stop()


def test_producer_exception_is_reraised():
    def dying():
        yield np.zeros((H, W), np.uint8)
        raise TimeoutError("camera watchdog")

    s = FrameStreamer(dying(), maxsize=4).start()
    assert s.get_batch(1).shape == (1, H, W)
    with pytest.raises(TimeoutError, match="watchdog"):
        s.get_batch(4, timeout_s=5.0)
    s.stop()


def test_none_frames_are_skipped_and_the_last_batch_is_short():
    frames = [np.full((H, W), i, np.uint8) for i in range(5)]
    src = [frames[0], None, frames[1], None, None, frames[2], frames[3], frames[4]]
    s = FrameStreamer(iter(src), maxsize=16).start()
    a, b = s.get_batch(3), s.get_batch(3)
    assert s.get_batch(3, timeout_s=0.5) is None           # a clean end
    s.stop()
    assert [int(f[0, 0]) for f in a] == [0, 1, 2]
    assert b.shape == (2, H, W) and [int(f[0, 0]) for f in b] == [3, 4]


def test_get_batch_writes_into_the_given_slot():
    slot = np.zeros((4, H, W), np.uint8)
    seen = []

    def out(first):
        seen.append(first.shape)
        return slot

    s = FrameStreamer(itertools.islice(frame_gen(), 6), maxsize=8).start()
    got = s.get_batch(4, out=out)
    s.stop()
    assert seen == [(H, W)]
    assert np.shares_memory(got, slot) and got.shape == (4, H, W)
    assert [int(f[0, 0]) for f in slot] == [0, 1, 2, 3]


def test_many_streamers_lose_no_frame_under_a_short_switch_interval():
    """More lossless streamers than cores, each drained by its own thread,
    with the interpreter switching threads every 10 us: every consumer gets
    every frame of its source once, in order."""
    import os
    import sys

    n_streams = 2 * (os.cpu_count() or 4)
    got = [None] * n_streams

    def consume(k):
        s = FrameStreamer(itertools.islice(frame_gen(), 300), maxsize=4).start()
        frames = []
        while (b := s.get_batch(7, timeout_s=10.0)) is not None:
            frames += [int(f[0, 0]) for f in b]
        s.stop()
        got[k] = frames

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=consume, args=(k,)) for k in range(n_streams)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60.0)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads)
    assert all(frames == [i % 251 for i in range(300)] for frames in got)


def test_stop_joins_the_producer():
    s = FrameStreamer(frame_gen(), maxsize=2).start()
    time.sleep(0.05)                             # the producer blocks on a full queue
    s.stop()
    assert not s._thread.is_alive()


# ---------------------------------------------------------------------------
# run_streaming on the CPU


def small_case(seed=0, bpp=8):
    cfg = PipelineConfig(**SMALL)
    calib = Calibration.create(cfg, "cpu")
    src = SyntheticSource(height=H, width=W, depths_um=(20.0,), noise=0.02, seed=seed, bpp=bpp)
    bg = np.maximum(src.background(), 1).astype(np.float32)
    return cfg, calib, src, bg


def test_run_streaming_matches_jax():
    """The same seeded frames through the JAX run_streaming with the JAX
    step and through the port's with ``reconstruct(...).sum(0)``."""
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp
    from fdoct_tpu.calibration import Calibration as JaxCalibration
    from fdoct_tpu.config import PipelineConfig as JaxConfig
    from fdoct_tpu.pipeline import reconstruct as jax_reconstruct
    from fdoct_tpu.streaming import run_streaming as jax_run_streaming

    cfg, calib, _, bg = small_case()
    jcfg = JaxConfig(**SMALL)
    jcal = JaxCalibration.create(jcfg, dtype="float32")
    jbg, jpi = jnp.asarray(bg), jnp.zeros((H, W), jnp.float32)
    tbg, tpi = torch.as_tensor(bg), torch.zeros((H, W))
    want, _ = jax_run_streaming(SyntheticSource(height=H, width=W, depths_um=(20.0,),
                                                noise=0.02, seed=5).frames(),
                                lambda f: jax_reconstruct(f, jbg, jpi, jcal, jcfg).sum(0),
                                batch=4, n_batches=5, device=jax.devices("cpu")[0])
    got, stats = run_streaming(SyntheticSource(height=H, width=W, depths_um=(20.0,),
                                               noise=0.02, seed=5).frames(),
                               lambda f: tp.reconstruct(f, tbg, tpi, calib, cfg).sum(0),
                               batch=4, n_batches=5, device="cpu")
    assert len(got) == len(want) == 5 and stats.batches_done == 5 and stats.frames_in >= 20
    for g, w in zip(got, want):
        w = np.asarray(w)
        assert g.shape == w.shape == (H, 40) and g.dtype == torch.float32
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-5, atol=1e-5 * np.abs(w).max())


def streamed_against_direct(bpp):
    """A CPU session fed by run_streaming, one averaging group per batch,
    against a direct process_group on the same frames and captures."""
    cfg, calib, src, bg = small_case(seed=3, bpp=bpp)
    cfg = cfg.replace(donotnormalize=True)
    frames = np.stack(list(itertools.islice(src.frames(), 24)))
    assert frames.dtype == (np.uint8 if bpp <= 8 else np.uint16)
    pi = src.pi_frame()

    def session():
        s = Session(cfg, device="cpu", calib=calib)
        s.data_yb = torch.as_tensor(bg)
        s.data_yp = torch.as_tensor(pi, dtype=torch.float32)
        return s

    streamed, stats = run_streaming(iter(list(frames)), session().process_group,
                                    batch=cfg.averages, n_batches=6, device="cpu",
                                    rate_fps=2000.0)
    direct = session()
    assert stats.dropped == 0 and stats.batches_done == 6
    for g, res in enumerate(streamed):
        (got,) = res
        (want,) = direct.process_group(frames[4 * g:4 * g + 4])
        np.testing.assert_array_equal(got.bscandisp, want.bscandisp)
        assert torch.equal(got.bscan, want.bscan) and torch.equal(got.bscandb, want.bscandb)


def test_session_behind_run_streaming_is_bit_equal():
    streamed_against_direct(bpp=8)


def test_16_bit_session_behind_run_streaming_is_bit_equal():
    """The same with a 12-bit camera's uint16 frames (kernel 1's raw route)."""
    streamed_against_direct(bpp=12)


def test_run_streaming_stops_at_n_batches_and_at_the_end():
    got, stats = run_streaming(frame_gen(), lambda f: int(f[0, 0, 0]), batch=3, n_batches=4,
                               device="cpu")
    assert got == [0, 3, 6, 9] and stats.batches_done == 4
    got, stats = run_streaming(itertools.islice(frame_gen(), 7), lambda f: len(f), batch=3,
                               n_batches=10, device="cpu")
    assert got == [3, 3, 1]                      # the short final batch, then the end
    assert run_streaming(frame_gen(), len, batch=3, n_batches=0, device="cpu")[0] == []


def test_next_copy_is_issued_before_the_step_when_the_batch_is_queued():
    """Two-deep: with the next batch queued, its placement (``put``) comes
    before the step of the current one."""
    log = []

    def put(host):
        if not log:
            time.sleep(0.3)                      # the producer queues every frame
        log.append(f"put {int(host[0, 0, 0])}")
        return torch.as_tensor(host)

    run_streaming(itertools.islice(frame_gen(), 6),
                  lambda f: log.append(f"step {int(f[0, 0, 0])}"),
                  batch=2, n_batches=3, device="cpu", put=put)
    assert log == ["put 0", "put 2", "step 0", "put 4", "step 2", "step 4"]


def test_step_is_not_held_for_a_batch_that_has_not_arrived():
    """A source slower than the step: step N runs before batch N+1 is
    taken, rather than waiting for it."""
    log = []

    def slow():
        for f in itertools.islice(frame_gen(), 3):
            time.sleep(0.1)
            yield f

    run_streaming(slow(), lambda f: log.append(f"step {int(f[0, 0, 0])}"), batch=1,
                  n_batches=3, device="cpu",
                  put=lambda h: log.append(f"put {int(h[0, 0, 0])}") or torch.as_tensor(h))
    assert log == ["put 0", "step 0", "put 1", "step 1", "put 2", "step 2"]


def test_run_streaming_needs_a_device():
    with pytest.raises(TypeError):
        run_streaming(frame_gen(), len, batch=2, n_batches=1)          # no device


def test_producer_exception_surfaces_from_run_streaming():
    def dying():
        yield from itertools.islice(frame_gen(), 2)
        raise OSError("ring closed")

    with pytest.raises(OSError, match="ring closed"):
        run_streaming(dying(), len, batch=2, n_batches=3, device="cpu")


@pytest.mark.parametrize("make", [
    lambda a: a, lambda a: torch.as_tensor(a), lambda a: list(a)], ids=["numpy", "tensor", "list"])
def test_session_ingest_on_the_cpu(make, monkeypatch):
    def never(shape, dtype):
        raise AssertionError("pinned staging is for CUDA devices only")

    monkeypatch.setattr(utils, "_pinned_empty", never)
    cfg, calib, src, bg = small_case(seed=4)
    frames = np.stack(list(itertools.islice(src.frames(), 8)))
    s = Session(cfg, device="cpu", calib=calib)
    dev = utils.to_device(make(frames), s.device)
    assert dev.device.type == "cpu" and torch.equal(dev, torch.as_tensor(frames))


# ---------------------------------------------------------------------------
# on the card


@pytest.mark.cuda
def test_cuda_pinned_block_is_never_refilled_under_a_copy(cuda):
    """Every frame differs; a slow step keeps copies and refills racing.
    Each batch the step sees must be exactly the frames the source gave,
    and the caching host allocator hands dropped blocks out again: fewer
    blocks are made than batches run."""
    rng = np.random.default_rng(0)
    frames = rng.integers(0, 255, (96, 256, 1024), dtype=np.uint8)
    frames[:, 0, :8] = np.arange(96)[:, None]                  # every frame differs
    weight = torch.randn(1024, 1024, device=cuda)

    def step(d):
        assert d.device.type == "cuda"
        x = d.float()
        for _ in range(4):                                     # keep the card busy
            x = torch.tanh(x @ weight) * 255.0
        return d.clone(), x.sum()

    allocs = torch.cuda.host_memory_stats()["num_host_alloc"]
    got, stats = run_streaming(iter(list(frames)), step, batch=4, n_batches=24, device=cuda)
    made = torch.cuda.host_memory_stats()["num_host_alloc"] - allocs
    assert stats.batches_done == 24 and stats.dropped == 0
    for i, (d, _) in enumerate(got):
        np.testing.assert_array_equal(d.cpu().numpy(), frames[4 * i:4 * i + 4])
    assert len(got) > made


@pytest.mark.cuda
@pytest.mark.parametrize("bpp", [8, 12], ids=["u8", "u16"])
def test_cuda_session_ingest_routes_are_bit_equal(cuda, bpp, monkeypatch):
    """process_group on numpy frames (a pinned block of the caching host
    allocator), a pinned host tensor, a pageable host tensor and a CUDA
    tensor gives the same bytes, for 8- and 16-bit frames."""
    blocks = []

    def pinned_empty(shape, dtype, make=utils._pinned_empty):
        blocks.append(shape)
        return make(shape, dtype)

    monkeypatch.setattr(utils, "_pinned_empty", pinned_empty)
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = PipelineConfig(**{**SMALL, "width": 256, "height": 32, "numfftpoints": 512,
                            "numdisplaypoints": 128, "donotnormalize": True})
    src = SyntheticSource(height=32, width=256, noise=0.02, seed=6, bpp=bpp)
    frames = np.stack(list(itertools.islice(src.frames(), 8)))
    routes = {"numpy": frames, "pinned": torch.as_tensor(frames).pin_memory(),
              "pageable": torch.as_tensor(frames), "cuda": torch.as_tensor(frames).to(cuda)}
    out = {}
    for name, batch in routes.items():
        s = Session(cfg, device=cuda)
        s.data_yb = torch.as_tensor(np.maximum(src.background(), 1), dtype=torch.float32,
                                    device=cuda)
        blocks.clear()
        out[name] = [s.process_group(batch), s.process_group(batch)]
        assert (name == "numpy") == bool(blocks)
    for name, runs in out.items():
        for res, want in zip(runs, out["numpy"]):
            for r, w in zip(res, want):
                np.testing.assert_array_equal(r.bscandisp, w.bscandisp)
                assert torch.equal(r.bscan, w.bscan), name


@pytest.mark.cuda
@pytest.mark.parametrize("bpp", [8, 12], ids=["u8", "u16"])
def test_cuda_streamed_session_equals_direct(cuda, bpp):
    """A CUDA session behind run_streaming (one group per batch; pinned
    blocks of the frames' type) gives the same displays as a direct
    process_group on the same frames, 8- and 16-bit."""
    cfg = PipelineConfig(**{**SMALL, "width": 256, "height": 32, "numfftpoints": 512,
                            "numdisplaypoints": 128, "donotnormalize": True})
    src = SyntheticSource(height=32, width=256, noise=0.02, seed=7, bpp=bpp)
    frames = np.stack(list(itertools.islice(src.frames(), 32)))
    calib = Calibration.create(cfg, cuda)
    a, b = Session(cfg, device=cuda, calib=calib), Session(cfg, device=cuda, calib=calib)
    streamed, stats = run_streaming(iter(list(frames)), a.process_group, batch=4,
                                    n_batches=8, device=cuda)
    assert stats.batches_done == 8
    for g, (res,) in enumerate(streamed):
        (want,) = b.process_group(frames[4 * g:4 * g + 4])
        np.testing.assert_array_equal(res.bscandisp, want.bscandisp)


def test_streamer_threads_end():
    before = threading.active_count()
    run_streaming(frame_gen(), len, batch=2, n_batches=3, device="cpu")
    assert threading.active_count() == before


def test_bench_ingest_checks_on_the_cpu(capsys):
    """python -m fdoct_tpu_torch.bench_ingest --device cpu --small: phases
    1-5, every streamed display equal to its direct twin, the camera ring's
    frames (phase 5, through the native ring of native/) equal to the pushed
    ones, no times."""
    import json

    from fdoct_tpu_torch import bench_ingest

    assert bench_ingest.main(["--device", "cpu", "--small"]) == 0
    lines = [json.loads(line) for line in capsys.readouterr().out.splitlines()]
    assert [line["metric"] for line in lines] == [
        "h2d_bandwidth", "ingest_inclusive_ascans_per_sec", "triggered_capture_emulation_fps",
        "flagship_500fps_bandwidth_needed", "ring_to_device_ms_per_frame"]
    for line in lines[1:3]:
        assert line["displays_equal_direct"] and line["dropped"] == 0
        assert line["batches"] == bench_ingest.N_BATCHES and line["seconds"] == "not measured"
    assert lines[3]["value"] == 500 * 32 * 256 / 1e6
    assert lines[4]["frames_equal"] and lines[4]["shape"] == [32, 256]
    assert lines[4]["pinned_slot"] == lines[4]["copying"] == "not measured"


def test_bench_ingest_fails_on_a_wrong_display(monkeypatch):
    """A streamed display that is not its batch's (as a pinned block refilled
    under its copy would give) fails the run."""
    from fdoct_tpu_torch import bench_ingest

    def shuffled(*args, **kwargs):
        results, stats = run_streaming(*args, **kwargs)
        return results[1:] + results[:1], stats

    monkeypatch.setattr(bench_ingest, "run_streaming", shuffled)
    with pytest.raises(RuntimeError, match="differ from direct"):
        bench_ingest.streamed(torch.device("cpu"), bench_ingest.SMALL)
