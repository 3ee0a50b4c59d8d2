"""Command-line interface of the PyTorch/CUDA port.

The port of ``fdoct_tpu/cli.py``: one executable, ``fdoct-torch`` or
``python -m fdoct_tpu_torch``, with the same subcommands, arguments and
outputs, on the port's session, sources and sinks:

- ``sim``      — hardware-free replay (BscanFFTsim role): reconstruct saved
  interferogram PNGs, write B-scans + data dumps.
- ``live``     — streaming session on a source (synthetic generator or the
  camera ring) with the keystroke state machine; keys via stdin.
- ``capture``  — triggered/free-running batch capture writing
  ``Trig%03d-%03d.png`` sets (BscanFFTspinj/spinjnt role).
- ``offline``  — the offline reconstruction tool the reference spawns by
  fork/execv with argv {dirname, manualaverages}
  (BscanFFTspinj.cpp:2389-2412); same protocol honoured.
- ``viewport`` — frame saver (ViewportSaver role).
- ``fps``      — source frame-rate measurement.
- ``xml2m|xml2mm|xml2ms`` — FileStorage-XML → MATLAB converters.
- ``cscan``    — volumetric C-scan with an optional dispersion sweep.
- ``sweep``    — dispersion autofocus sweep.
- ``selftest`` — deployment self-check.
- ``bench``    — the throughput benchmark: A-scans/s of the per-group
  pipeline at the flagship shape, measured on the card
  (:mod:`fdoct_tpu_torch.bench`), one JSON line on stdout.
- ``configedit`` — view/edit ini fields by name.

Every command that computes runs on ``--device`` (default ``cuda``); where
PyTorch sees no card, that is an error, never a silent move to the CPU.
``live --viewer DIR`` renders the display windows into PNGs,
``--viewer-mode http`` serves them with keys, ROI drags and config edits
(:mod:`fdoct_tpu_torch.viewer_server`), ``--viewer-mode mpl`` shows them
with matplotlib.  ``live --mesh DxA`` and ``cscan --mesh DxA`` run on a
('data', 'ascan') device mesh, one process per device: ``torchrun
--nproc-per-node N python -m fdoct_tpu_torch live --mesh DxA ...`` (D·A = N;
rank 0 alone reads the source and broadcasts each batch, writes the outputs
and prints the summary; a triggered camera is refused there); ``--mesh 1x1``
needs no launcher.  ``cscan`` without ``--mesh`` under torchrun takes a mesh
over the world, as the JAX CLI does.

Deliberate deviation: a triggered source that stays idle past
``--idle-timeout`` raises :class:`SourceTimeoutError`, which names the
source and the timeout, and ``main`` turns it into exit status 1 with the
message on stderr, where the JAX CLI raises a bare ``TimeoutError``.
"""

from __future__ import annotations

import argparse
import os
import sys
import time
from pathlib import Path

import numpy as np
import torch

from fdoct_tpu_torch.utils import checkpoint, to_host

#: default cap on continuous triggered-idle yields (single source of truth
#: for the argparse default, _idle_timeout fallback and _frame_iter)
IDLE_TIMEOUT_DEFAULT_S = 60.0


class SourceTimeoutError(TimeoutError):
    """A triggered source yielded no frame for the idle timeout."""

    def __init__(self, source, timeout_s: float):
        ring = getattr(source, "ring_path", None)
        name = type(source).__name__ + (f" ({ring})" if ring else "")
        super().__init__(
            f"{name} produced no frame for {timeout_s:g} s (--idle-timeout): this "
            f"command fires no trigger pulses; fire them (fdoct-torch capture, or the t/k/| "
            f"keys in fdoct-torch live), run the daemon free-running, or pass --idle-timeout 0 "
            f"to wait for operator-paced pulses")


def _load_cfg(args):
    from fdoct_tpu_torch.config import PipelineConfig, read_ini

    if args.config and args.config.endswith(".ini"):
        cfg = read_ini(args.config, getattr(args, "variant", "base"))
    elif args.config:
        cfg = PipelineConfig.from_json(Path(args.config).read_text())
    else:
        cfg = PipelineConfig()
    # --precision overrides the config's matmul_precision (the reference
    # ini schemas are positional and cannot carry the field)
    if getattr(args, "precision", ""):
        cfg = cfg.replace(matmul_precision=args.precision)
        cfg.validate()
    return cfg


def _device(name: str) -> torch.device:
    """``--device``: a CUDA device needs a card PyTorch sees; TF32 is turned
    off there, so that 'highest' multiplies in float32."""
    dev = torch.device(name)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise SystemExit(f"--device {name}: torch.cuda.is_available() is false; "
                             "fdoct-torch runs on the card unless --device cpu asks for the CPU")
        torch.backends.cuda.matmul.allow_tf32 = False
        if "LOCAL_RANK" in os.environ:
            # one process per card under torchrun: "cuda" is this rank's card
            torch.cuda.set_device(int(os.environ["LOCAL_RANK"]))
    return dev


def _idle_timeout(args) -> float:
    """--idle-timeout resolution: <= 0 disables the cap (legitimate
    slow-trigger workflows where pulses arrive minutes apart)."""
    t = float(getattr(args, "idle_timeout", IDLE_TIMEOUT_DEFAULT_S))
    return float("inf") if t <= 0 else t


def _frame_iter(src, idle_timeout_s: float = IDLE_TIMEOUT_DEFAULT_S):
    """Blocking frame iterator for sequential/batch consumers.

    A triggered CameraSource yields ``None`` between pulses so the live
    loop can keep servicing the keys that fire them (camera.py frames());
    every other consumer (capture/viewport/fps/cscan/sweep/sim) just wants
    the next real frame, so the idle yields are skipped here.  The skip is
    capped: ``idle_timeout_s`` of continuous idle yields raises
    :class:`SourceTimeoutError` (a consumer that never fires pulses would
    otherwise block forever)."""

    def gen():
        idle_since = None
        for f in src.frames():
            if f is None:
                now = time.monotonic()
                if idle_since is None:
                    idle_since = now
                elif now - idle_since > idle_timeout_s:
                    raise SourceTimeoutError(src, idle_timeout_s)
                continue
            idle_since = None
            yield f
    return gen()


def _parse_mesh(spec: str, device: torch.device, args):
    """'DxA' → a ('data', 'ascan') mesh on ``device``'s type, with a clean
    CLI error on malformed values (``live --mesh`` / ``cscan --mesh``).  The
    world is torchrun's (:func:`~fdoct_tpu_torch.parallel.initialize_multihost`),
    one already initialized in this process, or a world of one this command
    opens and closes."""
    import torch.distributed as dist

    from fdoct_tpu_torch.parallel import WorldOfOne, initialize_multihost, make_mesh
    from fdoct_tpu_torch.parallel.distributed import backend_for

    d, _, a = spec.lower().partition("x")
    try:
        n_data, n_ascan = int(d), (int(a) if a else 1)
        if n_data < 1 or n_ascan < 1:
            raise ValueError("axes must be >= 1")
    except ValueError as e:
        raise SystemExit(f"invalid --mesh {spec!r} (expected DxA, e.g. 4x2): {e}")
    if not dist.is_initialized() and not initialize_multihost(backend=backend_for(device.type)):
        args.open_sources.append(WorldOfOne(device.type))
    # a well-formed spec that does not fit the world is a capacity problem,
    # not a syntax one — report it without the misleading DxA prefix
    try:
        return make_mesh(n_data, n_ascan, device_type=device.type)
    except ValueError as e:
        raise SystemExit(f"--mesh {spec}: {e}")


def _from_lead(items: list) -> list:
    """Rank 0's ``items`` on every rank of a multi-process world (one
    broadcast); a single process's as they are."""
    import torch.distributed as dist

    if not dist.is_initialized() or dist.get_world_size() == 1:
        return items
    box = [items]
    dist.broadcast_object_list(box, src=0)
    return box[0]


def _is_lead() -> bool:
    """Rank 0 of a multi-process world, or a single process: the one that
    reads the source, writes the outputs and prints the summary."""
    import torch.distributed as dist

    return not dist.is_initialized() or dist.get_rank() == 0


def _world_size() -> int:
    import torch.distributed as dist

    return dist.get_world_size() if dist.is_initialized() else 1


def _array_from_lead(arr: np.ndarray | None, device: torch.device):
    """Rank 0's host array (None at the end of a stream) on every rank of a
    multi-process world.  Rank 0 alone reads the source: a camera has one
    reader, and every rank's block of a batch must come from the same
    frames.  One broadcast of the shape and dtype, one of the bytes on
    ``device`` (the card on nccl, the CPU on gloo).  Rank 0 gets ``arr``
    back, the other ranks a tensor on ``device``."""
    import torch.distributed as dist

    head = None if arr is None else (tuple(arr.shape), str(arr.dtype))
    head = _from_lead([head])[0]
    if head is None:
        return None
    shape, dtype = head
    if _is_lead():
        buf = torch.from_numpy(np.ascontiguousarray(arr).reshape(-1).view(np.uint8)).to(device)
    else:
        buf = torch.empty(int(np.prod(shape)) * np.dtype(dtype).itemsize, dtype=torch.uint8,
                          device=device)
    dist.broadcast(buf, src=0)
    return arr if _is_lead() else buf.view(getattr(torch, dtype)).reshape(shape)


def _default_mesh(device: torch.device):
    """The mesh without ``--mesh``, as the JAX CLI's C-scan takes it: over
    every rank of the world (torchrun's, or one already initialized), two of
    them on 'ascan' when their count is even; None for a single process."""
    import torch.distributed as dist

    from fdoct_tpu_torch.parallel import initialize_multihost, make_mesh
    from fdoct_tpu_torch.parallel.distributed import backend_for

    if not dist.is_initialized() and not initialize_multihost(backend=backend_for(device.type)):
        return None
    n = dist.get_world_size()
    n_ascan = 2 if n % 2 == 0 else 1
    return make_mesh(n // n_ascan, n_ascan, device_type=device.type)


def _make_source(args, cfg):
    from fdoct_tpu_torch.sources import ReplaySource, SyntheticSource

    if getattr(args, "camera", None):
        # live hardware path: frames come from the native shared-memory ring
        # (the GetQHYCCDLiveFrame seat, BscanFFT.cpp:948); the daemon owns
        # the device, this process owns the GPU
        from fdoct_tpu_torch.sources.camera import CameraSource
        spec = getattr(args, "camera_daemon", "synthetic")
        daemon_exe = "capture_daemon"
        if spec == "none":
            daemon_args = None
        elif spec == "synthetic":
            daemon_args = ["--synthetic"]
        elif spec.startswith("pgm:"):
            daemon_args = ["--pgm", spec[4:]]
        elif spec.startswith("v4l2:"):
            daemon_args = ["--v4l2", spec[5:]]
        elif spec == "qhy":
            daemon_args, daemon_exe = ["--qhy"], "capture_daemon_qhy"
        elif spec == "spinnaker":
            daemon_args, daemon_exe = ["--spinnaker"], "capture_daemon_spin"
        else:
            raise SystemExit(f"unknown --camera-daemon {spec!r}")
        trig = getattr(args, "trigger", "none")
        if daemon_args is not None:
            # acquisition geometry from the ini reaches the SDK init chain
            # (QHY SetQHYCCDResolution + CONTROL_USBTRAFFIC/SPEED,
            # BscanFFT.cpp:808-871; Spinnaker OffsetX/Y, Width/Height,
            # PixelFormat, AcquisitionFrameRate, BscanFFTspin.cpp:824-1015)
            daemon_args = daemon_args + [
                "--offsetx", str(cfg.offsetx), "--offsety", str(cfg.offsety),
                "--cambinx", str(cfg.cambinx), "--cambiny", str(cfg.cambiny),
                "--camspeed", str(cfg.camspeed),
                "--usbtraffic", str(cfg.usbtraffic),
                "--exposure", str(cfg.exposure_us), "--gain", str(cfg.gain)]
            if trig in ("sw", "hw"):
                daemon_args += ["--trigger", trig]
        src = CameraSource(args.camera, daemon_args=daemon_args,
                           width=cfg.width, height=cfg.height,
                           bpp=16 if cfg.bpp > 8 else 8,
                           fps=getattr(args, "camera_fps", 100.0),
                           daemon_exe=daemon_exe,
                           # triggered capture must collect EVERY pulse's
                           # frame (in-order reads); live view wants the
                           # newest (frame-skip); triggered also relaxes the
                           # starvation watchdog (CameraSource.frames)
                           sequential=trig in ("sw", "hw"),
                           triggered=trig in ("sw", "hw"),
                           initial_ctrl={"exposure": cfg.exposure_us, "gain": cfg.gain})
        args.open_sources.append(src)
        return src
    if getattr(args, "image", None):
        base = Path(args.image).parent
        return ReplaySource(
            args.image,
            background_image=(args.background or
                              (base / "backg.png" if (base / "backg.png").exists() else None)),
            pi_image=(args.pi or
                      (base / "piimgi.png" if (base / "piimgi.png").exists() else None)),
        )
    # the wang λ grid spans λ0 ± 2σ_λ with σ_λ = FWHM/2.3548, so the
    # configured [λmin, λmax] range implies FWHM = range·2.3548/4
    return SyntheticSource(height=cfg.height, width=cfg.width, lambda0=cfg.lambda0,
                           dlambda=cfg.lambdabw * 2.3548 / 4.0)


def _autosize(cfg, src):
    """Adapt the config to the source's actual frame size (the webcam
    variant auto-detects w/h from the first frame,
    BscanFFTwebcam.cpp:524-546)."""
    first = next(_frame_iter(src))
    h, w = first.shape[:2]
    if (cfg.height, cfg.width) == (h, w):
        return cfg
    cfg = cfg.replace(width=w, height=h)
    bx = max(cfg.binvalue, cfg.binvaluex, 1)
    by = max(cfg.binvalue, cfg.binvaluey, 1)
    if w % bx or h % by:
        cfg = cfg.replace(binvalue=1, binvaluex=1, binvaluey=1)
    return cfg


def _background(raw: np.ndarray, cfg, dev: torch.device) -> tuple[torch.Tensor, torch.Tensor]:
    """(S(k) floored at 1, zero π) on ``dev`` from a source's background
    frame ``raw``, the cscan/sweep calibration frames."""
    from fdoct_tpu_torch.pipeline import preprocess

    bg = torch.clamp_min(preprocess(torch.as_tensor(raw).to(dev), cfg), 1.0)
    return bg, torch.zeros_like(bg)


def cmd_sim(args) -> int:
    """Replay reconstruction (BscanFFTsim.cpp role)."""
    from fdoct_tpu_torch.plugins import JMaskPlugin
    from fdoct_tpu_torch.session import Session
    from fdoct_tpu_torch.sinks import RunWriter

    cfg = _load_cfg(args).replace(donotnormalize=False)  # sim normalizes input
    if getattr(args, "strict_sim", False):
        cfg = cfg.replace(simcopyto=True)
    src = _make_source(args, cfg)
    if getattr(args, "image", None):
        cfg = _autosize(cfg, src)
    sink = RunWriter(args.outdir, cfg.dirdescr, fmt=args.format)
    s = Session(cfg, device=args.device, variant="sim", sink=sink, source=src,
                method=args.method)
    s.plugins.append(JMaskPlugin())      # the sim J-threshold mask path
    s.key("b")
    s.key("p")
    it = _frame_iter(src, _idle_timeout(args))

    if args.debug_dump:
        # first-iteration intermediate dump for the Octave cross-check flow
        # (BscanFFTsim.cpp:901-909 saves data_ylin + nearestkindex) — reuse
        # ``it``: a second iterator would consume (and lose) a real frame
        import itertools

        from fdoct_tpu_torch.pipeline import apodize_ratio, linearize, preprocess
        first = next(it)
        it = itertools.chain([first], it)      # put it back for the main loop
        y = preprocess(torch.as_tensor(first).to(args.device), cfg)
        bgp = preprocess(torch.as_tensor(src.background()).to(args.device), cfg)
        pip = preprocess(torch.as_tensor(src.pi_frame()).to(args.device), cfg)
        yr = apodize_ratio(y, bgp.to(y.dtype), pip.to(y.dtype), cfg)
        sink.save_data("debugzpaddedlin", to_host(linearize(yr, s.calib)))
        sink.save_data("nearestkindex",
                       to_host(s.calib.nearest_idx.to(torch.int32))[None, :])

    shown = 0
    for _ in range(args.frames):
        s.key("s")
        r = None
        while r is None:
            r = s.process(next(it))
        shown += 1
    s.close()
    print(f"wrote {shown} B-scans to {sink.dir}")
    return 0


def cmd_live(args) -> int:
    """Streaming session with stdin keys (BscanFFT role, display-free)."""
    import select
    import signal

    from fdoct_tpu_torch.parallel import mesh_device
    from fdoct_tpu_torch.session import Session
    from fdoct_tpu_torch.sinks import RunWriter

    if (getattr(args, "checkpoint_every", 0) or 0) > 0 and not getattr(args, "checkpoint", None):
        # a user relying on periodic crash-safety must not silently get
        # no checkpoints: the period needs a path to write to
        raise SystemExit("--checkpoint-every N requires --checkpoint PATH")
    cfg = _load_cfg(args)
    mesh = None
    if getattr(args, "mesh", ""):
        # the live data path on the device mesh: Session.process_group runs
        # the sharded session steps, each rank copying its block of a batch
        mesh = _parse_mesh(args.mesh, args.device, args)
    lead, shared = _is_lead(), _world_size() > 1
    triggered = getattr(args, "camera", None) and getattr(args, "trigger", "none") in ("sw", "hw")
    if shared and triggered:
        raise SystemExit("live: a triggered camera keeps the per-frame loop, which runs in one "
                         "process; run it without a multi-process --mesh")
    # on a world of several ranks rank 0 alone reads the source and sends
    # each batch to the others (_array_from_lead)
    src = _make_source(args, cfg) if lead else None
    if getattr(args, "image", None) and src is not None:
        cfg = _autosize(cfg, src)
    cfg = _from_lead([cfg])[0]
    if lead and mesh is not None:
        print(f"live session on mesh {dict(zip(mesh.mesh_dim_names, mesh.shape))}",
              file=sys.stderr)
    sink = RunWriter(args.outdir, cfg.dirdescr, fmt=args.format) if lead else None
    # ini-schema names map onto session behavior variants
    session_variant = {"base": "base", "webcam": "base", "dark": "dark",
                       "peak": "peak", "spinj": "spinj", "spinjnt": "spinj",
                       "viewport": "base", "viewportc": "base"}.get(args.variant, "base")
    # live camera control loop: exposure/gain keys flow Session → this
    # callback → ring control block → daemon → device (the reference's
    # SetQHYCCDParam key seam, BscanFFT.cpp:1600-1624); the initial values
    # are seeded once, by CameraSource(initial_ctrl=) in _make_source
    camera_cb = getattr(src, "set_param", None)
    if getattr(args, "resume", None):
        # resume: stored config wins; calibration tensors + knobs restored
        s = checkpoint.load_session(args.resume, variant=session_variant, sink=sink,
                                    source=src, method=args.method, camera=camera_cb,
                                    device=args.device, mesh=mesh)
        if camera_cb is not None:
            # restored knobs win over the config defaults
            camera_cb("exposure", s.exposure_us)
            camera_cb("gain", s.gain)
        if lead:
            print(f"resumed session from {args.resume}", file=sys.stderr)
    else:
        s = Session(cfg, device=args.device, variant=session_variant, sink=sink, source=src,
                    method=args.method, camera=camera_cb, mesh=mesh)
    viewer = None
    if lead and (args.viewer or args.viewer_mode == "http"):
        from fdoct_tpu_torch.viewer import Viewer
        viewer = Viewer(mode=args.viewer_mode, outdir=args.viewer or "viewer",
                        port=args.viewer_port)
        if viewer.server is not None:
            print(f"live viewer at {viewer.server.url}", file=sys.stderr)
        # dashboard config panel (editiniadv analog): GET serves current
        # knobs, POSTed edits drain into Session.apply_config below
        viewer.set_config_provider(s.config_snapshot)

    batch = max(getattr(args, "batch", 1), 1)
    if getattr(src, "triggered", False):
        # a triggered camera cannot ride the batched streamer: it services
        # keys only between batches, so the 't' pulse that produces the
        # first frame could never be fired
        if batch > 1 or mesh is not None:
            print("live: triggered camera keeps the per-frame loop (keys fire the "
                  "pulses); --batch/--mesh apply to free-running sources only",
                  file=sys.stderr)
        batch = 1
    elif mesh is not None and batch == 1:
        # the mesh rides the batched path (process_group); one averaging
        # group per sharded step by default
        batch = max(cfg.averages, 1)
    streamer = None
    batched = batch > 1 or shared
    if batched and lead:
        # batched fast path: overlapped producer thread + one group launch
        # per averaging group (Session.process_group)
        from fdoct_tpu_torch.streaming import FrameStreamer
        streamer = FrameStreamer(src.frames(), maxsize=4 * batch).start()
    elif not batched:
        # NOT _frame_iter: the live loop must see the None idle yields so
        # the keys that fire the next trigger pulses keep being serviced
        it = iter(src.frames())

    n = 0
    tracer = None
    if getattr(args, "trace", ""):
        from fdoct_tpu_torch.utils.profiling import device_trace
        tracer = device_trace(args.trace)
        tracer.__enter__()
        print(f"profiler trace → {args.trace}", file=sys.stderr)

    # graceful shutdown: SIGTERM/SIGINT request a clean loop exit (like the
    # 'x' key) so the exit-time checkpoint/footer/close still run.  The
    # handler only stores flags (a print could re-enter stderr's lock); the
    # loop reports the signal.  A SECOND signal restores the default
    # handlers, so a stuck session stays interruptible.
    sig_seen: list[int] = []
    old_handlers = {}

    def _graceful(signum, frame):
        if sig_seen:
            for sg, h in old_handlers.items():
                signal.signal(sg, h)
            raise KeyboardInterrupt
        sig_seen.append(signum)
        s.done = True

    for sig in (signal.SIGTERM, signal.SIGINT):
        try:
            old_handlers[sig] = signal.signal(sig, _graceful)
        except ValueError:        # not the main thread (in-process tests)
            pass

    ckpt_every = max(getattr(args, "checkpoint_every", 0) or 0, 0)
    groups_done = 0

    def _atomic_checkpoint() -> Path:
        """Atomic write-aside + rename onto the checkpoint path (a signal
        or crash mid-save must never truncate the last good checkpoint)."""
        saved = checkpoint.save_session(s, Path(str(args.checkpoint) + ".tmp.npz"))
        dest = checkpoint.npz_path(args.checkpoint)
        Path(saved).replace(dest)
        return dest

    def _maybe_checkpoint(completed: int) -> None:
        """Periodic crash-safety checkpoint every N completed groups."""
        nonlocal groups_done
        groups_done += completed
        if not lead or not args.checkpoint or not ckpt_every or groups_done < ckpt_every:
            return
        groups_done %= ckpt_every
        dest = _atomic_checkpoint()
        if args.verbose:
            print(f"periodic checkpoint → {dest}", file=sys.stderr)

    try:
        while True:
            # rank 0 decides whether to go on (a signal may reach one rank
            # first), and its keys, ROI drags and config edits reach every
            # rank in the same order, so the ranks' sessions stay in step
            go = not s.done and (args.frames == 0 or n < args.frames)
            inputs = []
            if go and lead and sys.stdin in select.select([sys.stdin], [], [], 0)[0]:
                inputs += [("key", ch) for ch in sys.stdin.readline().rstrip("\n")]
            if go and viewer is not None:
                inputs += [("key", ch) for ch in viewer.pop_keys()]
                inputs += [("roi", roi) for roi in viewer.pop_rois()]
                inputs += [("config", upd) for upd in viewer.pop_config()]
            go, inputs = _from_lead([go, inputs])
            if not go:
                break
            for kind, value in inputs:
                if kind == "key":
                    s.key(value)
                elif kind == "roi":
                    s.set_roi(value["x"], value["y"], value["w"], value["h"])
                else:
                    for msg in s.apply_config(value):
                        print(f"config: {msg}", file=sys.stderr)
            if batched:
                want = batch if args.frames == 0 else min(batch, args.frames - n)
                # raises if the source died
                raws = streamer.get_batch(want) if streamer is not None else None
                if shared:
                    raws = _array_from_lead(raws, args.device if mesh is None
                                            else mesh_device(mesh))
                if raws is None:
                    break
                rs = s.process_group(raws)
                n += len(raws)
                _maybe_checkpoint(len(rs))
                raw, r = raws[-1], (rs[-1] if rs else None)
            else:
                raw = next(it)
                if raw is None:
                    # triggered source idling between pulses: loop back so
                    # the keys that fire the next pulses keep being read
                    continue
                r = s.process(raw)
                n += 1
                _maybe_checkpoint(1 if r is not None else 0)
            if viewer is not None:
                viewer.show_session_frame(s, raw, r)
            if r is not None and args.verbose:
                print(f"bscan group done (n={n}), peak {float(r.bscandb.max()):.1f} dB",
                      file=sys.stderr)
    finally:
        if sig_seen:
            print(f"signal {sig_seen[0]}: finishing up (checkpoint + close)", file=sys.stderr)
        if tracer is not None:
            tracer.__exit__(None, None, None)
        # join the producer before main() closes the source: a live
        # producer polling a just-unmapped ring would crash the process
        if streamer is not None:
            streamer.stop()
        if viewer is not None:
            viewer.close()
        # the exit-time checkpoint runs BEFORE the handlers are restored,
        # through the same atomic write-aside as the periodic path, and on
        # an exception exit too; a save failure must not mask that error
        if lead and getattr(args, "checkpoint", None):
            try:
                dest = _atomic_checkpoint()
                print(f"session checkpoint saved to {dest}", file=sys.stderr)
            except Exception as e:
                print(f"checkpoint save failed: {type(e).__name__}: {e}", file=sys.stderr)
        for sig, handler in old_handlers.items():
            signal.signal(sig, handler)
    s.close()
    if lead:
        print(f"processed {n} frames; outputs in {sink.dir}")
    return 0


def cmd_capture(args) -> int:
    """Batch capture to Trig/KTrig PNG sets (BscanFFTspinj 't'/'k'/'|' roles:
    AcquireImages/AcquireImagesAlt, BscanFFTspinj.cpp:258-450)."""
    from fdoct_tpu_torch.sinks import RunWriter
    from fdoct_tpu_torch.utils.imageio import write_png

    cfg = _load_cfg(args)
    src = _make_source(args, cfg)
    sink = RunWriter(args.outdir, cfg.dirdescr, fmt="m")
    it = _frame_iter(src, _idle_timeout(args))
    n = args.sets
    m = args.frames_per_set or cfg.manualaverages
    # with a trigger-mode daemon attached, fire one software pulse per
    # wanted frame: the daemon emits exactly one frame per pulse
    trig_fn = getattr(src, "trigger", None)
    fire = callable(trig_fn) and getattr(src, "triggered", False)
    for si in range(n):
        if fire:
            trig_fn(m)
        for fi in range(m):
            frame = next(it)
            if frame.dtype == np.uint8 and args.bits16:
                frame = frame.astype(np.uint16) << 8
            write_png(sink.dir / f"Trig{si:03d}-{fi:03d}.png", frame)
        if args.alternate:  # '|' key: alternate signal/J0 sets
            pi = src.pi_frame()
            for fi in range(m):
                write_png(sink.dir / f"KTrig{si:03d}-{fi:03d}.png", pi)
    print(f"captured {n} sets of {m} frames in {sink.dir}")
    return 0


def cmd_offline(args) -> int:
    """Offline reconstruction of a captured directory.

    argv protocol matches the tool the reference spawns: positional
    {dirname, manualaverages} (BscanFFTspinj.cpp:1139, 2389-2412)."""
    from fdoct_tpu_torch.calibration import Calibration
    from fdoct_tpu_torch.pipeline import form_bscan, reconstruct
    from fdoct_tpu_torch.sources import DirectorySource
    from fdoct_tpu_torch.utils.colormap import apply_jet
    from fdoct_tpu_torch.utils.imageio import read_png_gray, write_png

    dev = args.device
    cfg = _load_cfg(args)
    src = DirectorySource(args.dirname)
    sets = src.sets(False)
    if not sets:
        print(f"no Trig*.png sets in {args.dirname}", file=sys.stderr)
        return 1
    first = next(_frame_iter(src, _idle_timeout(args)))
    h, w = first.shape
    cfg = cfg.replace(width=w * max(cfg.binvalue, 1), height=h * max(cfg.binvalue, 1))
    calib = Calibration.create(cfg, dev)
    outdir = Path(args.dirname)
    bg = torch.full((cfg.oph, cfg.opw), float(max(first.max(), 1)), dtype=torch.float32,
                    device=dev)
    pi = torch.zeros((cfg.oph, cfg.opw), dtype=torch.float32, device=dev)
    navg = args.manualaverages
    for si, paths in sorted(sets.items()):
        frames = np.stack([read_png_gray(p) for p in paths[:navg or None]])
        mags = reconstruct(torch.as_tensor(frames).to(dev), bg, pi, calib, cfg,
                           method=args.method)
        disp = to_host(form_bscan(mags.sum(0), cfg, averages=frames.shape[0]).bscandisp)
        write_png(outdir / f"offline_bscan{si:03d}.png", disp)
        write_png(outdir / f"offline_bscanc{si:03d}.png", apply_jet(disp))
    print(f"reconstructed {len(sets)} sets in {outdir}")
    return 0


def cmd_viewport(args) -> int:
    """Viewport saver: dump N raw frames as PNGs (ViewportSaver role; for
    color frames also applies the ViewportSaverc white balance and r/g/b
    single-channel display toggle)."""
    from fdoct_tpu_torch.sinks import RunWriter

    cfg = _load_cfg(args)
    src = _make_source(args, cfg)
    sink = RunWriter(args.outdir, cfg.dirdescr, fmt="m")
    it = _frame_iter(src, _idle_timeout(args))
    for i in range(args.frames):
        frame = next(it)
        peak = 255.0 if frame.dtype == np.uint8 else 65535.0
        if frame.ndim == 3:
            # white balance (ViewportSaverc: WB R/G/B from ini) in RGB order
            wb = np.asarray([cfg.wb_red, cfg.wb_green, cfg.wb_blue])
            frame = np.clip(frame * wb, 0, peak).astype(frame.dtype)
            if args.channel in ("r", "g", "b"):
                frame = frame[..., "rgb".index(args.channel)]
        if cfg.vgamma != 1.0:
            frame = (np.clip((frame / peak) ** cfg.vgamma, 0, 1) * peak).astype(frame.dtype)
        sink.save_image(f"frame{i:03d}", frame)
    print(f"saved {args.frames} frames in {sink.dir}")
    return 0


def cmd_fps(args) -> int:
    """Source frame-rate measurement (the Displayspin/Displayspinmt role:
    fps over a measurement window, Displayspin.cpp:168-253)."""
    from fdoct_tpu_torch.utils.profiling import FpsMeter

    cfg = _load_cfg(args)
    src = _make_source(args, cfg)
    meter = FpsMeter(window_s=args.window)
    it = _frame_iter(src, _idle_timeout(args))
    t_end = time.monotonic() + args.seconds
    while time.monotonic() < t_end:
        frame = next(it)
        reading = meter.tick()
        if reading is not None:
            print(f"fps = {reading:.1f}  max intensity = {int(frame.max())}")
    print(f"final fps = {meter.fps:.1f}")
    return 0


def _convert(args, mode: str) -> int:
    """FileStorage XML → .m converters (BscanFFTxml2m/mm/ms.cpp roles):
    'm' = one .m with all matrices, 'mm' = one .m per matrix,
    'ms' = one .m per matrix with a single variable each."""
    from fdoct_tpu_torch.sinks import matlab_matrix
    from fdoct_tpu_torch.utils.cvxml import read_xml

    mats, scalars = read_xml(args.xmlfile)
    stem = Path(args.xmlfile).with_suffix("")
    if mode == "m":
        lines = [f"{k}={matlab_matrix(v)};" for k, v in mats.items()]
        lines += [f"{k}={v};" for k, v in scalars.items()]
        out = Path(f"{stem}_xml2m.m")
        out.write_text("\n".join(lines) + "\n")
        print(f"wrote {out}")
    else:
        for k, v in mats.items():
            out = Path(f"{stem}_{k}.m")
            var = k if mode == "ms" else "data"
            out.write_text(f"{var}={matlab_matrix(v)};\n")
        print(f"wrote {len(mats)} files next to {args.xmlfile}")
    return 0


def cmd_bench(args) -> int:
    """The throughput benchmark (the JAX package's ``bench.py``) on ``--device``."""
    from fdoct_tpu_torch import bench
    return bench.main(device=args.device)


def cmd_cscan(args) -> int:
    """Volumetric C-scan: optional dispersion sweep, per-frame
    reconstruction of the whole volume on the device (with ``--mesh``, each
    rank its block of frames and rows, the volume gathered whole), npz
    volume + per-frame PNGs + en-face MIP + surface map out (rank 0)."""
    from fdoct_tpu_torch.autofocus import autofocused_calibration, sweep_volume
    from fdoct_tpu_torch.calibration import Calibration
    from fdoct_tpu_torch.int8direct import Int8DirectPlan, int8_direct_supported
    from fdoct_tpu_torch.ops import normalize_minmax, to_db, to_uint8
    from fdoct_tpu_torch.parallel import (
        mesh_device, shard_frames, sharded_cscan_volume, sharded_cscan_volume_int8,
    )
    from fdoct_tpu_torch.sinks import RunWriter
    from fdoct_tpu_torch.utils.colormap import apply_jet
    from fdoct_tpu_torch.utils.imageio import write_png
    from fdoct_tpu_torch.volume import enface_projection, surface_map

    dev = args.device
    mesh = _parse_mesh(args.mesh, dev, args) if getattr(args, "mesh", "") else _default_mesh(dev)
    if mesh is not None:
        dev = mesh_device(mesh)
    lead = _is_lead()
    cfg = _load_cfg(args)
    # on a world of several ranks rank 0 alone reads the source and sends the
    # volume and the background to the others
    volume_raw = bg_raw = None
    if lead:
        src = _make_source(args, cfg)
        if getattr(args, "image", None):
            cfg = _autosize(cfg, src)
        it = _frame_iter(src, _idle_timeout(args))
        volume_raw = np.stack([next(it) for _ in range(args.frames)])
        bg_raw = src.background()
    if _world_size() > 1:
        cfg = _from_lead([cfg])[0]
        volume_raw, bg_raw = [to_host(_array_from_lead(a, dev)) for a in (volume_raw, bg_raw)]
    calib = Calibration.create(cfg, dev)
    bg, pi = _background(bg_raw, cfg, dev)

    if args.dispersion_sweep:
        grid = torch.linspace(-8.0, 8.0, 33, dtype=torch.float64)
        _, best = sweep_volume(torch.as_tensor(volume_raw[:1]).to(dev), bg, pi, calib, cfg,
                               grid)
        if lead:
            print(f"dispersion sweep: a2 = {best:+.2f}")
        if best:
            calib = autofocused_calibration(cfg, best, device=dev)

    # on a mesh each rank copies its block, and the volume comes back whole
    frames = (torch.as_tensor(volume_raw).to(dev) if mesh is None
              else shard_frames(volume_raw, mesh))
    # int8-direct display volumes when the config asks and the folding
    # applies; dispersion-swept calibrations fold the same way since the
    # phase lives inside the operator
    if (cfg.matmul_precision == "int8_direct" and args.method == "fused"
            and volume_raw.dtype == np.uint8 and int8_direct_supported(cfg)[0]):
        plan = Int8DirectPlan.create(calib, cfg, bg, pi, device=dev)
        if lead:
            print(f"int8-direct volume path (bg rank-1 residual "
                  f"{float(plan.bg_rank1_resid):.2e})", file=sys.stderr)
        vol = sharded_cscan_volume_int8(frames, plan, cfg, mesh, gather_full=True)
    else:
        vol = sharded_cscan_volume(frames, bg, pi, calib, cfg, mesh, method=args.method,
                                   gather_full=True)
    if not lead:
        return 0

    sink = RunWriter(args.outdir, cfg.dirdescr, fmt="npz")
    sink.save_data("cscan", to_host(vol))
    db = to_db(vol + 1e-5, eps=0.0, compat=cfg.compat)
    for i in range(0, vol.shape[0], max(1, vol.shape[0] // 8)):
        u8 = to_host(to_uint8(normalize_minmax(db[i])))
        write_png(sink.dir / f"cscan_frame{i:03d}.png", apply_jet(u8))

    # volumetric views: en-face MIP + surface topography
    u8 = to_host(to_uint8(normalize_minmax(enface_projection(db, "max"))))
    write_png(sink.dir / "enface_mip.png", apply_jet(u8))
    surf = surface_map(vol)
    sink.save_data("surface", to_host(surf))
    write_png(sink.dir / "surface_map.png",
              to_host(to_uint8(normalize_minmax(surf.to(torch.float32)))))
    sink.close()
    print(f"C-scan {tuple(vol.shape)} written to {sink.dir} (+ enface_mip.png, surface_map.png)")
    return 0


def cmd_sweep(args) -> int:
    """Dispersion autofocus over a replay/synthetic source: sweep a2 on a
    frame, report the winner, optionally write the focused B-scan."""
    from fdoct_tpu_torch.autofocus import (
        autofocused_calibration, sweep_volume, sweep_volume_2d,
    )
    from fdoct_tpu_torch.calibration import Calibration
    from fdoct_tpu_torch.pipeline import form_bscan, reconstruct
    from fdoct_tpu_torch.utils.colormap import apply_jet
    from fdoct_tpu_torch.utils.imageio import write_png

    dev = args.device
    cfg = _load_cfg(args)
    src = _make_source(args, cfg)
    if getattr(args, "image", None):
        cfg = _autosize(cfg, src)
    calib = Calibration.create(cfg, dev)
    raw = torch.as_tensor(next(_frame_iter(src, _idle_timeout(args)))).to(dev)
    bg, pi = _background(src.background(), cfg, dev)
    grid = torch.linspace(args.a2_min, args.a2_max, args.steps, dtype=torch.float64)
    best_a3 = 0.0
    if args.joint:
        a3_grid = torch.linspace(args.a3_min, args.a3_max, max(args.steps // 2, 3),
                                 dtype=torch.float64)
        _, best, best_a3 = sweep_volume_2d(raw[None], bg, pi, calib, cfg, grid, a3_grid)
        print(f"best a2 = {best:+.3f}, a3 = {best_a3:+.3f}")
    else:
        scores, best = sweep_volume(raw[None], bg, pi, calib, cfg, grid)
        print(f"best a2 = {best:+.3f}  (scores {float(scores.min()):.3e}.."
              f"{float(scores.max()):.3e})")
    if args.out:
        calib2 = autofocused_calibration(cfg, best, best_a3, device=dev)
        mags = reconstruct(raw, bg, pi, calib2, cfg, args.method)
        write_png(args.out, apply_jet(to_host(form_bscan(mags, cfg, 1).bscandisp)))
        print(f"focused B-scan written to {args.out}")
    return 0


def cmd_selftest(args) -> int:
    """Deployment self-check: synthetic physics → both reconstruction paths
    → agreement + known-depth peak, the sharded parity over the world's
    ranks when it has more than one (under torchrun), and the camera ring.
    Exit 0 = healthy."""
    import shutil
    import tempfile

    from fdoct_tpu_torch.calibration import Calibration
    from fdoct_tpu_torch.config import PipelineConfig
    from fdoct_tpu_torch.pipeline import reconstruct
    from fdoct_tpu_torch.sources.camera import _NATIVE_DIR, CameraSource
    from fdoct_tpu_torch.sources.synthetic import SyntheticSource

    dev = args.device
    cfg = PipelineConfig(width=256, height=16, averages=2, numfftpoints=512,
                         numdisplaypoints=160, dtype="float32")
    calib = Calibration.create(cfg, dev)
    src = SyntheticSource(height=16, width=256, depths_um=(50.0,), reflectivities=(0.5,))
    raw = torch.as_tensor(np.stack([next(_frame_iter(src))] * 2)).to(dev)
    bg = torch.as_tensor(np.maximum(src.background(), 1).astype(np.float32)).to(dev)
    pi = torch.zeros_like(bg)
    ok = True

    a = to_host(reconstruct(raw, bg, pi, calib, cfg, "gather"))
    b = to_host(reconstruct(raw, bg, pi, calib, cfg, "fused"))
    # 'default' on CUDA multiplies bf16-rounded operands: ~1e-3 relative
    # between the matmul and FFT paths (display-invisible); CPU f32 ~1e-7
    agree = np.allclose(a, b, rtol=5e-3, atol=5e-3 * a.max())
    print(f"[{'ok' if agree else 'FAIL'}] gather/fused agreement "
          f"(max rel {np.abs(a - b).max() / a.max():.2e}) on {dev}")
    ok &= agree

    kl = to_host(calib.klinear)
    expect = 50e-6 * (kl[-1] - kl[0]) / np.pi
    ascan = a[0, 0].copy()
    ascan[:5] = 0
    peak = int(np.argmax(ascan))
    hit = abs(peak - expect) <= 2
    print(f"[{'ok' if hit else 'FAIL'}] scatterer depth bin {peak} (expect ~{expect:.1f})")
    ok &= hit

    import torch.distributed as dist

    from fdoct_tpu_torch.parallel import initialize_multihost
    from fdoct_tpu_torch.parallel.distributed import backend_for

    if not dist.is_initialized():
        initialize_multihost(backend=backend_for(dev.type))
    n = dist.get_world_size() if dist.is_initialized() else 1
    n_data = 2 if n % 2 == 0 and n > 1 else 1
    n_ascan = n // n_data
    if n > 1 and raw.shape[0] % n_data == 0 and cfg.oph % n_ascan == 0:
        from fdoct_tpu_torch.parallel import (
            gather_rows, make_mesh, shard_frames, sharded_bscan_step,
        )
        from fdoct_tpu_torch.pipeline import form_bscan

        mesh = make_mesh(n_data, n_ascan, device_type=dev.type)
        db, _ = sharded_bscan_step(shard_frames(raw, mesh), bg, pi, calib, cfg, mesh)
        ref = form_bscan(torch.as_tensor(b).to(dev).sum(0), cfg, 2).bscandb
        par = bool(torch.allclose(gather_rows(db, mesh), ref, atol=1e-4))
        print(f"[{'ok' if par else 'FAIL'}] sharded parity over {n} devices")
        ok &= par
    else:
        print("[--] single device; sharded parity skipped")

    # native acquisition seam: ring + daemon + control loop (skipped when
    # no C++ toolchain / prebuilt binaries are available)
    if (_NATIVE_DIR / "capture_daemon").exists() or shutil.which("g++") is not None:
        try:
            with tempfile.TemporaryDirectory() as td:
                cam = CameraSource(Path(td) / "selftest.ring", daemon_args=["--synthetic"],
                                   width=64, height=16, fps=500.0)
                try:
                    it = iter(cam.frames())
                    bright = float(next(it).mean())
                    cam.set_param("exposure", 250.0)
                    acked = cam.reader.wait_ctrl_applied(5.0)
                    for _ in range(3):
                        dim_frame = next(it)
                    dim = float(dim_frame.mean())
                    ring_ok = acked and dim < bright * 0.5
                    print(f"[{'ok' if ring_ok else 'FAIL'}] camera ring + control loop "
                          f"(mean {bright:.1f} -> {dim:.1f})")
                    ok &= ring_ok
                finally:
                    cam.close()
        except Exception as e:          # a broken seam is a failed check, not a crash
            print(f"[FAIL] camera ring: {type(e).__name__}: {e}")
            ok = False
    else:
        print("[--] no native toolchain; camera ring check skipped")

    print("selftest", "PASSED" if ok else "FAILED")
    return 0 if ok else 1


def cmd_configedit(args) -> int:
    """Edit fields of a positional ini in place (the role of the reference's
    Octave GUI editors build/editini.m / editiniadv.m, which poke specific
    line numbers; here fields are addressed by name)."""
    from fdoct_tpu_torch.config import SCHEMAS, read_ini, write_ini

    # no validation here: configedit must be able to open a broken ini in
    # order to repair it (the reference's editini.m has no validation at all)
    cfg = read_ini(args.inifile, args.variant, validate=False)
    schema_names = {n for n, _ in SCHEMAS[args.variant]}
    for kv in args.set or []:
        key, _, val = kv.partition("=")
        if key not in schema_names:
            print(f"unknown field {key!r} for variant {args.variant}; "
                  f"have {sorted(schema_names)}", file=sys.stderr)
            return 1
        typ = type(getattr(cfg, key))
        cfg = cfg.replace(**{key: typ(int(val)) if typ is bool else typ(val)})
    if args.set:
        write_ini(cfg, args.inifile, args.variant)
        print(f"updated {args.inifile}")
    else:
        for name, _ in SCHEMAS[args.variant]:
            print(f"{name} = {getattr(cfg, name)}")
    return 0


def build_parser() -> argparse.ArgumentParser:
    from fdoct_tpu_torch import __version__

    p = argparse.ArgumentParser(prog="fdoct-torch", description=__doc__.split("\n\n")[0])
    p.add_argument("--version", action="version", version=f"fdoct-tpu-torch {__version__}")
    sub = p.add_subparsers(dest="cmd", required=True)

    def device(sp):
        sp.add_argument("--device", default="cuda",
                        help="torch device to compute on (default cuda; cpu runs the "
                             "kernels' plain versions)")

    def common(sp, source=True):
        device(sp)
        sp.add_argument("--config", help=".ini or .json config file")
        sp.add_argument("--variant", default="base",
                        help="ini schema variant (base/webcam/dark/peak/spinj/spinjnt)")
        sp.add_argument("--outdir", default=".")
        sp.add_argument("--format", default="m", choices=["m", "xml", "npz"])
        sp.add_argument("--method", default="fused", choices=["fused", "gather"])
        sp.add_argument("--precision", default="",
                        choices=["", "default", "highest", "bf16", "int8", "int8_direct"],
                        help="matmul precision override: int8_direct = the folded s8 "
                             "display path (display mode only), highest = f32 for "
                             "metrology; default inherits the config")
        if source:
            sp.add_argument("--image", help="interferogram PNG to replay")
            sp.add_argument("--background", help="background PNG")
            sp.add_argument("--pi", help="pi-shifted PNG")
            sp.add_argument("--camera", metavar="RING",
                            help="read frames from a native shared-memory ring (the camera "
                                 "shim; spawns the capture daemon unless --camera-daemon none)")
            sp.add_argument("--camera-daemon", default="synthetic",
                            help="daemon source: synthetic | pgm:DIR | v4l2:DEV | qhy | "
                                 "spinnaker | none (attach to an already-running daemon's "
                                 "ring)")
            sp.add_argument("--camera-fps", type=float, default=100.0)
            sp.add_argument("--trigger", default="none", choices=["none", "sw", "hw"],
                            help="daemon trigger mode: sw = software pulses (t/k/| keys fire "
                                 "them), hw = hardware Line0 (Spinnaker; BscanFFTspinj)")
            sp.add_argument("--idle-timeout", type=float, default=IDLE_TIMEOUT_DEFAULT_S,
                            metavar="S",
                            help="error out after S seconds of a triggered source yielding "
                                 "no frames; <= 0 waits forever.  Applies to the sequential "
                                 "consumers (sim/capture/viewport/fps/cscan/sweep); `live` "
                                 "services the pulse-firing keys itself and ignores it")

    sp = sub.add_parser("sim", help="replay reconstruction")
    common(sp)
    sp.add_argument("--frames", type=int, default=1)
    sp.add_argument("--debug-dump", action="store_true",
                    help="save first-frame linearized spectrum + nearestkindex "
                         "(BscanFFTsim debug dump)")
    sp.add_argument("--strict-sim", action="store_true",
                    help="emulate the simulator's copyTo averaging slot exactly (only the "
                         "last frame of each group is displayed; see config.simcopyto)")
    sp.set_defaults(fn=cmd_sim)

    sp = sub.add_parser("live", help="streaming session")
    common(sp)
    sp.add_argument("--frames", type=int, default=0, help="0 = until 'x' key")
    sp.add_argument("--batch", type=int, default=1,
                    help="frames per dispatch (>1 = batched fast path via "
                         "Session.process_group; use a multiple of the averaging count)")
    sp.add_argument("--mesh", default="", metavar="DxA",
                    help="run the live session over a ('data', 'ascan') device mesh, one "
                         "process per device (torchrun --nproc-per-node D*A; 1x1 needs none)")
    sp.add_argument("--verbose", action="store_true")
    sp.add_argument("--trace", metavar="LOGDIR", default="",
                    help="write a torch.profiler Chrome trace of the live loop here")
    sp.add_argument("--checkpoint", metavar="PATH",
                    help="save session state (config + calibration tensors + knobs) here on "
                         "exit; SIGTERM/SIGINT also exit cleanly through this save")
    sp.add_argument("--checkpoint-every", type=int, default=0, metavar="N",
                    help="with --checkpoint: also write it (atomically, npz) every N "
                         "completed B-scan groups")
    sp.add_argument("--resume", metavar="PATH",
                    help="restore session state from an npz checkpoint (written by "
                         "fdoct-torch or fdoct) instead of starting cold")
    sp.add_argument("--viewer", default="",
                    help="render display windows into this directory (--viewer-mode files)")
    sp.add_argument("--viewer-mode", default="files", choices=["files", "mpl", "http"])
    sp.add_argument("--viewer-port", type=int, default=8089,
                    help="http viewer port (0 = ephemeral)")
    sp.set_defaults(fn=cmd_live)

    sp = sub.add_parser("capture", help="batch capture Trig sets")
    common(sp)
    sp.add_argument("--sets", type=int, default=1)
    sp.add_argument("--frames-per-set", type=int, default=0)
    sp.add_argument("--alternate", action="store_true",
                    help="also write KTrig J0 sets ('|' trigger mode)")
    sp.add_argument("--bits16", action="store_true")
    sp.set_defaults(fn=cmd_capture)

    sp = sub.add_parser("offline", help="offline reconstruction of Trig dir")
    sp.add_argument("dirname")
    sp.add_argument("manualaverages", type=int, nargs="?", default=0)
    common(sp, source=False)
    sp.set_defaults(fn=cmd_offline)

    sp = sub.add_parser("viewport", help="save raw frames")
    common(sp)
    sp.add_argument("--frames", type=int, default=1)
    sp.add_argument("--channel", default="", choices=["", "r", "g", "b"],
                    help="single-channel display toggle (ViewportSaverc)")
    sp.set_defaults(fn=cmd_viewport)

    sp = sub.add_parser("fps", help="measure source frame rate")
    common(sp)
    sp.add_argument("--seconds", type=float, default=5.0)
    sp.add_argument("--window", type=float, default=1.0)
    sp.set_defaults(fn=cmd_fps)

    for mode in ("m", "mm", "ms"):
        sp = sub.add_parser(f"xml2{mode}", help=f"XML → .m ({mode})")
        sp.add_argument("xmlfile")
        sp.set_defaults(fn=lambda a, m=mode: _convert(a, m))

    sp = sub.add_parser("bench", help="A-scans/s benchmark on the card (one JSON line)")
    device(sp)
    sp.set_defaults(fn=cmd_bench)

    sp = sub.add_parser("cscan", help="volumetric C-scan")
    common(sp)
    sp.add_argument("--frames", type=int, default=32)
    sp.add_argument("--mesh", default="", metavar="DxA",
                    help="reconstruct the volume over a ('data', 'ascan') device mesh, one "
                         "process per device (default: this device alone)")
    sp.add_argument("--dispersion-sweep", action="store_true")
    sp.set_defaults(fn=cmd_cscan)

    sp = sub.add_parser("sweep", help="dispersion autofocus sweep")
    common(sp)
    sp.add_argument("--a2-min", type=float, default=-8.0)
    sp.add_argument("--a2-max", type=float, default=8.0)
    sp.add_argument("--a3-min", type=float, default=-3.0)
    sp.add_argument("--a3-max", type=float, default=3.0)
    sp.add_argument("--joint", action="store_true", help="joint (a2, a3) 2D sweep")
    sp.add_argument("--steps", type=int, default=33)
    sp.add_argument("--out", default="", help="write focused B-scan PNG here")
    sp.set_defaults(fn=cmd_sweep)

    sp = sub.add_parser("selftest", help="numerical self-check")
    device(sp)
    sp.set_defaults(fn=cmd_selftest)

    sp = sub.add_parser("configedit", help="view/edit ini fields by name")
    sp.add_argument("inifile")
    sp.add_argument("--variant", default="base")
    sp.add_argument("--set", action="append", metavar="FIELD=VALUE")
    sp.set_defaults(fn=cmd_configedit)
    return p


def main(argv: list[str] | None = None) -> int:
    args = build_parser().parse_args(argv)
    # the capture daemons this run spawns (see _make_source), stopped on
    # every exit: no orphans, also when main() is called in-process
    args.open_sources = []
    try:
        if hasattr(args, "device"):
            args.device = _device(args.device)
        return args.fn(args)
    except SourceTimeoutError as e:
        print(f"fdoct-torch {args.cmd}: {e}", file=sys.stderr)
        return 1
    finally:
        while args.open_sources:
            args.open_sources.pop().close()


if __name__ == "__main__":
    sys.exit(main())
