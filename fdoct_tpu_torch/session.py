"""Interactive session: the reference's keystroke state machine, on tensors.

The port of ``fdoct_tpu/session.py``.  The reference's acquisition loop
mixes compute with a single-key command dispatch (BscanFFT.cpp:1584-1917)
and capture logic scattered through the hot loop (background 'b'
1000-1075, π/J0 'p' 1077-1099, J-lockin 'j'/'c' 1292-1304, save 's'
1307-1397, manual averaging 1399-1477, double ring buffers 1482-1488;
BscanDark adds the dark, reference-arm and sample-arm captures 'o'/'r'/'t',
BscanDark.cpp:1005-1221).  Here all of that is a :class:`Session`: device
state is tensors on ``device``, control state plain fields, and one
:meth:`Session.process` call per raw frame is one reference loop iteration.
Keys arrive through :meth:`Session.key` with the reference's bindings.

:meth:`Session.process_group` runs whole averaging groups: in the steady
state one :func:`fdoct_tpu_torch.pipeline.reconstruct_group` kernel launch
and one display chain per group, and only the uint8 displays leave the
device.  The ``saveframes`` ring costs a launch per frame instead
(:func:`~fdoct_tpu_torch.pipeline.reconstruct_group_frames`).  With
``matmul_precision='int8_direct'`` and a config the folding supports, the
captures fold into an :class:`~fdoct_tpu_torch.int8direct.Int8DirectPlan`
and each group is one launch of the int8 B-scan kernel plus a small tail.
The batch's step is a pure function, :func:`session_group_pipeline` or
:func:`session_group_pipeline_int8` (the JAX package's one-dispatch
programs); on the CPU the session calls it, on CUDA it replays the step's
captured CUDA graph (:mod:`fdoct_tpu_torch.graphs`), so a batch is one
replay instead of some twenty Python launches a group.  So does the mesh
path, with its collectives in the graph.  The per-frame path runs eagerly
(``graphs.EAGER_ROUTES``).

Variants 'base', 'sim', 'dark', 'peak' and 'spinj'.  The ring buffers keep
their frames and magnitudes on the device; a save ('s'), a plugin or
J-lockin moves to the host only what it writes or reads.  With a device
mesh (``mesh=``, :mod:`fdoct_tpu_torch.parallel`) every rank runs the session
on the same frames and each group runs the sharded session step on the
rank's block: the group kernels on its frames and rows, the frame sum over
'data', the display scale over 'ascan'; the displays are then gathered, so
plugins, saves, rings and J-lockin see whole B-scans on every rank.
"""

from __future__ import annotations

import dataclasses
import subprocess
import sys
from typing import Any, Callable

import numpy as np
import torch

from fdoct_tpu_torch.calibration import Calibration
from fdoct_tpu_torch.graphs import EAGER_ROUTES, CapturedStep
from fdoct_tpu_torch.int8direct import (
    Int8DirectPlan, int8_bscan_outputs, int8_direct_supported, reconstruct_int8_direct,
    shift_u8_to_s8,
)
from fdoct_tpu_torch.ops import (
    bscan_rebin, channel_select, make_only_positive, normalize_minmax, normalize_rows,
    threshold_floor, to_db, to_uint8,
)
from fdoct_tpu_torch.ops.fft import lowpass_rowwise
from fdoct_tpu_torch.parallel.mesh import axis_size, mesh_device
from fdoct_tpu_torch.parallel.sharded import (
    batch_block, session_mesh_pipeline, session_mesh_pipeline_int8,
)
from fdoct_tpu_torch.pipeline import (
    BscanOutputs, as_torch_dtype, form_bscan, preprocess, raw_kernel_applies, reconstruct_group,
    reconstruct_group_frames,
)
from fdoct_tpu_torch.plugins import ROIPlugin, VibrometryPlugin
from fdoct_tpu_torch.sinks import RunWriter
from fdoct_tpu_torch.utils import to_device, to_host
from fdoct_tpu_torch.utils.imageio import write_png
from fdoct_tpu_torch.utils.profiling import FpsMeter

#: the session variants (SURVEY.md §2.1)
VARIANTS = ("base", "sim", "dark", "peak", "spinj")


@dataclasses.dataclass
class BscanResult:
    """One completed averaging group.  ``bscandisp``, ``sub_disp`` and
    ``manual_disp`` are host uint8 arrays; ``bscan`` and ``bscandb`` stay on
    the session's device."""
    bscan: torch.Tensor       # linear, (ndisp, oph)
    bscandb: torch.Tensor     # dB with DC rows masked
    bscandisp: np.ndarray     # uint8 display
    index: int                # save counter at completion
    sub_disp: np.ndarray | None = None      # J-lockin subtracted display
    manual_disp: np.ndarray | None = None   # manual-average display
    status: list[str] = dataclasses.field(default_factory=list)


class Session:
    """One live or replay reconstruction session on one device.

    cfg: pipeline configuration.  device: where the tensors live, e.g.
    ``"cuda"`` or ``"cpu"``.  variant: one of :data:`VARIANTS`.  sink: a
    :class:`~fdoct_tpu_torch.sinks.RunWriter` for saves.  camera: a control
    callback ``camera(param, value)`` for exposure and gain changes.
    source: with the 'sim' variant, the source whose
    ``background()``/``pi_frame()`` the 'b' and 'p' captures read
    (BscanFFTsim.cpp:806-825); a ``trigger(n)`` method, when it has one,
    fires the triggered captures.  method: the reconstruction of
    :func:`fdoct_tpu_torch.pipeline.ascan_mags` ('fused', 'fused_exact', or
    'gather'/'hilbert', which launch no kernel).  mesh: a ('data', 'ascan')
    ``DeviceMesh`` of :func:`fdoct_tpu_torch.parallel.make_mesh` whose device
    type is ``device``'s; the session then lives on the rank's device
    (:func:`~fdoct_tpu_torch.parallel.mesh_device`) and its batched path runs
    on the mesh where the batch divides it (:meth:`_mesh_ok`).
    """

    def __init__(self, cfg, device: torch.device | str, variant: str = "base",
                 sink: RunWriter | None = None,
                 camera: Callable[[str, Any], None] | None = None,
                 source: Any = None, method: str = "fused",
                 calib: Calibration | None = None, mesh: Any = None):
        if variant not in VARIANTS:
            raise ValueError(f"unknown variant {variant!r}; one of {VARIANTS}")
        self.cfg = cfg
        self.device = torch.device(device)
        self.mesh = mesh
        if mesh is not None:
            if mesh.device_type != self.device.type:
                raise ValueError(f"a {mesh.device_type} mesh for a session on {self.device}")
            self.device = mesh_device(mesh)
        self.variant = variant
        self.sink = sink
        self.camera = camera
        self.source = source
        self.method = method
        self.calib = calib or Calibration.create(cfg, self.device)
        dt = getattr(torch, cfg.dtype)
        oph, opw, ndisp = cfg.oph, cfg.opw, self.calib.ndisp

        def zeros(*shape):
            return torch.zeros(shape, dtype=dt, device=self.device)

        # device state (the reference's Mats)
        self.data_yb = torch.ones((oph, opw), dtype=dt, device=self.device)   # S(k)
        self.data_yp = zeros(oph, opw)                      # π / J0 spectrum
        self.data_yd = zeros(oph, opw)                      # dark (BscanDark)
        self.data_yr = zeros(oph, opw)                      # reference arm
        self.data_ys = zeros(oph, opw)                      # sample arm
        self.accum = zeros(oph, ndisp)
        self.baccum = zeros(oph, opw)
        self.manualaccum = zeros(ndisp, oph)
        self.jscansave: torch.Tensor | None = None

        # control state (the reference's flags and counters)
        self.averages = cfg.averages
        self.averagestoggle = cfg.averages                  # BscanFFT.cpp:481
        # the simulator display has no threshold floor (BscanFFTsim.cpp:1131)
        self.bscanthreshold = -np.inf if variant == "sim" else cfg.bscanthreshold
        self.exposure_us = cfg.exposure_us
        self.gain = cfg.gain
        self.ascanat = 20                                   # BscanFFT.cpp:362
        self.vertposROI = 10
        self.widthROI = 10
        self.ROIreport = False
        self.jlockin = False
        self.done = False
        self.indextemp = 0
        self.indexi = 0                                     # save counter
        self.manualindexi = 0
        self.baccumcount = 0
        self.manualaccumcount = 0
        self.zeroisactive = True                            # ring toggle
        self._pending: set[str] = set()
        self._dark_counts = {"dark": 0, "ref": 0, "sample": 0}
        self._dark_accum: dict[str, torch.Tensor] = {}
        # double ring buffers (BscanFFT.cpp:569-583), on the device: per-frame
        # magnitudes and raw frames of the active group and of the one
        # before, for the save-after-the-fact story.  The reference's third
        # ring, the preprocessed frames, is preprocess of the raw one: the
        # 'b' capture that reads it forms it then
        self._rings = {0: {"bscan": [], "raw": []}, 1: {"bscan": [], "raw": []}}
        self._trig: dict | None = None
        self._trig_set = 0
        self._offline_proc = None
        self._said_once: set[str] = set()
        self.status: list[str] = []
        self.fpsmeter = FpsMeter(window_s=5.0)              # BscanFFT.cpp:1100-1119
        self.fps = 0.0
        self.max_intensity = 0
        self._i8plan: Int8DirectPlan | None = None
        self._i8key: tuple | None = None
        self._pi_fold: torch.Tensor | None = None
        self._pi_fold_key: tuple | None = None
        # the f32 step's display floor: a device scalar written before each
        # step, so that a captured graph reads the current bscanthreshold
        self._thresh = torch.zeros((), dtype=dt, device=self.device)
        # the captured group steps (CUDA sessions only), one per key
        self.graphs = CapturedStep()
        # the vibrometry key set is the peak variant's; every other variant
        # carries the flagship app's ROI analytics (printAvgROI,
        # BscanFFT.cpp:99-171), toggled by 'e'
        self.plugins: list[Any] = [VibrometryPlugin(cfg.lambda0, cfg.peakholdnumframes)
                                   if variant == "peak" else ROIPlugin()]

    @property
    def clampupper(self) -> bool:
        """Absolute-scale display mode (the 'q' key, BscanFFT.cpp:1248-53);
        it lives in cfg because form_bscan reads ``cfg.clampupper``."""
        return self.cfg.clampupper

    @clampupper.setter
    def clampupper(self, value: bool) -> None:
        self.cfg = self.cfg.replace(clampupper=bool(value))

    # ------------------------------------------------------------------
    # keys (BscanFFT.cpp:1584-1917, keyboardshortcuts.txt)
    # ------------------------------------------------------------------

    _EXPOSURE_KEYS = {"+": 100, "=": 100, "-": -100, "_": -100,
                      "u": 1000, "d": -1000, "U": 10000, "D": -10000}
    _PENDING_KEYS = {"s": "s", "S": "s", " ": "s", "b": "b", "B": "b", "p": "p", "P": "p",
                     "j": "j", "J": "j", "c": "c", "C": "c"}
    _DARK_KEYS = {"o": "dark", "O": "dark", "r": "ref", "R": "ref", "t": "sample",
                  "T": "sample"}                           # BscanDark.cpp 'o'/'r'/'t'
    _TRIG_KEYS = {"t": "Trig", "T": "Trig", "k": "KTrig", "K": "KTrig", "|": "Alt",
                  "\\": "Alt"}                             # BscanFFTspinj.cpp:2332-2345

    def key(self, ch: str) -> None:
        """Apply one keypress.  A key no branch and no plugin takes is
        ignored, as the reference's ``default: break``."""
        cfg = self.cfg
        spinj = self.variant == "spinj"
        if ch in ("\x1b", "x", "X"):
            self.done = True
        elif ch in self._EXPOSURE_KEYS:
            # Spinnaker has an 8 µs exposure floor (BscanFFTspinjnt '-' key);
            # QHY clamps at 0 (BscanFFT.cpp:1623-1624)
            floor = 8 if spinj else 0
            self.exposure_us = max(floor, self.exposure_us + self._EXPOSURE_KEYS[ch])
            if self.camera:
                self.camera("exposure", self.exposure_us)
            self._say(f"Exp time = {self.exposure_us} ")
        elif ch in self._PENDING_KEYS:
            self._pending.add(self._PENDING_KEYS[ch])
        elif ch == "]":
            self.bscanthreshold += 1.0
            self._say(f"bscanthreshold = {self.bscanthreshold:f}")
        elif ch == "[":
            self.bscanthreshold -= 1.0
            self._say(f"bscanthreshold = {self.bscanthreshold:f}")
        elif ch in ("(", "9", ")", "0"):
            if ch == "(" and self.ascanat > 10:
                self.ascanat -= 10
            elif ch == "9" and self.ascanat > 0:
                self.ascanat -= 1
            elif ch == ")" and self.ascanat < cfg.oph - 11:
                self.ascanat += 10
            elif ch == "0" and self.ascanat < cfg.oph - 1:
                self.ascanat += 1
            self._say(f"ascanat = {self.ascanat}")
        elif ch in ("W", "w"):
            if ch == "W" and self.ascanat + self.widthROI < cfg.oph - 1:
                self.widthROI += 1
            elif ch == "w" and self.widthROI > 2:
                self.widthROI -= 1
            self._say(f"ROI width = {self.widthROI}")
        elif ch in ("h", "H"):
            if ch == "h" and self.vertposROI < self.calib.ndisp - 1:
                self.vertposROI += 1
            elif ch == "H" and self.vertposROI > 2:
                self.vertposROI -= 1
            self._say(f"ROI vertical position = {self.vertposROI}")
        elif ch in ("a", "A"):
            self.averagestoggle = self.averages if self.averagestoggle == 1 else 1
            self._say(f"Now averaging {self.averagestoggle} bscans.")
        elif ch in ("e", "E"):
            self.ROIreport = not self.ROIreport
        elif ch in ("q", "Q"):
            self.clampupper = not self.clampupper
        elif self.variant == "dark" and ch in self._DARK_KEYS:
            self._pending.add(self._DARK_KEYS[ch])
        elif spinj and ch in self._TRIG_KEYS:
            self._start_trig(self._TRIG_KEYS[ch])
        elif spinj and ch in ("y", "Y"):
            self._spawn_offline_tool()                    # BscanFFTspinj.cpp:2356-2412
        elif spinj and ch in ("1", "!", "2", "@"):
            # BscanFFTspinjnt.cpp:2188
            self.gain = self.gain + 1 if ch in ("1", "!") else max(0, self.gain - 1)
            if self.camera:
                self.camera("gain", self.gain)
            self._say(f"Gain = {self.gain}")
        elif spinj and ch in ("3", "#", "4", "$"):
            # BscanFFTspinj.cpp:2541
            t = self.averagestoggle
            self.averagestoggle = {"3": t + 1, "#": t + 10, "4": t - 1 if t > 1 else t,
                                   "$": t - 10 if t > 10 else 1}[ch]
            self._say(f"Now averaging {self.averagestoggle} bscans.")
        else:
            for plugin in self.plugins:
                if plugin.key(self, ch):
                    return

    # ------------------------------------------------------------------
    # live config editing (GET/POST /config of the JAX package's viewer;
    # the live-safe knobs apply at the next loop boundary)
    # ------------------------------------------------------------------

    #: knobs applying live, with parse functions
    _LIVE_CONFIG = {
        "bscanthreshold": float, "averages": int, "exposure_us": int,
        "gain": int, "clampupper": lambda v: bool(int(v)),
        "clampupperdb": float, "manualaverages": int,
    }

    def config_snapshot(self) -> dict:
        """Current knobs: ``live`` fields apply through :meth:`apply_config`;
        ``static`` config needs a session restart."""
        live = {"bscanthreshold": self.bscanthreshold,
                "averages": self.averagestoggle,
                "exposure_us": self.exposure_us, "gain": self.gain,
                "clampupper": int(self.clampupper),
                "clampupperdb": self.cfg.clampupperdb,
                "manualaverages": self.cfg.manualaverages}
        static = {k: v for k, v in dataclasses.asdict(self.cfg).items() if k not in live}
        return {"live": {k: (None if v in (np.inf, -np.inf) else v) for k, v in live.items()},
                "static": static}

    def apply_config(self, updates: dict) -> list[str]:
        """Apply an update dict; returns one message per field (the applied
        value, or why it was rejected or needs a restart)."""
        msgs = []
        for name, raw in updates.items():
            if name not in self._LIVE_CONFIG:
                msgs.append(f"{name}: restart required (not a live knob)")
                continue
            try:
                value = self._LIVE_CONFIG[name](raw)
            except (TypeError, ValueError):
                msgs.append(f"{name}: bad value {raw!r}")
                continue
            if name in ("averages", "manualaverages") and value < 1:
                msgs.append(f"{name}: must be >= 1")
                continue
            if name == "bscanthreshold":
                self.bscanthreshold = value
            elif name == "averages":
                # like the 'a' toggle: a new group size, and the current
                # accumulation restarts
                self.averages = self.averagestoggle = value
                self.accum = torch.zeros_like(self.accum)
                self.indextemp = 0
            elif name == "exposure_us":
                self.exposure_us = max(value, 0)
                if self.camera is not None:
                    self.camera("exposure", self.exposure_us)
            elif name == "gain":
                self.gain = max(value, 0)
                if self.camera is not None:
                    self.camera("gain", self.gain)
            elif name == "clampupper":
                self.clampupper = value
            else:                                   # clampupperdb, manualaverages
                self.cfg = self.cfg.replace(**{name: value})
            msgs.append(f"{name} = {value}")
            self._say(f"config: {name} = {value}")
        return msgs

    def _say(self, text: str) -> None:
        self.status.append(text)
        if len(self.status) > 100:
            del self.status[:50]

    def _say_once(self, key: str, text: str) -> None:
        if key not in self._said_once:
            self._said_once.add(key)
            self._say(text)

    def set_roi(self, x: int, y: int, w: int, h: int) -> None:
        """Apply a drag-selected rectangle (B-scan pixel coordinates: x the
        lateral A-scan position, y the depth row), clamped to the image: the
        vibrometry ROI of the peak variant (BscanFFTpeak.cpp:112-181), else
        the ROI-analytics window the (/9/0/)/w/W/h/H keys step."""
        ndisp, oph = self.calib.ndisp, self.cfg.oph
        x = max(0, min(int(x), oph - 1))
        y = max(0, min(int(y), ndisp - 1))
        w = max(1, min(int(w), oph - x))
        h = max(1, min(int(h), ndisp - y))
        for plugin in self.plugins:
            if hasattr(plugin, "set_roi"):
                plugin.set_roi(x, y, w, h)
                self._say(f"ROI = ({x}, {y}) {w}x{h}")
                return
        self.ascanat = min(x, oph - 2)
        self.widthROI = max(2, min(w, oph - 1 - self.ascanat))
        self.vertposROI = min(y, ndisp - 1)
        self._say(f"ROI at ascan {self.ascanat}, depth {self.vertposROI}, "
                  f"width {self.widthROI}")

    # ------------------------------------------------------------------
    # spinj triggered batch capture and offline hand-off
    # ------------------------------------------------------------------

    def _start_trig(self, mode: str) -> None:
        """Begin a triggered batch capture: the next ``manualaverages`` raw
        frames are written as 16-bit Trig/KTrig PNGs ('Alt' alternates
        signal/J0 per frame, BscanFFTspinj.cpp:349-450)."""
        if self.sink is None:
            self._say("no sink; trig capture ignored")
            return
        n = max(self.cfg.manualaverages, 1)
        self._trig = {"mode": mode, "count": 0, "n": n, "set": self._trig_set}
        # a trigger-capable source fires one pulse per frame
        # (BscanFFTspinj.cpp:1695-1720); a free-running one has no trigger()
        trig_fn = getattr(self.source, "trigger", None)
        if callable(trig_fn):
            trig_fn(n * (2 if mode == "Alt" else 1))

    def _spawn_offline_tool(self) -> None:
        """Start the offline reconstruction tool with argv {dirname,
        manualaverages} (BscanFFTspinj.cpp:2389-2412): ``cfg.offline_tool_path``,
        or without one the port's own ``offline`` command on this session's
        device type."""
        dirname = str(self.sink.dir) if self.sink is not None else "."
        if self.cfg.offline_tool_path:
            cmd = [self.cfg.offline_tool_path, dirname, str(self.cfg.manualaverages)]
        else:
            cmd = [sys.executable, "-m", "fdoct_tpu_torch.cli", "offline", dirname,
                   str(self.cfg.manualaverages), "--device", self.device.type]
        self._offline_proc = subprocess.Popen(cmd)
        self._say(f"spawned offline tool for {dirname}")

    def _handle_trig(self, raw: torch.Tensor) -> None:
        trig = self._trig
        if not trig or self.sink is None:
            return
        frame = to_host(raw)
        if frame.dtype == np.uint8:
            frame = frame.astype(np.uint16) << 8            # Mono16 convert
        i = trig["count"]
        if trig["mode"] == "Alt":
            prefix = "Trig" if i % 2 == 0 else "KTrig"
            name = f"{prefix}{trig['set']:03d}-{i // 2:03d}"
        else:
            name = f"{trig['mode']}{trig['set']:03d}-{i:03d}"
        write_png(self.sink.dir / f"{name}.png", frame)
        trig["count"] += 1
        if trig["count"] >= trig["n"] * (2 if trig["mode"] == "Alt" else 1):
            self._trig_set = trig["set"] + 1
            self._say(f"{trig['mode']} capture {trig['set']:03d} done.")
            self._trig = None

    # ------------------------------------------------------------------
    # per-frame processing (one reference hot-loop iteration)
    # ------------------------------------------------------------------

    def _tick_fps(self, raw, n: int = 1) -> None:
        """fps and frame max-intensity Status rows, once per 5 s window."""
        reading = self.fpsmeter.tick(n)
        if reading is not None:
            self.fps = reading
            # CUDA has no max of uint16 (torch 2.11): widen such frames first
            wide = torch.is_tensor(raw) and raw.dtype == torch.uint16
            self.max_intensity = int((raw.int() if wide else raw).max())
            self._say(f"fps = {reading:.0f}  Max Intensity = {self.max_intensity}")

    def _dark(self) -> torch.Tensor | None:
        """The dark frame the dark variant subtracts (BscanDark.cpp:1269)."""
        return self.data_yd if self.variant == "dark" else None

    def _group_pi_dark(self, raw: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor | None]:
        """(π, dark) for :func:`reconstruct_group` on frames ``raw`` (B, H, W).
        Where the raw kernel applies (identity preprocess and normalization),
        (y − yd − yp)/yb = (raw − (yp + yd))/yb, so the dark variant's frame
        folds into π: formed once per capture, keyed like the int8 plan on
        the tensors ``data_yp`` and ``data_yd`` (compared with ``is``), not
        once per group."""
        dark = self._dark()
        if dark is None or not raw_kernel_applies(raw, self.cfg):
            return self.data_yp, dark
        dtype = getattr(torch, self.cfg.dtype)
        key = (self.data_yp, dark, dtype)
        if self._pi_fold_key is None or any(a is not b for a, b in zip(key, self._pi_fold_key)):
            self._pi_fold = self.data_yp.to(dtype) + dark.to(dtype)
            self._pi_fold_key = key
        return self._pi_fold, None

    def _active_ring(self) -> dict:
        return self._rings[0 if self.zeroisactive else 1]

    def _inactive_ring(self) -> dict:
        return self._rings[1 if self.zeroisactive else 0]

    def _toggle_rings(self) -> None:
        """Per completed group (BscanFFT.cpp:1482-1488): the other ring
        becomes active and is cleared."""
        self.zeroisactive = not self.zeroisactive
        for part in self._active_ring().values():
            part.clear()

    #: rank-1 fold residual above which the int8 display is no longer
    #: display-grade; above it the session refuses the plan and runs the
    #: exact chain (session.py:511-518 of the JAX package)
    INT8_RESID_ACT = 0.02

    def _use_int8_direct(self, raw: torch.Tensor) -> bool:
        """Whether this frame rides the int8-direct path: the frame →
        magnitudes map must be affine in exact 8-bit counts, and the
        background's rank-1 residual low enough.  J-lockin subtracts on the
        f32 chain, so it takes that."""
        if self.cfg.matmul_precision != "int8_direct" or self.method != "fused":
            return False
        if self.variant == "peak":
            # metrology: the vibrometry plugin inverts sub-dB peak-hold
            # differences, which the int8 display error would feed
            self._say_once("int8_direct", "int8_direct is a display mode; the peak/"
                           "vibrometry variant is metrology — staying on the f32 chain")
            return False
        if raw.dtype != torch.uint8 or raw.ndim != 2 or self.jlockin:
            return False
        if not int8_direct_supported(self.cfg)[0]:
            return False
        return self._int8_plan() is not None

    def _int8_plan(self) -> Int8DirectPlan | None:
        """The plan for the current calibration frames, rebuilt only when a
        capture rebinds ``data_yb``, ``data_yp`` or ``data_yd`` (the dark
        variant folds its dark frame into the plan).  The key holds strong
        references and compares with ``is``: an ``id()`` key could match a
        new tensor at a freed one's address.  A plan whose rank-1 residual
        is above :attr:`INT8_RESID_ACT` is refused (None), and the session
        says so."""
        key = (self.data_yb, self.data_yp, self.data_yd)
        if self._i8key is None or any(a is not b for a, b in zip(key, self._i8key)):
            plan = Int8DirectPlan.create(self.calib, self.cfg, self.data_yb, self.data_yp,
                                         self._dark(), device=self.device)
            resid = float(plan.bg_rank1_resid)
            if resid > self.INT8_RESID_ACT:
                plan = None
                self._say(f"int8_direct: background rank-1 residual {resid:.3f} is above "
                          f"{self.INT8_RESID_ACT} — not display-grade; falling back to the "
                          f"exact f32 chain (average more background frames)")
            self._i8plan = plan
            self._i8key = key
        return self._i8plan

    def process(self, raw) -> BscanResult | None:
        """One frame (H, W), or (H, W, 3) colour; returns the B-scan when
        the frame completes an averaging group."""
        cfg = self.cfg
        self._tick_fps(raw)
        raw = to_device(raw, self.device)
        if raw.ndim == 3:
            raw = channel_select(raw, cfg.channelnum)     # BscanFFTwebcam.cpp:1015-1039
        if cfg.saveinterferograms:
            raw = raw.clone()              # the ring keeps its own copy, not the caller's
        use_i8 = self._use_int8_direct(raw)
        # the int8 and group-kernel paths need no preprocessed frame; a
        # capture does
        y = preprocess(raw, cfg) if self._pending else None

        # the active ring fills during this group; the inactive one holds the
        # group before, for saves after the fact (BscanFFT.cpp:961-984)
        ring = self._active_ring()
        if cfg.saveinterferograms:
            ring["raw"].append(raw)
        self._handle_trig(raw)
        if self._pending:
            self._handle_captures(y)
        plan = self._int8_plan() if use_i8 else None     # a capture may refuse it
        if plan is not None:
            mags = reconstruct_int8_direct(shift_u8_to_s8(raw.contiguous()), plan)
        else:
            pi, dark = self._group_pi_dark(raw[None])
            mags = reconstruct_group(raw[None], self.data_yb, pi, self.calib, cfg,
                                     self.method, dark)

        if self.variant == "sim" and cfg.simcopyto:
            # strict simulator (BscanFFTsim.cpp:935-947): copyTo replaces the
            # accumulator and the group-completing frame is dropped
            if self.indextemp < self.averagestoggle:
                self.accum = mags
                if cfg.saveframes:
                    ring["bscan"].append(mags)
                self.indextemp += 1
                return None
            return self._finish_group()
        self.accum = self.accum + mags                    # BscanFFT.cpp:1193-1209
        if cfg.saveframes:
            ring["bscan"].append(mags)
        self.indextemp += 1
        if self.indextemp < self.averagestoggle:
            return None
        return self._finish_group()

    def _finish_group(self) -> BscanResult:
        """Group-complete block (BscanFFT.cpp:1211-1488)."""
        cfg = self.cfg
        self.indextemp = 0
        mag_sum = self.accum
        if cfg.bscanbinx > 1 or cfg.bscanbiny > 1:
            # spinjnt output rebinning acts on the linear B-scan; the factor
            # is derived (BscanFFTspinjnt.cpp:835)
            mult = cfg.bscanbinx * cfg.bscanbiny * cfg.binvaluex * cfg.binvaluey
            bscan_lin = bscan_rebin(mag_sum.T / self.averagestoggle, cfg.bscanbinx,
                                    cfg.bscanbiny, mult)
            mag_sum = bscan_lin.T * self.averagestoggle
        strict_sim = self.variant == "sim" and cfg.simcopyto
        out = form_bscan(mag_sum, cfg, 1 if strict_sim else self.averagestoggle,
                         bscanthreshold=self.bscanthreshold, eps=1e-6 if strict_sim else 1e-5)
        result = BscanResult(bscan=out.bscan, bscandb=out.bscandb,
                             bscandisp=out.bscandisp.cpu().numpy(), index=self.indexi)

        # J-lockin subtraction (BscanFFT.cpp:1225-1232, 1257-1282); the sim
        # variant masks instead (JMaskPlugin, BscanFFTsim.cpp:959-975)
        if self.jlockin and self.jscansave is not None and self.variant != "sim":
            sub_db, sub_disp = jlockin_batch(out.bscan[None], self.jscansave,
                                             self.bscanthreshold, cfg)
            result.sub_disp = sub_disp[0].cpu().numpy()
            if self.sink is not None:
                self._save_sub(to_host(sub_db[0]), result.sub_disp)

        # 'j' / 'c' at the group boundary (BscanFFT.cpp:1292-1304)
        if "j" in self._pending:
            self.jscansave = out.bscan
            self.jlockin = True
            self._pending.discard("j")
        if "c" in self._pending:
            self.jlockin = False
            self._pending.discard("c")
        if "s" in self._pending:
            self._save_group(result)
            self._pending.discard("s")
        for plugin in self.plugins:
            plugin.on_bscan(self, result)
        self.accum = torch.zeros_like(self.accum)
        self._toggle_rings()
        return result

    # ------------------------------------------------------------------
    # batched fast path: one kernel launch per averaging group
    # ------------------------------------------------------------------

    def _fast_path_blocker(self, n: int, avg: int) -> str | None:
        """Why this batch cannot ride the batched path, or None.  The rings
        and J-lockin ride it: their device work batches, and their
        bookkeeping runs per group on the host."""
        cfg = self.cfg
        if self.indextemp != 0:
            return "mid-group entry"
        if self._pending:
            return "pending key capture"
        if self._trig is not None:
            return "triggered batch capture in progress"
        if self.variant == "sim" and cfg.simcopyto:
            return "strict-sim copyTo accumulator"
        if cfg.manualaveraging:
            return "manual averaging"
        if cfg.bscanbinx > 1 or cfg.bscanbiny > 1:
            return "output B-scan rebinning"
        if avg < 1 or n % avg != 0:
            return f"batch of {n} not divisible by averages {avg}"
        return None

    def process_group(self, frames) -> list[BscanResult]:
        """``len(frames)`` reference loop iterations.  In the steady state
        each averaging group is one group-kernel launch (``averages``
        launches with ``saveframes``, whose ring keeps each frame's
        magnitudes) plus the display chain, and only the uint8 displays leave
        the device; on CUDA the batch is one replay of the step's captured
        graph (:meth:`_replay`).  Otherwise (a pending capture, a triggered
        capture, mid-group entry, manual averaging, output rebinning, a
        batch not divisible by the averaging count, strict-sim) it runs
        :meth:`process` frame by frame, and says why once.

        ``frames`` reach the device through :func:`~fdoct_tpu_torch.utils.
        to_device`.  A pinned host tensor is copied ``non_blocking``: the
        caller keeps it unchanged until the session next synchronises, as
        this call does at its display copy.  Host arrays may be overwritten
        as soon as it returns."""
        cfg = self.cfg
        n = len(frames)
        avg = self.averagestoggle
        why = self._fast_path_blocker(n, avg)
        if why is not None:
            self._say_once(f"slow:{why}", f"fast path disengaged ({why}) — per-frame dispatches"
                           + ("; mesh unused" if self.mesh is not None else ""))
            self._say_eager("per-frame")
            return [r for f in frames if (r := self.process(f)) is not None]

        self._tick_fps(frames[-1], n=n)
        host = frames if torch.is_tensor(frames) else np.asarray(frames)
        if self.mesh is not None and self._mesh_ok(host, avg):
            return self._process_group_mesh(host, n // avg, avg)
        key, state, step = self._group_step(tuple(host.shape), as_torch_dtype(host.dtype),
                                            n // avg, avg)
        if self.device.type == "cuda":
            farr, (outs, frame_mags) = self._replay(host, key, state, step)
        else:
            farr = to_device(host, self.device)
            outs, frame_mags = step(farr)
        raw = None
        if cfg.saveinterferograms:
            # the ring keeps its own copy, not the caller's nor the graph's input
            raw = (channel_select(farr, cfg.channelnum) if farr.ndim == 4 else farr).clone()
        return self._emit_group_results(outs, outs.bscandisp.cpu().numpy(), avg, raw,
                                        frame_mags)

    def _say_eager(self, route: str) -> None:
        """On CUDA, says once that ``route`` of :data:`graphs.EAGER_ROUTES`
        runs eagerly."""
        if self.device.type == "cuda":
            self._say_once(f"eager:{route}", f"CUDA graphs: the {EAGER_ROUTES[route]}")

    def _group_step(self, shape: tuple, dtype: torch.dtype, groups: int,
                    avg: int) -> tuple[tuple, tuple, Callable]:
        """(key, state, step) of a batch of frames of ``shape`` and ``dtype``:
        ``step(frames)`` → (stacked :class:`BscanOutputs`, per-frame
        magnitudes or None), :func:`session_group_pipeline_int8` or
        :func:`session_group_pipeline` on this session's state.  ``key`` is
        what the JAX programs' ``static_argnames`` and retracing key on (the
        route, the int8 display floor's value, which its kernel takes by
        value, and the frames' shape and type); ``state`` the tensors the step
        reads, to be compared with ``is``.  The f32 step reads the display
        floor from the device scalar ``_thresh``, written here."""
        cfg, method = self.cfg, self.method
        probe = torch.empty(shape, dtype=dtype, device="meta")       # the frames' route
        if probe.ndim == 4:
            probe = channel_select(probe, cfg.channelnum)
        static = (shape, dtype, groups, avg, cfg)

        def select(raw):
            return channel_select(raw, cfg.channelnum) if raw.ndim == 4 else raw

        if self._use_int8_direct(probe[0]):
            plan, thresh = self._int8_plan(), float(self.bscanthreshold)

            def step(raw):
                return session_group_pipeline_int8(select(raw), plan, thresh, cfg, groups, avg,
                                                   eps=1e-5, keep_frames=cfg.saveframes)
            return ("int8", thresh, *static), (plan,), step
        pi, dark = self._group_pi_dark(probe)
        yb, yd, calib, thresh = self.data_yb, self.data_yd, self.calib, self._thresh
        thresh.fill_(self.bscanthreshold)

        def step(raw):
            outs, mags, _ = session_group_pipeline(
                raw, yb, pi, yd, thresh, calib, cfg, groups, avg, method, dark is not None,
                eps=1e-5, keep_frames=cfg.saveframes)
            return outs, mags
        return ("f32", method, dark is not None, *static), (yb, pi, dark), step

    def _replay(self, host, key: tuple, state: tuple, step: Callable):
        """(the frames on the card, ``step``'s outputs) for the batch
        ``host``: the frames copied into the static input of ``key``'s
        captured graph and the graph replayed; at the first batch of a key,
        or after a capture rebinds a tensor of ``state``, the graph is
        captured (that call runs the step eagerly once)."""
        captured = self.graphs.lookup(key, state)
        if captured is not None:
            static = to_device(host, self.device, out=captured.inputs[0])
            return static, captured.replay()
        static = torch.empty(tuple(host.shape), dtype=as_torch_dtype(host.dtype),
                             device=self.device)
        to_device(host, self.device, out=static)
        return static, self.graphs.capture(key, state, step, (static,))

    # ------------------------------------------------------------------
    # the batched path on a device mesh
    # ------------------------------------------------------------------

    def _mesh_ok(self, farr, avg: int) -> bool:
        """Whether this batch can ride the sharded session steps: frames
        over 'data', rows over 'ascan', so the averaging count and the rows
        must divide the mesh axes and the median halo must fit one
        neighbour's rows; colour frames take the single-device path (their
        channel is selected there).  A session that falls back says why,
        once, and stays on its device (session.py:795-820 of the JAX
        package)."""
        cfg = self.cfg
        n_data, n_ascan = axis_size(self.mesh, "data"), axis_size(self.mesh, "ascan")
        why = None
        if farr.ndim != 3:
            why = "color frames need host-side channel handling"
        elif avg % n_data != 0:
            why = f"averages {avg} not divisible by mesh 'data' axis {n_data}"
        elif cfg.oph % n_ascan != 0:
            why = f"oph {cfg.oph} not divisible by mesh 'ascan' axis {n_ascan}"
        elif cfg.mediann > 1 and farr.shape[-2] // n_ascan < cfg.mediann // 2:
            why = (f"median halo needs >= {cfg.mediann // 2} raw rows per "
                   f"'ascan' shard, have {farr.shape[-2] // n_ascan}")
        if why is not None:
            self._say_once(f"mesh:{why}", f"mesh unused — single-device fast path ({why})")
            return False
        return True

    def _mesh_step(self, shape: tuple, dtype: torch.dtype, groups: int,
                   avg: int) -> tuple[tuple, tuple, Callable]:
        """(key, state, step) of a batch of frames of ``shape`` and ``dtype``
        on the mesh, as :meth:`_group_step` for one device: ``step(blocks)``
        → (stacked whole-B-scan :class:`BscanOutputs`, every frame's
        magnitudes or None) from the rank's (groups, b_loc, h_loc, W) blocks
        (:func:`~fdoct_tpu_torch.parallel.sharded.batch_block`),
        :func:`~fdoct_tpu_torch.parallel.sharded.session_mesh_pipeline_int8`
        or :func:`~fdoct_tpu_torch.parallel.sharded.session_mesh_pipeline`.
        Both end in the mesh's display tail, so both read the display floor
        from the device scalar ``_thresh``, written here, and the key holds
        no threshold.

        A captured mesh graph holds collectives, so every rank must capture
        and replay the same graphs in the same order, or they deadlock.  It
        does: the key and the state change only through the frames' shape,
        keys, config edits and captures, and every rank sees the same ones
        at the same batch (one process_group call on every rank for each
        batch; the command line broadcasts rank 0's keys and edits and
        frames, ``cli._from_lead``), so a rank captures, rebinds and evicts
        where every other rank does."""
        cfg, mesh, thresh = self.cfg, self.mesh, self._thresh
        thresh.fill_(self.bscanthreshold)
        layout = (axis_size(mesh, "data"), axis_size(mesh, "ascan"))
        static = (shape, dtype, groups, avg, cfg, layout)
        keep = cfg.saveframes

        def frames(blocks):                  # the steps' (groups·b_loc, h_loc, W) input
            return blocks.reshape(-1, *blocks.shape[2:])

        if self._use_int8_direct(torch.empty(shape[1:], dtype=dtype, device="meta")):
            plan = self._int8_plan()

            def step(blocks):
                return session_mesh_pipeline_int8(frames(blocks), plan, thresh, cfg, mesh, groups,
                                                  avg, keep_frames=keep)
            return ("mesh-int8", *static), (plan,), step
        yb, yp, yd, calib = self.data_yb, self.data_yp, self.data_yd, self.calib
        method, dark = self.method, self.variant == "dark"

        def step(blocks):
            return session_mesh_pipeline(frames(blocks), yb, yp, yd, thresh, calib, cfg, mesh,
                                         groups, avg, method, dark, keep_frames=keep)
        return ("mesh-f32", method, dark, *static), (yb, yp, yd), step

    def _process_group_mesh(self, host, groups: int, avg: int) -> list[BscanResult]:
        """The batch through the sharded session steps on this rank's
        blocks (:func:`~fdoct_tpu_torch.parallel.sharded.batch_block`: one
        strided copy into pinned memory, one H2D, only the blocks), each
        group's display gathered over 'ascan' in one all-gather and copied
        to the host at once (and with ``saveframes`` each frame's magnitudes
        over both axes), so that the per-group bookkeeping of
        :meth:`_emit_group_results` sees what the single-device path gives
        it.  On CUDA the batch is one replay of its captured graph, the
        collectives in it (:meth:`_replay`); on the CPU (gloo) the step runs
        eagerly.  The f32 step launches what the single-device group step
        launches on the block; the int8 step runs JAX's two s8 products (no
        fused int8 kernel: its display epilogue would precede the 'data'
        sum)."""
        cfg = self.cfg
        key, state, step = self._mesh_step(tuple(host.shape), as_torch_dtype(host.dtype),
                                           groups, avg)
        blocks = batch_block(host, self.mesh, groups)
        if self.device.type == "cuda":
            _, (outs, mags) = self._replay(blocks, key, state, step)
        else:
            outs, mags = step(to_device(blocks, self.device))
        raw = to_device(host, self.device).clone() if cfg.saveinterferograms else None
        return self._emit_group_results(outs, outs.bscandisp.cpu().numpy(), avg, raw, mags)

    def _emit_group_results(self, outs: BscanOutputs, disp: np.ndarray, avg: int,
                            raw: torch.Tensor | None, frame_mags) -> list[BscanResult]:
        """Per-group host bookkeeping of a batch's stacked outputs, state
        advancing exactly as that many per-frame group completions would:
        the ring fills (saveframes, saveinterferograms with the frames
        ``raw``; BscanFFT.cpp:961-984), the J-lockin subtraction and its
        saves (1257-1282), the plugins, the ring toggle (1482-1488).  Only
        the uint8 displays (and the subtracted ones) come to the host."""
        sub_db = sub_disp = None
        if self.jlockin and self.jscansave is not None and self.variant != "sim":
            sub_db, sub_disp = jlockin_batch(outs.bscan, self.jscansave, self.bscanthreshold,
                                             self.cfg)
            sub_disp = sub_disp.cpu().numpy()
            sub_db = to_host(sub_db) if self.sink is not None else None
        results = []
        for g in range(len(disp)):
            ring = self._active_ring()
            sl = slice(g * avg, (g + 1) * avg)
            if self.cfg.saveinterferograms:
                ring["raw"][:] = list(raw[sl])
            if frame_mags is not None:
                ring["bscan"][:] = list(frame_mags[sl])
            result = BscanResult(bscan=outs.bscan[g], bscandb=outs.bscandb[g], bscandisp=disp[g],
                                 index=self.indexi)
            if sub_disp is not None:
                result.sub_disp = sub_disp[g]
                if self.sink is not None:
                    self._save_sub(sub_db[g], result.sub_disp)
            for plugin in self.plugins:
                plugin.on_bscan(self, result)
            self._toggle_rings()
            results.append(result)
        return results

    # ------------------------------------------------------------------
    # captures
    # ------------------------------------------------------------------

    def _handle_captures(self, y: torch.Tensor) -> None:
        cfg = self.cfg
        if "b" in self._pending:
            if self.variant == "sim" and self.source is not None:
                # sim reads the dedicated background image (BscanFFTsim.cpp:806)
                bg = preprocess(to_device(self.source.background(), self.device), cfg)
                self.data_yb = bg.to(self.data_yb.dtype)
                self._pending.discard("b")
                self._say("S(k) saved.")
            else:
                self._capture_background(y)
        if "p" in self._pending:
            if self.variant == "sim" and self.source is not None:
                pi = preprocess(to_device(self.source.pi_frame(), self.device), cfg)
                self.data_yp = pi.to(self.data_yp.dtype)
            else:
                yp = y
                if cfg.rowwisenormalize:
                    yp = normalize_rows(yp, 0.0, 1.0)
                if not cfg.donotnormalize:
                    yp = normalize_minmax(yp, 0.0, 1.0)
                self.data_yp = yp
            self._pending.discard("p")
        for arm in ("dark", "ref", "sample"):
            if arm in self._pending:
                self._capture_arm(arm, y)

    def _set_background(self, acc: torch.Tensor) -> None:
        """S(k) from the sum of ``averagestoggle`` frames, normalized as the
        reference does (BscanFFT.cpp:1040-1073)."""
        cfg = self.cfg
        yb = acc
        if cfg.rowwisenormalize:
            yb = normalize_rows(yb, 0.0001, 1.0)
        if not cfg.donotnormalize:
            yb = normalize_minmax(yb, 0.0001, 1.0)
        else:
            yb = yb / self.averagestoggle
        self.data_yb = yb
        self._pending.discard("b")
        self._say("S(k) saved.")

    def _capture_background(self, y: torch.Tensor) -> None:
        """'b': average ``averagestoggle`` frames into S(k)
        (BscanFFT.cpp:1000-1075).  With saveinterferograms on, the reference
        averages the inactive ring's binned frames instead and saves its raw
        ones as rawframeb PNGs (BscanFFT.cpp:1003-1037); the binned frames
        are preprocess of the raw ring's, taken before any dark subtraction
        as the reference's per-frame loop stores them."""
        cfg = self.cfg
        if cfg.saveinterferograms:
            raws = self._inactive_ring()["raw"][:self.averagestoggle]
            if len(raws) >= self.averagestoggle:
                if self.sink is not None:
                    for ii, raw in enumerate(raws):
                        self.sink.save_image(f"rawframeb{self.indexi:03d}-{ii:03d}",
                                             to_host(raw))
                self._set_background(preprocess(torch.stack(raws), cfg).to(y.dtype).sum(0))
                if cfg.manualaveraging:
                    self.averagestoggle = 1
            return
        if self.baccumcount < self.averagestoggle:
            self.baccum = self.baccum + y
            self.baccumcount += 1
        if self.baccumcount >= self.averagestoggle:
            self._set_background(self.baccum)
            self.baccumcount = 0
            self.baccum = torch.zeros_like(self.baccum)
            if self.variant == "spinj" and self.sink is not None:
                # raw dump for the offline tool (BscanFFTspinjnt.cpp:1684)
                self.sink.save_bin("spectrum", to_host(self.data_yb))
            if cfg.manualaveraging:
                self.averagestoggle = 1                     # BscanFFT.cpp:1070-1073

    def _capture_arm(self, arm: str, y: torch.Tensor) -> None:
        """BscanDark 'o'/'r'/'t': each arm averaged over ``averagestoggle``
        frames, optionally low-passed, then the background composed as
        (data_yr − data_yd) + (data_ys − data_yd) with zeros guarded to 1
        (BscanDark.cpp:996, 1005-1221)."""
        acc = self._dark_accum.get(arm)
        self._dark_accum[arm] = y if acc is None else acc + y
        self._dark_counts[arm] += 1
        if self._dark_counts[arm] < self.averagestoggle:
            return
        avg = self._dark_accum.pop(arm) / self.averagestoggle
        if self.cfg.lowpassfilter:
            avg = lowpass_rowwise(avg)
        setattr(self, {"dark": "data_yd", "ref": "data_yr", "sample": "data_ys"}[arm], avg)
        self._pending.discard(arm)
        self._dark_counts[arm] = 0
        self._say(f"{arm} arm saved.")
        yb = (self.data_yr - self.data_yd) + (self.data_ys - self.data_yd)
        self.data_yb = torch.where(yb == 0, torch.ones_like(yb), yb)

    # ------------------------------------------------------------------
    # saves
    # ------------------------------------------------------------------

    def _save_sub(self, sub_db: np.ndarray, sub_disp: np.ndarray) -> None:
        """The J-lockin subtraction's bscansub saves (BscanFFT.cpp:1257-1282)."""
        self.manualindexi += 1
        mi = self.manualindexi
        self.sink.save_data(f"bscansub{mi:03d}", sub_db)
        self.sink.save_image(f"bscansub{mi:03d}", sub_disp)
        self.sink.save_colormapped(f"bscansubc{mi:03d}", sub_disp)

    def _save_group(self, result: BscanResult) -> None:
        """'s': the displayed B-scan and the per-frame and raw extras of the
        inactive ring (BscanFFT.cpp:1307-1397), and manual averaging
        (1399-1477).  Only what is written comes to the host."""
        cfg = self.cfg
        if self.sink is None:
            return
        self.indexi += 1
        i = self.indexi
        bscandb = to_host(result.bscandb)
        self.sink.save_data(f"bscan{i:03d}", bscandb)
        self.sink.save_image(f"bscan{i:03d}", result.bscandisp)
        self.sink.save_colormapped(f"bscanc{i:03d}", result.bscandisp)
        self._say(f"bscan{i:03d} saved.")
        result.index = i
        if self.variant == "spinj":
            # raw dumps for offline computing (BscanFFTspinjnt.cpp:1957-1971)
            self.sink.save_bin(f"bscandb{i:03d}", bscandb)
        if self.jlockin and self.jscansave is not None:
            jscan = to_host(self.jscansave)
            self.sink.save_data(f"jscan{i:03d}", jscan)
            if self.variant == "spinj":
                self.sink.save_bin(f"jscan{i:03d}", jscan)

        inactive = self._inactive_ring()
        if cfg.saveinterferograms:
            for ii, frame in enumerate(inactive["raw"]):
                self.sink.save_image(f"rawframe{i:03d}-{ii:03d}", to_host(frame))
        if cfg.saveframes:
            for ii, mags in enumerate(inactive["bscan"]):
                # per-frame B-scans: transpose, +eps, dB, normalize, uint8
                db = to_db(mags.T + 1e-6, eps=0.0, compat=cfg.compat)
                self.sink.save_image(f"bscan{i:03d}-{ii:03d}",
                                     to_host(to_uint8(normalize_minmax(db, 0.0, 1.0))))

        if cfg.manualaveraging:
            if self.manualaccumcount < cfg.manualaverages:
                self.manualaccum = self.manualaccum + result.bscan
                self.manualaccumcount += 1
            else:
                self.manualaccumcount = 0
                acc = self.manualaccum / cfg.manualaverages
                db = to_db(acc, eps=0.0, compat=cfg.compat)
                disp = normalize_minmax(threshold_floor(db, self.bscanthreshold), 0.0, 1.0)
                u8 = to_host(to_uint8(disp))
                result.manual_disp = u8
                self.manualindexi += 1
                mi = self.manualindexi
                self.sink.save_data(f"bscanman{mi:03d}", to_host(acc))
                self.sink.save_image(f"bscanman{mi:03d}", u8)
                self.sink.save_colormapped(f"bscanmanc{mi:03d}", u8)
                self.manualaccum = torch.zeros_like(self.manualaccum)

    def close(self) -> None:
        """Frees the captured graphs; the sink's parameter footer, then the
        sink's data file."""
        self.graphs.clear()
        if self.sink is not None:
            self.sink.parameter_footer(self.cfg, self.bscanthreshold)
            self.sink.close()


def jlockin_batch(bscan_stack: torch.Tensor, jscansave: torch.Tensor, threshold: float,
                  cfg) -> tuple[torch.Tensor, torch.Tensor]:
    """J-lockin subtraction of a stack of linear B-scans (BscanFFT.cpp:
    1257-1282), as ``_jlockin_batch`` of the JAX package: the dB of
    max(bscan − jscansave, 0) + 1e-3, floored and min-max normalized per
    B-scan.  Returns (sub_db, uint8 display), on the stack's device."""
    positive = make_only_positive(bscan_stack - jscansave[None]) + 0.001
    sub_db = to_db(positive, eps=0.0, compat=cfg.compat)
    disp = normalize_minmax(threshold_floor(sub_db, threshold), 0.0, 1.0, axis=(-2, -1))
    return sub_db, to_uint8(disp)


def _stack_outputs(outs: list[BscanOutputs]) -> BscanOutputs:
    """One BscanOutputs of (groups, ndisp, oph) stacks, as a ``lax.scan``
    stacks its per-group outputs."""
    return BscanOutputs(*(torch.stack(field) for field in zip(*outs)))


def session_group_pipeline(raw: torch.Tensor, yb: torch.Tensor, yp: torch.Tensor,
                           yd: torch.Tensor, threshold: torch.Tensor, calib: Calibration, cfg,
                           groups: int, averages: int, method: str, dark: bool, eps: float,
                           keep_frames: bool = False, keep_binned: bool = False):
    """``groups`` whole averaging groups of frames ``raw`` ((groups·averages,
    H, W), or (…, 3) colour frames, whose channel is selected first), the
    counterpart of ``_session_group_pipeline`` (session.py:1108-1156 of the
    JAX package), its ``lax.scan`` a loop over the groups: per group
    :func:`~fdoct_tpu_torch.pipeline.reconstruct_group` (one group-kernel
    launch; :func:`~fdoct_tpu_torch.pipeline.reconstruct_group_frames`, one
    per frame, with ``keep_frames``) on background ``yb``, π ``yp`` and,
    with ``dark``, the dark frame ``yd``, then
    :func:`~fdoct_tpu_torch.pipeline.form_bscan` at the display floor
    ``threshold``, a 0-d tensor on the frames' device.  No host
    synchronisation, so that a CUDA graph can capture it.

    Returns (stacked BscanOutputs, (groups·averages, oph, ndisp) per-frame
    magnitudes or None, (groups·averages, oph, opw) preprocessed frames
    (minus ``yd`` with ``dark``) or None)."""
    if raw.ndim == 4:
        raw = channel_select(raw, cfg.channelnum)
    dark_frame = yd if dark else None
    outs, mags, binned = [], [], []
    for g in range(groups):
        fr = raw[g * averages:(g + 1) * averages]
        if keep_frames:
            total, m = reconstruct_group_frames(fr, yb, yp, calib, cfg, method, dark_frame)
            mags.extend(m)
        else:
            total = reconstruct_group(fr, yb, yp, calib, cfg, method, dark_frame)
        outs.append(form_bscan(total, cfg, averages, bscanthreshold=threshold, eps=eps))
        if keep_binned:
            y = preprocess(fr, cfg)
            binned.append(y - yd.to(y.dtype) if dark else y)
    return (_stack_outputs(outs), torch.stack(mags) if keep_frames else None,
            torch.cat(binned) if keep_binned else None)


def session_group_pipeline_int8(raw_u8: torch.Tensor, plan: Int8DirectPlan, threshold: float,
                                cfg, groups: int, averages: int, eps: float,
                                keep_frames: bool = False):
    """The int8-direct counterpart, of ``_session_group_pipeline_int8``
    (session.py:1159-1184 of the JAX package): per group one launch of
    ``int8_bscan_display_fused`` and its tail
    (:func:`~fdoct_tpu_torch.int8direct.int8_bscan_outputs`);
    ``clampupper``, which that kernel does not take, runs the plain chain
    ``form_bscan(reconstruct_int8_direct(...).sum(0))``.  ``threshold`` is a
    number: the kernel takes it by value, so a captured graph holds it.  No
    host synchronisation.  Returns (stacked BscanOutputs, per-frame
    magnitudes or None)."""
    s8 = shift_u8_to_s8(raw_u8.contiguous())
    if cfg.clampupper:
        outs = [form_bscan(reconstruct_int8_direct(s8[g * averages:(g + 1) * averages],
                                                   plan).sum(dim=0),
                           cfg, averages, bscanthreshold=threshold, eps=eps)
                for g in range(groups)]
    else:
        outs = [int8_bscan_outputs(s8[g * averages:(g + 1) * averages], plan, threshold,
                                   averages, compat=cfg.compat, eps=eps)
                for g in range(groups)]
    return _stack_outputs(outs), reconstruct_int8_direct(s8, plan) if keep_frames else None
