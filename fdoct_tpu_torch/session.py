"""Interactive session: the reference's keystroke state machine, on tensors.

The port of ``fdoct_tpu/session.py`` for the live main path: background 'b'
and π 'p' captures (BscanFFT.cpp:1000-1099), the threshold and averaging
keys, per-frame :meth:`Session.process` (one reference loop iteration) and
the batched :meth:`Session.process_group`, whose steady state runs one
:func:`fdoct_tpu_torch.pipeline.reconstruct_group` kernel launch and one
display chain per averaging group.  With ``matmul_precision='int8_direct'``
and a config the folding supports, the session folds its captures into an
:class:`~fdoct_tpu_torch.int8direct.Int8DirectPlan` and each group is one
launch of the int8 B-scan kernel plus a small tail.

Device state (the reference's Mats) is tensors on ``device``; control state
is plain fields.  Variants 'base' and 'sim'.  Saves, ring buffers, J-lockin,
manual averaging, output rebinning, plugins, the other variants and meshes
are not ported yet and raise ``NotImplementedError``.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

from fdoct_tpu_torch.calibration import Calibration
from fdoct_tpu_torch.int8direct import (
    Int8DirectPlan, int8_bscan_outputs, int8_direct_supported, reconstruct_int8_direct,
    shift_u8_to_s8,
)
from fdoct_tpu_torch.ops import channel_select, normalize_minmax, normalize_rows
from fdoct_tpu_torch.pipeline import form_bscan, preprocess, reconstruct_group
from fdoct_tpu_torch.utils.profiling import FpsMeter


def _not_ported(what: str, item: str = "ROADMAP Queue 1 item 8") -> NotImplementedError:
    return NotImplementedError(f"{what} is not ported to fdoct_tpu_torch yet ({item})")


@dataclasses.dataclass
class BscanResult:
    """One completed averaging group.  ``bscandisp`` is a host uint8 array;
    ``bscan`` and ``bscandb`` stay on the session's device."""
    bscan: torch.Tensor       # linear, (ndisp, oph)
    bscandb: torch.Tensor     # dB with DC rows masked
    bscandisp: np.ndarray     # uint8 display
    index: int                # save counter at completion


class Session:
    """One live or replay reconstruction session on one device.

    cfg: pipeline configuration.  device: where the tensors live, e.g.
    ``"cuda"`` or ``"cpu"``.  variant: 'base' or 'sim'.  source: with the
    'sim' variant, the source whose ``background()``/``pi_frame()`` the 'b'
    and 'p' captures read (BscanFFTsim.cpp:806-825).  method: the
    reconstruction of :func:`fdoct_tpu_torch.pipeline.ascan_mags` ('fused',
    'fused_exact', or 'gather'/'hilbert', which launch no kernel).
    """

    def __init__(self, cfg, device: torch.device | str, variant: str = "base",
                 source: Any = None, method: str = "fused",
                 calib: Calibration | None = None, mesh: Any = None):
        if variant not in ("base", "sim"):
            raise _not_ported(f"variant {variant!r}")
        if mesh is not None:
            raise _not_ported("a device mesh", "ROADMAP Queue 1 item 12")
        for flag in ("saveframes", "saveinterferograms", "manualaveraging"):
            if getattr(cfg, flag):
                raise _not_ported(flag)
        if cfg.bscanbinx > 1 or cfg.bscanbiny > 1:
            raise _not_ported("bscanbinx/bscanbiny > 1")
        self.cfg = cfg
        self.device = torch.device(device)
        self.variant = variant
        self.source = source
        self.method = method
        self.calib = calib or Calibration.create(cfg, self.device)
        dt = getattr(torch, cfg.dtype)
        oph, opw, ndisp = cfg.oph, cfg.opw, self.calib.ndisp

        # device state (the reference's Mats)
        self.data_yb = torch.ones((oph, opw), dtype=dt, device=self.device)   # S(k)
        self.data_yp = torch.zeros((oph, opw), dtype=dt, device=self.device)  # π / J0
        self.accum = torch.zeros((oph, ndisp), dtype=dt, device=self.device)
        self.baccum = torch.zeros((oph, opw), dtype=dt, device=self.device)

        # control state (the reference's flags and counters)
        self.averages = cfg.averages
        self.averagestoggle = cfg.averages                  # BscanFFT.cpp:481
        # the simulator display has no threshold floor (BscanFFTsim.cpp:1131)
        self.bscanthreshold = -np.inf if variant == "sim" else cfg.bscanthreshold
        self.indextemp = 0
        self.indexi = 0
        self.baccumcount = 0
        self.zeroisactive = True                            # ring toggle
        self._pending: set[str] = set()
        self._said_once: set[str] = set()
        self.status: list[str] = []
        self.fpsmeter = FpsMeter(window_s=5.0)              # BscanFFT.cpp:1100-1119
        self.fps = 0.0
        self.max_intensity = 0
        self._i8plan: Int8DirectPlan | None = None
        self._i8key: tuple | None = None
        # (shape, dtype) of host frames → (pinned staging buffer, event of
        # its last copy to the card); CUDA sessions only
        self._staging: dict[tuple, tuple[torch.Tensor, torch.cuda.Event]] = {}

    # ------------------------------------------------------------------
    # keys (BscanFFT.cpp:1584-1917)
    # ------------------------------------------------------------------

    def key(self, ch: str) -> None:
        """Apply one keypress: 'b'/'p' capture, ']'/'[' threshold ±1 dB,
        'a' toggles averaging.  Any other key raises NotImplementedError."""
        if ch in ("b", "B"):
            self._pending.add("b")
        elif ch in ("p", "P"):
            self._pending.add("p")
        elif ch == "]":
            self.bscanthreshold += 1.0
            self._say(f"bscanthreshold = {self.bscanthreshold:f}")
        elif ch == "[":
            self.bscanthreshold -= 1.0
            self._say(f"bscanthreshold = {self.bscanthreshold:f}")
        elif ch in ("a", "A"):
            self.averagestoggle = self.averages if self.averagestoggle == 1 else 1
            self._say(f"Now averaging {self.averagestoggle} bscans.")
        else:
            raise _not_ported(f"key {ch!r}")

    def _say(self, text: str) -> None:
        self.status.append(text)
        if len(self.status) > 100:
            del self.status[:50]

    def _say_once(self, key: str, text: str) -> None:
        if key not in self._said_once:
            self._said_once.add(key)
            self._say(text)

    # ------------------------------------------------------------------
    # per-frame processing (one reference hot-loop iteration)
    # ------------------------------------------------------------------

    def _tick_fps(self, raw, n: int = 1) -> None:
        """fps and frame max-intensity Status rows, once per 5 s window."""
        reading = self.fpsmeter.tick(n)
        if reading is not None:
            self.fps = reading
            self.max_intensity = int(raw.max())
            self._say(f"fps = {reading:.0f}  Max Intensity = {self.max_intensity}")

    def _to_device(self, frames) -> torch.Tensor:
        """Frames on the session's device.  A tensor there is used as it is;
        a pinned host tensor (the caller keeps it unchanged until the session
        next synchronises, as ``process_group`` does at its display copy) is
        copied with ``non_blocking``; host frames bound for CUDA go through a
        page-locked staging buffer kept per shape and dtype."""
        if torch.is_tensor(frames):
            return frames.to(self.device, non_blocking=frames.is_pinned())
        host = np.asarray(frames)
        if self.device.type != "cuda":
            return torch.as_tensor(host).to(self.device)
        key = (host.shape, host.dtype)
        if key not in self._staging:
            self._staging[key] = (torch.from_numpy(np.empty(host.shape, host.dtype)).pin_memory(),
                                  torch.cuda.Event())
        pinned, copied = self._staging[key]
        copied.synchronize()                 # its previous copy has landed
        np.copyto(pinned.numpy(), host)
        dev = pinned.to(self.device, non_blocking=True)
        copied.record(torch.cuda.current_stream(self.device))
        return dev

    # ------------------------------------------------------------------
    # int8-direct display mode (fdoct_tpu_torch.int8direct)
    # ------------------------------------------------------------------

    #: rank-1 fold residual above which the int8 display is no longer
    #: display-grade; above it the session refuses the plan and runs the
    #: exact chain (session.py:511-518 of the JAX package)
    INT8_RESID_ACT = 0.02

    def _use_int8_direct(self, raw: torch.Tensor) -> bool:
        """Whether this frame rides the int8-direct path: the frame →
        magnitudes map must be affine in exact 8-bit counts, and the
        background's rank-1 residual low enough."""
        if self.cfg.matmul_precision != "int8_direct" or self.method != "fused":
            return False
        if self.variant == "peak":
            # metrology: the vibrometry plugin inverts sub-dB peak-hold
            # differences, which the int8 display error would feed
            self._say_once("int8_direct", "int8_direct is a display mode; the peak/"
                           "vibrometry variant is metrology — staying on the f32 chain")
            return False
        if raw.dtype != torch.uint8 or raw.ndim != 2:
            return False
        if not int8_direct_supported(self.cfg)[0]:
            return False
        return self._int8_plan() is not None

    def _int8_plan(self) -> Int8DirectPlan | None:
        """The plan for the current calibration frames, rebuilt only when a
        capture rebinds ``data_yb`` or ``data_yp``.  The key holds strong
        references and compares with ``is``: an ``id()`` key could match a
        new tensor at a freed one's address.  A plan whose rank-1 residual
        is above :attr:`INT8_RESID_ACT` is refused (None), and the session
        says so."""
        key = (self.data_yb, self.data_yp)
        if self._i8key is None or any(a is not b for a, b in zip(key, self._i8key)):
            plan = Int8DirectPlan.create(self.calib, self.cfg, self.data_yb, self.data_yp,
                                         device=self.device)
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
        raw = self._to_device(raw)
        if raw.ndim == 3:
            raw = channel_select(raw, cfg.channelnum)     # BscanFFTwebcam.cpp:1015-1039
        use_i8 = self._use_int8_direct(raw)
        if self._pending:
            # the int8 path needs no preprocessed frame, only a capture does
            self._handle_captures(preprocess(raw, cfg))
        plan = self._int8_plan() if use_i8 else None     # a capture may refuse it
        if plan is not None:
            mags = reconstruct_int8_direct(shift_u8_to_s8(raw.contiguous()), plan)
        else:
            mags = reconstruct_group(raw[None], self.data_yb, self.data_yp,
                                     self.calib, cfg, self.method)

        if self.variant == "sim" and cfg.simcopyto:
            # strict simulator (BscanFFTsim.cpp:935-947): copyTo replaces the
            # accumulator and the group-completing frame is dropped
            if self.indextemp < self.averagestoggle:
                self.accum = mags
                self.indextemp += 1
                return None
            return self._finish_group()
        self.accum = self.accum + mags                    # BscanFFT.cpp:1193-1209
        self.indextemp += 1
        if self.indextemp < self.averagestoggle:
            return None
        return self._finish_group()

    def _finish_group(self) -> BscanResult:
        """Group-complete block (BscanFFT.cpp:1211-1255, 1482-1488)."""
        self.indextemp = 0
        strict_sim = self.variant == "sim" and self.cfg.simcopyto
        out = form_bscan(self.accum, self.cfg, 1 if strict_sim else self.averagestoggle,
                         bscanthreshold=self.bscanthreshold,
                         eps=1e-6 if strict_sim else 1e-5)
        result = BscanResult(bscan=out.bscan, bscandb=out.bscandb,
                             bscandisp=out.bscandisp.cpu().numpy(), index=self.indexi)
        self.accum = torch.zeros_like(self.accum)
        self.zeroisactive = not self.zeroisactive
        return result

    # ------------------------------------------------------------------
    # batched fast path: one kernel launch per averaging group
    # ------------------------------------------------------------------

    def _fast_path_blocker(self, n: int, avg: int) -> str | None:
        """Why this batch cannot ride the batched path, or None."""
        if self.indextemp != 0:
            return "mid-group entry"
        if self._pending:
            return "pending key capture"
        if self.variant == "sim" and self.cfg.simcopyto:
            return "strict-sim copyTo accumulator"
        if avg < 1 or n % avg != 0:
            return f"batch of {n} not divisible by averages {avg}"
        return None

    def process_group(self, frames) -> list[BscanResult]:
        """``len(frames)`` reference loop iterations.  In the steady state
        each averaging group is one group-kernel launch plus the display
        chain, and only the uint8 displays leave the device; otherwise (a
        pending capture, mid-group entry, a batch not divisible by the
        averaging count, strict-sim) it falls back to :meth:`process` frame
        by frame, and says why once."""
        n = len(frames)
        avg = self.averagestoggle
        why = self._fast_path_blocker(n, avg)
        if why is not None:
            self._say_once(f"slow:{why}",
                           f"fast path disengaged ({why}) — per-frame dispatches")
            return [r for f in frames if (r := self.process(f)) is not None]

        self._tick_fps(frames[-1], n=n)
        farr = self._to_device(frames)
        if farr.ndim == 4:
            # a single-plane select keeps exact uint8 counts, so colour
            # frames ride int8-direct too; a channel sum is float
            farr = channel_select(farr, self.cfg.channelnum)
        groups = n // avg
        if self._use_int8_direct(farr[0]):
            outs = self._int8_groups(shift_u8_to_s8(farr.contiguous()), groups, avg)
        else:
            outs = [form_bscan(reconstruct_group(farr[g * avg:(g + 1) * avg], self.data_yb,
                                                 self.data_yp, self.calib, self.cfg,
                                                 self.method),
                               self.cfg, avg, bscanthreshold=self.bscanthreshold, eps=1e-5)
                    for g in range(groups)]
        disp = torch.stack([o.bscandisp for o in outs]).cpu().numpy()
        return self._emit_group_results(outs, disp)

    def _int8_groups(self, s8: torch.Tensor, groups: int, avg: int) -> list:
        """The int8-direct group step: one ``int8_bscan_display_fused``
        launch per group plus its tail.  ``clampupper``, which the fused
        kernel does not take, runs the plain chain,
        ``form_bscan(reconstruct_int8_direct(...).sum(0))``."""
        plan = self._int8_plan()
        if not self.cfg.clampupper:
            return [int8_bscan_outputs(s8[g * avg:(g + 1) * avg], plan, self.bscanthreshold,
                                       avg, compat=self.cfg.compat, eps=1e-5)
                    for g in range(groups)]
        return [form_bscan(reconstruct_int8_direct(s8[g * avg:(g + 1) * avg], plan).sum(dim=0),
                           self.cfg, avg, bscanthreshold=self.bscanthreshold, eps=1e-5)
                for g in range(groups)]

    def _emit_group_results(self, outs, disp: np.ndarray) -> list[BscanResult]:
        """Per-group host bookkeeping: state advances exactly as that many
        per-frame group completions would."""
        results = []
        for g, out in enumerate(outs):
            results.append(BscanResult(bscan=out.bscan, bscandb=out.bscandb,
                                       bscandisp=disp[g], index=self.indexi))
            self.zeroisactive = not self.zeroisactive   # BscanFFT.cpp:1487
        return results

    # ------------------------------------------------------------------
    # captures
    # ------------------------------------------------------------------

    def _handle_captures(self, y: torch.Tensor) -> None:
        cfg = self.cfg
        if "b" in self._pending:
            if self.variant == "sim" and self.source is not None:
                # sim reads the dedicated background image (BscanFFTsim.cpp:806)
                bg = preprocess(self._to_device(self.source.background()), cfg)
                self.data_yb = bg.to(self.data_yb.dtype)
                self._pending.discard("b")
                self._say("S(k) saved.")
            else:
                self._capture_background(y)
        if "p" in self._pending:
            if self.variant == "sim" and self.source is not None:
                pi = preprocess(self._to_device(self.source.pi_frame()), cfg)
                self.data_yp = pi.to(self.data_yp.dtype)
            else:
                yp = y
                if cfg.rowwisenormalize:
                    yp = normalize_rows(yp, 0.0, 1.0)
                if not cfg.donotnormalize:
                    yp = normalize_minmax(yp, 0.0, 1.0)
                self.data_yp = yp
            self._pending.discard("p")

    def _capture_background(self, y: torch.Tensor) -> None:
        """'b': average ``averagestoggle`` frames into S(k)
        (BscanFFT.cpp:1000-1075)."""
        cfg = self.cfg
        if self.baccumcount < self.averagestoggle:
            self.baccum = self.baccum + y
            self.baccumcount += 1
        if self.baccumcount >= self.averagestoggle:
            yb = self.baccum
            if cfg.rowwisenormalize:
                yb = normalize_rows(yb, 0.0001, 1.0)
            if not cfg.donotnormalize:
                yb = normalize_minmax(yb, 0.0001, 1.0)
            else:
                yb = yb / self.averagestoggle
            self.data_yb = yb
            self._pending.discard("b")
            self.baccumcount = 0
            self.baccum = torch.zeros_like(self.baccum)
            self._say("S(k) saved.")
