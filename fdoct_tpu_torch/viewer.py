"""Display layer: the reference's HighGUI windows, headless-capable.

The port of ``fdoct_tpu/viewer.py``.  The reference renders six OpenCV
windows — "show" (binned frame), "Bscan" (JET colormap + A-scan marker),
"Status" (600×300 image with putText rows), "ROI intensity" (scrolling strip
chart), "Bscanm" (manual average), "Vibration profile"
(BscanFFT.cpp:486-538, 593-597, 1284-1288; BscanFFTpeak.cpp:417-461).  This
viewer renders the same surfaces as numpy images on the host and writes
them to files (headless / CI), shows them with matplotlib (interactive),
serves them over HTTP (:mod:`fdoct_tpu_torch.viewer_server`) or hands them
to a callback.  The Status rows are drawn with the port's bitmap font
(:mod:`fdoct_tpu_torch.utils.font`), not PIL's.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

from fdoct_tpu_torch.utils import to_host
from fdoct_tpu_torch.utils.colormap import apply_jet
from fdoct_tpu_torch.utils.font import draw_text


def render_status(lines: list[str], size: tuple[int, int] = (600, 300)) -> np.ndarray:
    """The Status window, (height, width) = (size[1], size[0]) uint8: up to 6
    rows of white text on black, 50 px apart (reference: statusimg putText
    rows at y = 30, 80, 130, ...)."""
    img = np.zeros((size[1], size[0]), np.uint8)
    for i, text in enumerate(lines[:6]):
        draw_text(img, (4, 15 + 50 * i), text, fill=255)
    return img


def render_bscan(bscandisp_u8: np.ndarray, ascanat: int | None = None,
                 roi: dict | None = None) -> np.ndarray:
    """The Bscan window: JET colormap plus the '^' A-scan marker at the
    bottom (reference: BscanFFT.cpp:1284-1288) and, when a vibrometry ROI
    is selected, its white rectangle outline (the reference draws the
    selected ROI on the displayed B-scan, BscanFFTpeak.cpp:1568-1573)."""
    rgb = apply_jet(bscandisp_u8).copy()
    if ascanat is not None and 0 <= ascanat < rgb.shape[1]:
        h = rgb.shape[0]
        lo = max(0, h - 12)
        rgb[lo:, max(0, ascanat - 1): ascanat + 2] = 255
    if roi is not None and roi.get("w", 0) > 0 and roi.get("h", 0) > 0:
        H, W = rgb.shape[:2]
        x0, y0 = max(0, roi["x"]), max(0, roi["y"])
        x1, y1 = min(W - 1, roi["x"] + roi["w"]), min(H - 1, roi["y"] + roi["h"])
        if x1 > x0 and y1 > y0:
            rgb[y0, x0:x1 + 1] = 255
            rgb[y1, x0:x1 + 1] = 255
            rgb[y0:y1 + 1, x0] = 255
            rgb[y0:y1 + 1, x1] = 255
    return rgb


def render_strip_chart(plot01: np.ndarray) -> np.ndarray:
    """The ROI-intensity window: the ROIPlugin's 0/1 plot as uint8."""
    return (np.asarray(plot01) * 255).astype(np.uint8)


class Viewer:
    """mode='files' writes PNGs into a directory per update; mode='mpl'
    shows live matplotlib windows; mode='http' serves them from a
    :class:`~fdoct_tpu_torch.viewer_server.ViewerServer` on ``port``;
    mode='callback' forwards them to ``callback(name, img)``."""

    WINDOWS = ("show", "bscan", "bscan_sub", "bscan_manual", "status",
               "roi_intensity", "vibration_profile")
    MODES = ("files", "mpl", "http", "callback")

    def __init__(self, mode: str = "files", outdir: str | Path = "viewer",
                 callback=None, port: int = 8089):
        if mode not in self.MODES:
            raise ValueError(f"unknown viewer mode {mode!r}; have {self.MODES}")
        self.mode = mode
        self.callback = callback
        self.outdir = Path(outdir)
        self._fig = None
        self.server = None
        if mode == "files":
            self.outdir.mkdir(parents=True, exist_ok=True)
        elif mode == "mpl":
            try:
                import matplotlib.pyplot as plt
            except ImportError as e:
                raise ImportError("Viewer(mode='mpl') needs matplotlib, which does not "
                                  "import here; use mode 'files' or 'http'") from e
            self._plt = plt
        elif mode == "http":
            from fdoct_tpu_torch.viewer_server import ViewerServer
            self.server = ViewerServer(port=port)

    def _update_mpl(self, name: str, img: np.ndarray) -> None:
        plt = self._plt
        if self._fig is None:
            self._fig, axs = plt.subplots(2, 3, figsize=(12, 6))
            self._fig.canvas.manager.set_window_title("fdoct")
            for ax in axs.ravel():
                ax.axis("off")
            self._ax_list = list(axs.ravel())
            self._ax_map = {}
        if name not in self._ax_map and self._ax_list:
            ax = self._ax_list.pop(0)
            ax.set_title(name)
            self._ax_map[name] = (ax, None)
        if name in self._ax_map:
            ax, im = self._ax_map[name]
            if im is None:
                im = ax.imshow(img, aspect="auto",
                               cmap=None if img.ndim == 3 else "gray")
                self._ax_map[name] = (ax, im)
            else:
                im.set_data(img)
        plt.pause(0.001)

    def update(self, name: str, img) -> None:
        """Publish ``img`` (a numpy array, or a tensor on any device, moved to
        the host once here) as window ``name``."""
        if name not in self.WINDOWS:
            raise ValueError(f"unknown window {name!r}")
        img = to_host(img)
        if self.mode == "files":
            from fdoct_tpu_torch.utils.imageio import write_png
            write_png(self.outdir / f"{name}.png", img)
        elif self.mode == "mpl":
            self._update_mpl(name, img)
        elif self.mode == "http":
            self.server.update(name, img)
        elif self.callback is not None:
            self.callback(name, img)

    def pop_keys(self) -> str:
        """Remote key presses (http mode); empty elsewhere."""
        return self.server.pop_keys() if self.server is not None else ""

    def pop_rois(self) -> list[dict]:
        """Remote drag-rect ROI selections (http mode); empty elsewhere."""
        return self.server.pop_rois() if self.server is not None else []

    def pop_config(self) -> list[dict]:
        """Remote config edits (http mode); empty elsewhere."""
        return self.server.pop_config() if self.server is not None else []

    def set_config_provider(self, fn) -> None:
        """Expose current session knobs on GET /config (http mode)."""
        if self.server is not None:
            self.server.config_provider = fn

    def close(self) -> None:
        if self.server is not None:
            self.server.close()

    # ------------------------------------------------------------------
    def show_session_frame(self, session, raw_binned, result=None) -> None:
        """Render one loop iteration: the live frame always, the B-scan
        windows whenever a group completed (``result``, a
        :class:`~fdoct_tpu_torch.session.BscanResult`, whose displays are
        host uint8 arrays)."""
        self.update("show", raw_binned)
        self.update("status", render_status(session.status[-6:]))
        if result is None:
            return
        roi = next((p.roi for p in session.plugins
                    if getattr(p, "roi_selected", False)), None)
        self.update("bscan", render_bscan(result.bscandisp, session.ascanat, roi=roi))
        if result.sub_disp is not None:
            self.update("bscan_sub", apply_jet(result.sub_disp))
        if result.manual_disp is not None:
            self.update("bscan_manual", apply_jet(result.manual_disp))
        for plugin in session.plugins:
            plot = getattr(plugin, "plot", None)
            if plot is not None:
                self.update("roi_intensity", render_strip_chart(plot))
            profile = getattr(plugin, "profile", None)
            if profile is not None and getattr(plugin, "display_profile", False):
                from fdoct_tpu_torch.plugins.vibrometry import render_vib_profile
                self.update("vibration_profile", render_vib_profile(profile))
