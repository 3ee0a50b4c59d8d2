"""The share of a C-scan volume's frames whose product and magnitudes one
of the program's hand-written kernels computed: its ``cscan.kernel_frames``
counter over its ``cscan.frames`` counter.  A program that counts no
kernel frames (none that has the kernels on this path) reads nothing."""


def read(layer: dict):
    tr = layer.get("trace") or {}
    if layer["kind"] != "cscan" or not tr.get("units"):
        return None
    try:
        from fdoct_tpu_torch.utils.profiling import SPANS
    except ImportError:                  # a program without spans
        return None
    counters = SPANS.snapshot()["counters"]
    frames, kernel = counters.get("cscan.frames"), counters.get("cscan.kernel_frames")
    if not frames or kernel is None:
        return None
    return kernel / frames
