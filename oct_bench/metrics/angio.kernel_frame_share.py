"""The share of an angiography volume's frames whose split-spectrum product
and magnitudes the program's hand-written kernel computed: its
``angio.kernel_frames`` counter over its ``angio.frames`` counter.  A
program that counts no kernel frames (none that has the kernel) reads
nothing."""


def read(layer: dict):
    tr = layer.get("trace") or {}
    if layer["kind"] != "angio" or not tr.get("units"):
        return None
    try:
        from fdoct_tpu_torch.utils.profiling import SPANS
    except ImportError:                  # a program without spans
        return None
    counters = SPANS.snapshot()["counters"]
    frames, kernel = counters.get("angio.frames"), counters.get("angio.kernel_frames")
    if not frames or kernel is None:
        return None
    return kernel / frames
