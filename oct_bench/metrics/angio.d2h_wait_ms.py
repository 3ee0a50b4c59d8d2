"""Time the host waits, at an angiography volume's device→host copies, for
the device work queued before them (ms a volume): the program's
``to_host.wait`` spans over its ``angio.volume`` spans."""


def read(layer: dict):
    tr = layer.get("trace") or {}
    if layer["kind"] != "angio" or not tr.get("units"):
        return None
    try:
        from fdoct_tpu_torch.utils.profiling import SPANS
    except ImportError:                  # a program without spans
        return None
    spans = SPANS.snapshot()["spans"]
    vol, wait = spans.get("angio.volume"), spans.get("to_host.wait")
    if not vol or not wait:
        return None
    return wait["total_s"] / vol["count"] * 1e3
