"""Host time of an angiography volume's device→host copies (ms a volume):
the program's ``to_host.copy`` spans over its ``angio.volume`` spans, as the
program recorded them while the profiler ran."""


def read(layer: dict):
    tr = layer.get("trace") or {}
    if layer["kind"] != "angio" or not tr.get("units"):
        return None
    try:
        from fdoct_tpu_torch.utils.profiling import SPANS
    except ImportError:                  # a program without spans
        return None
    spans = SPANS.snapshot()["spans"]
    vol, copy = spans.get("angio.volume"), spans.get("to_host.copy")
    if not vol or not copy:
        return None
    return copy["total_s"] / vol["count"] * 1e3
