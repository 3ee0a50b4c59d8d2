"""The share of a C-scan volume's device→host bytes whose pinned host
destination the caching allocator already held: the program's
``to_host.reused_bytes`` counter over its ``to_host.bytes``."""


def read(layer: dict):
    tr = layer.get("trace") or {}
    if layer["kind"] != "cscan" or not tr.get("units"):
        return None
    try:
        from fdoct_tpu_torch.utils.profiling import SPANS
    except ImportError:                  # a program without spans
        return None
    snap = SPANS.snapshot()
    counters = snap["counters"]
    n, reused = counters.get("to_host.bytes"), counters.get("to_host.reused_bytes")
    if not snap["spans"].get("cscan.volume") or not n or reused is None:
        return None
    return reused / n
