"""The rate of an angiography volume's device→host copies as the host sees
it (GB/s): the program's ``to_host.bytes`` counter over the seconds of its
``to_host.copy`` spans."""


def read(layer: dict):
    tr = layer.get("trace") or {}
    if layer["kind"] != "angio" or not tr.get("units"):
        return None
    try:
        from fdoct_tpu_torch.utils.profiling import SPANS
    except ImportError:                  # a program without spans
        return None
    snap = SPANS.snapshot()
    copy, n = snap["spans"].get("to_host.copy"), snap["counters"].get("to_host.bytes")
    if not snap["spans"].get("angio.volume") or not copy or not n:
        return None
    return n / copy["total_s"] / 1e9
