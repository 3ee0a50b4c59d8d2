"""The device memory an angiography volume's split-spectrum products take
(GB a volume, 1e9 bytes): the program's ``angio.product_bytes`` counter over
its ``angio.volume`` spans.  It is the intermediate that a product with the
magnitudes and the decorrelation in its epilogue would not write."""


def read(layer: dict):
    tr = layer.get("trace") or {}
    if layer["kind"] != "angio" or not tr.get("units"):
        return None
    try:
        from fdoct_tpu_torch.utils.profiling import SPANS
    except ImportError:                  # a program without spans
        return None
    snap = SPANS.snapshot()
    vol, nbytes = snap["spans"].get("angio.volume"), snap["counters"].get("angio.product_bytes")
    if not vol or not nbytes:
        return None
    return nbytes / vol["count"] / 1e9
