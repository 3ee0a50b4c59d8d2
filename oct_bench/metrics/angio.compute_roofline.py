"""The angiography volume's share of its roofline (%): the least time of the
card for one volume's work (``oct_bench.angio_bounds.volume_bound``) over
the device time of every kernel a traced volume ran (the volume and its
views), copies excluded."""


def read(layer: dict):
    tr = layer.get("trace") or {}
    if layer["kind"] != "angio" or not tr.get("units") or not tr.get("kernel_us"):
        return None
    return layer["bound_s"] * 1e6 / (tr["kernel_us"] / tr["units"]) * 100.0
