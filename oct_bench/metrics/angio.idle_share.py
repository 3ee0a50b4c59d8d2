"""The device's idle share of the traced angiography volumes: 1 − the union
of the kernel and copy intervals / the traced window."""


def read(layer: dict):
    tr = layer.get("trace") or {}
    if layer["kind"] != "angio" or not tr.get("units"):
        return None
    return 1.0 - tr["busy_us"] / tr["window_us"]
