"""Device time of an angiography volume's copies (ms a volume): the
``Memcpy HtoD`` and ``Memcpy DtoH`` intervals of the traced volumes."""


def read(layer: dict):
    tr = layer.get("trace") or {}
    if layer["kind"] != "angio" or not tr.get("units"):
        return None
    return (tr["h2d_us"] + tr["d2h_us"]) / tr["units"] / 1e3
