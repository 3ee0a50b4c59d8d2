"""The least time of one angiography volume, counted from shapes, by the rule
of :mod:`oct_bench.bounds`: the multiply-adds at the bf16 dense peak for
every precision, or the bytes read and written once at the HBM rate."""

from __future__ import annotations

from oct_bench.bounds import least_seconds


def volume_bound(cfg, frames: int, repeats: int, bands: int) -> tuple[float, str]:
    """One SSADA volume of ``frames`` position-major frames: F·rows·W·(1 +
    bands)·ndisp multiply-adds for each of re and im (the full band and each
    band); reading the frames and writing the float32 structure and
    decorrelation volumes, (F / repeats)·ndisp·rows each."""
    rows, w = cfg.height, cfg.width
    nd = min(cfg.numdisplaypoints, cfg.numfftpoints)
    nbytes = frames * rows * w * (1 if cfg.bpp <= 8 else 2) + 2 * (frames // repeats) * nd * rows * 4
    return least_seconds(2 * frames * rows * w * (1 + bands) * nd, nbytes)
