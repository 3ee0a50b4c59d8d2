"""The port's copies of the JAX package's host modules for saves and replay:
``utils/{colormap,ocv_io,cvxml,imageio}.py``, ``sinks/run_writer.py`` and
``sources/replay.py``, each against its original on the same seeded numpy
inputs.

Tolerance: none.  The colormap, ``.ocv``, ``.xml``, ``.m`` and ``.npz``
files and the run directory's name are byte-equal.  PNGs are compared by
decoded pixels, exactly, both ways (PIL, through the JAX package's reader,
reads the port's files; the port's codec reads PIL's), because the two
encoders compress differently.  The port's codec must also reject what it
does not read (palette, grey+alpha, sub-byte depths, Adam7) naming the file.
"""

import struct
import zlib

import numpy as np
import pytest

pytest.importorskip("jax")                  # the JAX package imports it; skip without it
PIL_Image = pytest.importorskip("PIL.Image")

from fdoct_tpu.config import PipelineConfig as JaxConfig
from fdoct_tpu.sinks import RunWriter as JaxRunWriter
from fdoct_tpu.sinks import matlab_matrix as jax_matlab_matrix
from fdoct_tpu.sources.replay import DirectorySource as JaxDirectorySource
from fdoct_tpu.sources.replay import ReplaySource as JaxReplaySource
from fdoct_tpu.utils import colormap as jcolormap
from fdoct_tpu.utils import cvxml as jcvxml
from fdoct_tpu.utils import imageio as jimageio
from fdoct_tpu.utils import ocv_io as jocv
from fdoct_tpu_torch.config import PipelineConfig
from fdoct_tpu_torch.sinks import RunWriter, matlab_matrix
from fdoct_tpu_torch.sources import DirectorySource, ReplaySource
from fdoct_tpu_torch.utils import colormap, cvxml, imageio, ocv_io

RNG_SEED = 11
KINDS = {"u8": ((23, 41), np.uint8), "u16": ((23, 41), np.uint16),
         "rgb": ((23, 41, 3), np.uint8)}


def image(kind, seed=RNG_SEED):
    shape, dtype = KINDS[kind]
    return np.random.default_rng(seed).integers(0, np.iinfo(dtype).max + 1, shape, dtype=dtype)


def png_chunks(blob):
    pos, out = 8, []
    while pos < len(blob):
        length, kind = struct.unpack(">I4s", blob[pos:pos + 8])
        out.append((kind, blob[pos + 8:pos + 8 + length]))
        pos += 12 + length
    return out


def filter_rows(rows: np.ndarray, bpp: int, ftype: int) -> np.ndarray:
    """(h, stride) uint8 rows filtered with one PNG filter type (0-4); every
    type predicts from the unfiltered bytes, so the whole image filters at
    once."""
    x = rows.astype(np.int16)
    a = np.zeros_like(x)
    a[:, bpp:] = x[:, :-bpp]                     # the byte bpp to the left
    b = np.zeros_like(x)
    b[1:] = x[:-1]                               # the byte above
    c = np.zeros_like(x)
    c[1:, bpp:] = x[:-1, :-bpp]                  # above and to the left
    p = a + b - c
    pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
    paeth = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))
    pred = [np.zeros_like(x), a, b, (a + b) >> 1, paeth][ftype]
    return ((x - pred) & 0xFF).astype(np.uint8)


def build_png(ihdr: tuple, rows: np.ndarray, filter_type: int = 0) -> bytes:
    """A PNG from an IHDR tuple and raw (h, stride) bytes, every row filtered
    with ``filter_type``."""
    def chunk(kind, data):
        return struct.pack(">I", len(data)) + kind + data + struct.pack(
            ">I", zlib.crc32(kind + data) & 0xFFFFFFFF)
    w, _, depth, color = ihdr[:4]
    bpp = {0: 1, 2: 3, 6: 4}.get(color, 1) * max(depth // 8, 1)
    raw = np.concatenate([np.full((rows.shape[0], 1), filter_type, np.uint8),
                          filter_rows(rows, bpp, filter_type)], axis=1)
    return (b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", struct.pack(">IIBBBBB", *ihdr))
            + chunk(b"IDAT", zlib.compress(raw.tobytes())) + chunk(b"IEND", b""))


# ---------------------------------------------------------------------------
# colormap, .ocv, .xml


def test_jet_table_and_apply_jet_equal():
    assert np.array_equal(colormap.jet_table(), jcolormap.jet_table())
    assert np.array_equal(colormap.jet_table(100, 32), jcolormap.jet_table(100, 32))
    img = image("u8")
    assert np.array_equal(colormap.apply_jet(img), jcolormap.apply_jet(img))


@pytest.mark.parametrize("dtype", ["uint8", "int8", "uint16", "int16", "int32", "float32",
                                   "float64"])
@pytest.mark.parametrize("channels", [1, 3])
def test_ocv_files_are_byte_equal(tmp_path, dtype, channels):
    rng = np.random.default_rng(3)
    shape = (7, 9) if channels == 1 else (7, 9, 3)
    arr = (rng.normal(size=shape) * 100).astype(dtype)
    ocv_io.matwrite(tmp_path / "port.ocv", arr)
    jocv.matwrite(tmp_path / "jax.ocv", arr)
    assert (tmp_path / "port.ocv").read_bytes() == (tmp_path / "jax.ocv").read_bytes()
    for reader in (ocv_io.matread, jocv.matread):
        got = reader(tmp_path / "port.ocv")
        assert got.dtype == arr.dtype and np.array_equal(got, arr)


def test_ocv_rejects_what_the_original_rejects(tmp_path):
    for mod in (ocv_io, jocv):
        with pytest.raises(ValueError, match="only 2D"):
            mod.matwrite(tmp_path / "x.ocv", np.zeros((2, 2, 2, 2), np.uint8))


def test_xml_files_are_byte_equal(tmp_path):
    rng = np.random.default_rng(5)
    mats = {"bscan001": rng.normal(size=(5, 6)).astype(np.float32),
            "spec": rng.normal(size=7), "counts": rng.integers(0, 255, (3, 4)).astype(np.uint8),
            "shorts": rng.integers(-900, 900, (2, 3)).astype(np.int16)}
    scalars = {"camgain": 12, "camtime": 1000, "bscanthreshold": -30}
    cvxml.write_xml(tmp_path / "port.xml", mats, scalars)
    jcvxml.write_xml(tmp_path / "jax.xml", mats, scalars)
    assert (tmp_path / "port.xml").read_bytes() == (tmp_path / "jax.xml").read_bytes()
    got, got_s = cvxml.read_xml(tmp_path / "jax.xml")
    want, want_s = jcvxml.read_xml(tmp_path / "port.xml")
    assert got_s == want_s and set(got) == set(want) == set(mats)
    for name in mats:
        assert got[name].dtype == want[name].dtype
        np.testing.assert_array_equal(got[name], want[name])


# ---------------------------------------------------------------------------
# PNG: decoded pixels, both ways


@pytest.mark.parametrize("kind", list(KINDS))
def test_pil_reads_the_ports_png(tmp_path, kind):
    arr = image(kind)
    path = tmp_path / "port.png"
    path.write_bytes(imageio.encode_png(arr))
    got = jimageio.read_png(path)
    assert got.dtype == arr.dtype and np.array_equal(got, arr)
    assert np.array_equal(imageio.read_png(path), arr)
    filters = {zlib.decompress(d)[0] for k, d in png_chunks(path.read_bytes()) if k == b"IDAT"}
    assert filters == {0}


@pytest.mark.parametrize("filter_type", [0, 1, 2, 3, 4], ids=["none", "sub", "up", "avg", "paeth"])
@pytest.mark.parametrize("kind", list(KINDS))
def test_both_readers_undo_every_filter(tmp_path, kind, filter_type):
    """Every row of the file carries one filter type; PIL and the port's
    codec decode it to the same pixels."""
    arr = image(kind)
    h, w = arr.shape[:2]
    color, depth = (2 if arr.ndim == 3 else 0), 8 * arr.dtype.itemsize
    rows = np.ascontiguousarray(arr.astype(">u2") if depth == 16 else arr).view(np.uint8)
    path = tmp_path / "filtered.png"
    path.write_bytes(build_png((w, h, depth, color, 0, 0, 0), rows.reshape(h, -1), filter_type))
    got = imageio.read_png(path)
    assert got.dtype == arr.dtype and np.array_equal(got, arr)
    assert np.array_equal(jimageio.read_png(path), arr)


@pytest.mark.parametrize("kind", list(KINDS))
def test_port_reads_pils_png(tmp_path, kind):
    """PIL picks a filter per row (adaptive), so its files carry several."""
    for seed in range(3):
        arr = image(kind, seed)
        if seed == 1:                                  # smooth rows: other filters win
            arr = np.sort(arr, axis=1)
        path = tmp_path / f"pil{seed}.png"
        jimageio.write_png(path, arr)
        got = imageio.read_png(path)
        assert got.dtype == arr.dtype and np.array_equal(got, arr)
        assert np.array_equal(got, jimageio.read_png(path))


def test_port_write_png_equals_pil_write_png(tmp_path):
    """write_png's dtype rules: uint16 stays 16-bit, any other 2-D array is
    cast to uint8, colour to uint8 RGB."""
    rng = np.random.default_rng(2)
    for arr in (image("u8"), image("u16"), image("rgb"),
                rng.uniform(0, 300, (9, 11)), rng.integers(0, 255, (9, 11)).astype(np.int32)):
        imageio.write_png(tmp_path / "sub" / "port.png", arr)
        jimageio.write_png(tmp_path / "jax.png", arr)
        a, b = (jimageio.read_png(tmp_path / "sub" / "port.png"),
                imageio.read_png(tmp_path / "jax.png"))
        assert a.dtype == b.dtype and np.array_equal(a, b)


def test_rgba_and_16_bit_colour_read_as_pil_does(tmp_path):
    rgba = np.random.default_rng(4).integers(0, 256, (13, 17, 4), dtype=np.uint8)
    PIL_Image.fromarray(rgba, "RGBA").save(tmp_path / "rgba.png")
    rgb16 = np.random.default_rng(5).integers(0, 65536, (13, 17, 3), dtype=np.uint16)
    (tmp_path / "rgb16.png").write_bytes(build_png(
        (17, 13, 16, 2, 0, 0, 0), rgb16.astype(">u2").view(np.uint8).reshape(13, -1)))
    for name in ("rgba.png", "rgb16.png"):
        want = jimageio.read_png(tmp_path / name)
        got = imageio.read_png(tmp_path / name)
        assert got.dtype == want.dtype == np.uint8 and got.shape == want.shape == (13, 17, 3)
        assert np.array_equal(got, want)
        for channel in range(4):
            assert np.array_equal(imageio.read_png_gray(tmp_path / name, channel),
                                  jimageio.read_png_gray(tmp_path / name, channel))


@pytest.mark.parametrize("case", ["palette", "grey_alpha", "one_bit", "interlaced", "not_png"])
def test_unsupported_png_raises_naming_the_file(tmp_path, case):
    path = tmp_path / f"{case}.png"
    arr = image("u8")
    if case == "palette":
        PIL_Image.fromarray(arr, "L").convert("P").save(path)
    elif case == "grey_alpha":
        PIL_Image.fromarray(np.stack([arr, arr], -1), "LA").save(path)
    elif case == "one_bit":
        PIL_Image.fromarray(arr > 128).save(path)
    elif case == "interlaced":
        path.write_bytes(build_png((41, 23, 8, 0, 0, 0, 1), arr))
    else:
        path.write_bytes(b"GIF89a" + bytes(32))
    with pytest.raises(ValueError, match=f"{case}.png"):
        imageio.read_png(path)


# ---------------------------------------------------------------------------
# RunWriter


def fill(writer, cfg, rng):
    writer.save_data("bscan001", rng.normal(size=(6, 5)).astype(np.float32))
    writer.save_data("jscan001", rng.normal(size=(6, 5)))
    writer.save_data("vec", rng.normal(size=4))
    writer.save_image("bscan001", rng.integers(0, 256, (6, 5), dtype=np.uint8))
    writer.save_image("Trig000-000", rng.integers(0, 65536, (6, 5), dtype=np.uint16))
    writer.save_colormapped("bscanc001", rng.integers(0, 256, (6, 5), dtype=np.uint8))
    writer.save_bin("spectrum", rng.normal(size=(6, 5)))
    writer.parameter_footer(cfg, -np.inf if writer.fmt == "xml" else 3.7)
    return writer.close()


@pytest.mark.parametrize("fmt", ["m", "xml", "npz"])
def test_run_writer_writes_the_same_files(tmp_path, fmt):
    ts = 1_700_000_123.0
    port = RunWriter(tmp_path / "port", "cmp", fmt=fmt, timestamp=ts)
    jax = JaxRunWriter(tmp_path / "jax", "cmp", fmt=fmt, timestamp=ts)
    assert port.dir.name == jax.dir.name
    kw = dict(gain=7, exposure_us=321, width=64, height=8)
    p = fill(port, PipelineConfig(**kw), np.random.default_rng(9))
    j = fill(jax, JaxConfig(**kw), np.random.default_rng(9))
    assert p.name == j.name and p.read_bytes() == j.read_bytes()
    names = sorted(f.name for f in port.dir.iterdir())
    assert names == sorted(f.name for f in jax.dir.iterdir())
    for name in names:
        if name.endswith(".png"):
            a, b = jimageio.read_png(port.dir / name), imageio.read_png(jax.dir / name)
            assert a.dtype == b.dtype and np.array_equal(a, b), name
        elif name != p.name:
            assert (port.dir / name).read_bytes() == (jax.dir / name).read_bytes(), name


def test_matlab_matrix_text_equal():
    rng = np.random.default_rng(1)
    for arr in (rng.normal(size=(3, 4)), rng.normal(size=5).astype(np.float32), np.eye(2),
                np.float64(2.5)):
        assert matlab_matrix(arr) == jax_matlab_matrix(arr)


def test_run_writer_rejects_an_unknown_format(tmp_path):
    with pytest.raises(ValueError, match="unknown fmt"):
        RunWriter(tmp_path, "bad", fmt="csv").close()


# ---------------------------------------------------------------------------
# replay sources


def test_replay_source_frames_equal(tmp_path):
    rgb, grey16 = image("rgb"), image("u16")
    jimageio.write_png(tmp_path / "imgi.png", rgb)
    jimageio.write_png(tmp_path / "backg.png", grey16)
    for channel in range(4):
        kw = dict(image=tmp_path / "imgi.png", background_image=tmp_path / "backg.png",
                  channel=channel)
        port, jax = ReplaySource(**kw), JaxReplaySource(**kw)
        pf, jf = port.frames(), jax.frames()
        for _ in range(2):
            assert np.array_equal(next(pf), next(jf))
        assert np.array_equal(port.background(), jax.background())
        assert np.array_equal(port.pi_frame(), jax.pi_frame())
    arrays = ReplaySource(image=grey16, pi_image=grey16 // 2)
    assert np.array_equal(arrays.pi_frame(), grey16 // 2)
    with pytest.raises(FileNotFoundError):
        arrays.background()


def test_directory_source_sets_equal(tmp_path):
    rng = np.random.default_rng(8)
    for s in range(2):
        for i in range(3):
            jimageio.write_png(tmp_path / f"Trig{s:03d}-{i:03d}.png",
                               rng.integers(0, 65536, (5, 7), dtype=np.uint16))
            jimageio.write_png(tmp_path / f"KTrig{s:03d}-{i:03d}.png",
                               rng.integers(0, 65536, (5, 7), dtype=np.uint16))
    jimageio.write_png(tmp_path / "bscan001.png", rng.integers(0, 256, (5, 7), dtype=np.uint8))
    port, jax = DirectorySource(tmp_path), JaxDirectorySource(tmp_path)
    assert port.sets() == jax.sets() and port.sets(True) == jax.sets(True)
    got, want = list(port.frames()), list(jax.frames())
    assert len(got) == len(want) == 6
    assert all(np.array_equal(a, b) for a, b in zip(got, want))
    for a, b in zip(port.j0_sets(), jax.j0_sets()):
        assert all(np.array_equal(x, y) for x, y in zip(a, b))
    assert np.array_equal(port.pi_frame(), jax.pi_frame())
    bg = rng.integers(0, 255, (5, 7)).astype(np.uint8)
    assert np.array_equal(DirectorySource(tmp_path, background_image=bg).background(), bg)
