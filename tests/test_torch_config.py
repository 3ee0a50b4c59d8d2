"""The port's own copies of the JAX package's pure host modules — the
configuration, the synthetic source and the profiling meters — held to the
originals: equal defaults field by field, ini files written by one package
read back by the other, bit-equal synthetic frames, and the same meter
behaviour.  The two packages are separate classes, so values cross between
them as plain data (``dataclasses.asdict``, files, arrays)."""

import dataclasses
import time

import numpy as np
import pytest

pytest.importorskip("jax")   # the JAX reference; without it (a GPU-only host) skip

from fdoct_tpu import config as jconfig
from fdoct_tpu.sources import synthetic as jsynthetic
from fdoct_tpu.utils import profiling as jprofiling
from fdoct_tpu_torch import config as tconfig
from fdoct_tpu_torch.sources import synthetic as tsynthetic
from fdoct_tpu_torch.utils import profiling as tprofiling

#: non-default configurations, one per ini variant family
CONFIGS = {
    "base": ("base", dict(width=2048, height=512, averages=8, numfftpoints=2048,
                          numdisplaypoints=512, dirdescr="flagship", saveframes=True,
                          lambdamin=8.1e-7, lambdamax=8.9e-7, donotnormalize=False)),
    "webcam": ("webcam", dict(width=640, height=480, channelnum=3, mediann=3,
                              movavgn=2, rowwisenormalize=True)),
    "dark": ("dark", dict(bandpassfilter=True, lowpassfilter=True, gain=20,
                          increasefftpointsmultiplier=2)),
    "spinjnt": ("spinjnt", dict(binvaluex=2, binvaluey=4, bscanbinx=2, bscanbiny=3,
                                offline_tool_path="tools/offline", width=1280, height=960)),
    "viewportc": ("viewportc", dict(vgamma=1.5, wb_red=0.9, wb_green=1.1, wb_blue=1.2,
                                    dirdescr="")),
}


def test_pipeline_config_defaults_equal_field_by_field():
    t, j = tconfig.PipelineConfig(), jconfig.PipelineConfig()
    assert t is not j and type(t) is not type(j)
    assert [f.name for f in dataclasses.fields(t)] == [f.name for f in dataclasses.fields(j)]
    assert dataclasses.asdict(t) == dataclasses.asdict(j)
    for f_t, f_j in zip(dataclasses.fields(t), dataclasses.fields(j)):
        assert f_t.type == f_j.type, f_t.name
    assert (t.opw, t.oph, t.lambda0, t.lambdabw) == (j.opw, j.oph, j.lambda0, j.lambdabw)


def test_schemas_equal():
    assert {k: [n for n, _ in v] for k, v in tconfig.SCHEMAS.items()} == \
           {k: [n for n, _ in v] for k, v in jconfig.SCHEMAS.items()}


@pytest.mark.parametrize("writer", ["port", "jax"])
@pytest.mark.parametrize("name", list(CONFIGS))
def test_ini_crosses_between_packages(tmp_path, name, writer):
    variant, kw = CONFIGS[name]
    t, j = tconfig.PipelineConfig(**kw), jconfig.PipelineConfig(**kw)
    path = tmp_path / f"{name}.ini"
    if writer == "port":
        tconfig.write_ini(t, path, variant=variant)
        back = jconfig.read_ini(path, variant=variant, validate=False)
    else:
        jconfig.write_ini(j, path, variant=variant)
        back = tconfig.read_ini(path, variant=variant, validate=False)
    # the two writers give the same file, and it reads back to the same fields
    other = tmp_path / "other.ini"
    (jconfig.write_ini(j, other, variant=variant) if writer == "port"
     else tconfig.write_ini(t, other, variant=variant))
    assert path.read_text() == other.read_text()
    fields = {n for n, _ in tconfig.SCHEMAS[variant]}
    want = {k: v for k, v in dataclasses.asdict(t).items() if k in fields}
    got = {k: v for k, v in dataclasses.asdict(back).items() if k in fields}
    if "dirdescr" in want and not want["dirdescr"]:
        want["dirdescr"] = "_"                 # the wire format's empty string
    assert got == want


def test_json_and_validate_agree():
    kw = CONFIGS["base"][1]
    t, j = tconfig.PipelineConfig(**kw), jconfig.PipelineConfig(**kw)
    assert t.to_json() == j.to_json()
    assert dataclasses.asdict(tconfig.PipelineConfig.from_json(j.to_json())) == \
           dataclasses.asdict(j)
    bad = dict(numdisplaypoints=4096, numfftpoints=1024, matmul_precision="tf32")
    with pytest.raises(ValueError) as et:
        tconfig.PipelineConfig(**bad).validate()
    with pytest.raises(ValueError) as ej:
        jconfig.PipelineConfig(**bad).validate()
    assert str(et.value) == str(ej.value)


@pytest.mark.parametrize("kw", [
    dict(height=16, width=256, noise=0.02, seed=3),
    dict(height=8, width=128, depths_um=(40.0, 70.0, 120.0), reflectivities=(0.3, 0.2, 0.1),
         noise=0.01, seed=11),
    dict(height=4, width=256, vibration_amp_nm=80.0, noise=0.0),
    dict(height=4, width=64, bpp=12, noise=0.05, seed=5),
], ids=["noisy", "three-scatterers", "vibrating", "12-bit"])
def test_synthetic_source_frames_bit_equal(kw):
    t, j = tsynthetic.SyntheticSource(**kw), jsynthetic.SyntheticSource(**kw)
    tf, jf = t.frames(), j.frames()
    for _ in range(3):
        a, b = next(tf), next(jf)
        assert a.dtype == b.dtype and np.array_equal(a, b)
    assert np.array_equal(t.background(), j.background())
    assert np.array_equal(t.pi_frame(), j.pi_frame())


def test_synthetic_fixtures_bit_equal():
    for fn, kw in (("staircase_phantom", dict(h=40, w=128)), ("wang_fixture", dict(h=12, w=64))):
        a, b = getattr(tsynthetic, fn)(**kw), getattr(jsynthetic, fn)(**kw)
        assert a.keys() == b.keys()
        for k in a:
            assert np.array_equal(a[k], b[k]), (fn, k)


def test_fps_meter_behaves_the_same():
    meters = [tprofiling.FpsMeter(window_s=0.05), jprofiling.FpsMeter(window_s=0.05)]
    readings = [[m.tick(3) for m in meters]]
    time.sleep(0.06)
    readings.append([m.tick(2) for m in meters])
    assert readings[0] == [None, None]
    assert all(r is not None and r > 0 for r in readings[1])
    assert abs(readings[1][0] - readings[1][1]) / readings[1][1] < 0.5
    assert [m._count for m in meters] == [0, 0]
    assert [m.tick() for m in meters] == [None, None]


def test_stage_timer_behaves_the_same():
    timers = [tprofiling.StageTimer(), jprofiling.StageTimer()]
    for tm in timers:
        for name in ("recon", "display", "recon"):
            with tm.stage(name):
                pass
        with pytest.raises(KeyError):
            with tm.stage("fails"):
                raise KeyError("x")
    assert timers[0].counts == timers[1].counts == {"recon": 2, "display": 1, "fails": 1}
    assert [r.split()[0] for r in timers[0].report().splitlines()] == \
           sorted(timers[0].totals, key=lambda k: -timers[0].totals[k])
    assert all(len(tm.report().splitlines()) == 3 for tm in timers)


def test_port_profiling_has_no_device_trace():
    assert not hasattr(tprofiling, "device_trace")
    assert hasattr(jprofiling, "device_trace")
