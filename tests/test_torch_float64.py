"""A float64 configuration through the port: the group step runs the plain
chain on every device (``pipeline.group_kernel_applies``), because the group
kernels take a float32 or bfloat16 operator and their wrappers raise on CUDA
for any other.  A ``Session`` at ``dtype="float64"`` therefore runs on the
card with no kernel launch.

Tolerance: float64 against float64 in another order of operations, rtol
1e-9, atol 1e-9·max; uint8 displays equal.
"""

import numpy as np
import pytest
import torch

from fdoct_tpu_torch import pipeline
from fdoct_tpu_torch.config import PipelineConfig
from fdoct_tpu_torch.ops import kernels
from fdoct_tpu_torch.ops.kernels import LAUNCHES
from fdoct_tpu_torch.session import Session
from fdoct_tpu_torch.sources.synthetic import SyntheticSource

TOL = 1e-9
CFG = dict(width=256, height=32, averages=4, numfftpoints=512, numdisplaypoints=128,
           lambdamin=816e-9, lambdamax=884e-9, compat=True, dtype="float64")


@pytest.mark.parametrize("dtype,takes", [
    (torch.float32, True), (torch.bfloat16, True), (torch.float64, False),
    (torch.float16, False), (torch.int8, False)])
def test_group_kernel_applies(dtype, takes):
    assert pipeline.group_kernel_applies(dtype) is takes


def run_session(device, frames, src, **cfg):
    """A 'base' session: 'b' from 4 background frames, 'p' from the pi frame
    + 3 frames, then two groups through process_group; the launches of
    those groups and their results."""
    s = Session(PipelineConfig(**{**CFG, **cfg}), device=device)
    s.key("b")
    for _ in range(4):
        s.process(src.background())
    s.key("p")
    for f in [src.pi_frame(), *frames[:3]]:
        s.process(f)
    kernels.reset_launches()
    out = s.process_group(frames[3:11])
    return s, dict(LAUNCHES), out


def plain_chain(s, group):
    """form_bscan of the float64 product written out: (y − y_p)/y_b @ M."""
    x = (torch.as_tensor(group).to(s.device).double() - s.data_yp) / s.data_yb
    mag = torch.hypot(x @ s.calib.op_re, x @ s.calib.op_im).sum(0)
    return pipeline.form_bscan(mag, s.cfg, s.averagestoggle, bscanthreshold=s.bscanthreshold)


@pytest.fixture(scope="module")
def source():
    src = SyntheticSource(height=32, width=256, noise=0.0, seed=2, depths_um=(50.0, 120.0))
    it = src.frames()
    return src, np.stack([next(it) for _ in range(11)])


def assert_matches_chain(s, out, frames):
    assert len(out) == 2
    for g, res in enumerate(out):
        want = plain_chain(s, frames[3 + 4 * g:7 + 4 * g])
        assert res.bscan.dtype == torch.float64
        got, w = res.bscan.cpu().numpy(), want.bscan.cpu().numpy()
        np.testing.assert_allclose(got, w, rtol=TOL, atol=TOL * np.abs(w).max())
        np.testing.assert_array_equal(res.bscandisp, want.bscandisp.cpu().numpy())


@pytest.mark.parametrize("precision", ["default", "highest", "bf16"])
def test_float64_session_runs_the_plain_chain(source, precision):
    src, frames = source
    s, launches, out = run_session("cpu", frames, src, matmul_precision=precision)
    assert set(launches.values()) == {0}
    assert not pipeline.group_kernel_applies(s.calib.op_re.dtype)
    assert_matches_chain(s, out, frames)


def test_float32_session_still_takes_the_kernels(source, monkeypatch):
    """The rule sends only the float64 operator to the plain chain."""
    src, frames = source
    calls = []
    real = pipeline.fused_recon_raw_accumulate
    monkeypatch.setattr(pipeline, "fused_recon_raw_accumulate",
                        lambda *a: calls.append(1) or real(*a))
    run_session("cpu", frames, src, dtype="float32")
    assert len(calls) >= 2


@pytest.mark.cuda
@pytest.mark.parametrize("precision", ["default", "highest"])
def test_cuda_float64_session_launches_no_kernel(source, precision):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    src, frames = source
    s, launches, out = run_session("cuda", frames, src, matmul_precision=precision)
    torch.cuda.synchronize()
    assert set(launches.values()) == {0}
    assert_matches_chain(s, out, frames)
