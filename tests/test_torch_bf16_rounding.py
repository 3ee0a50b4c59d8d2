"""How the bf16 instances round their tensor-core sums (ROUND_STAGES of
namespace ws of ``csrc/fused_recon.cu``), held to float64.

The tensor cores sum in float32 without rounding to nearest.  Both bf16
schedules (the warp-specialised ``wgmma`` one and ``mma.sync``) therefore
sum each round of ROUND_STAGES stages of 64 samples into a fragment that
starts at zero, and add the fragment to float32 running sums in
round-to-nearest.  ``chip_smoke.truncating_chain`` models those sums: k16
steps, the running sum truncated to 24 bits after each, at 24 bits and
ROUND_STAGES a round's sum added in float32.

On the CPU, at (2 frames, 64 rows, 2048 samples) against the flagship
operator of ``Calibration.create``, on u8 and u16 white noise (as
chip_smoke.py's phase 17 draws it) and on camera-like frames (the
synthetic source): the chain never rounded misses BF16_F64_TOL on white
noise (the fault the rounding repairs), the shipped interval reads at most
half of it, and the model stays within BF16_F64_TOL of JAX's
``fused_recon_resident`` in interpret mode (bf16 operands, float32 sums)
on the same frames.  On a GPU (cases marked ``cuda``): each bf16 instance
and the resident entry at the flagship on white noise, in both schedules,
within BF16_F64_TOL of the float64 product of its rounded operands.

BF16_F64_TOL is chip_smoke.py's: rtol 2e-6, atol 2e-6·max.
"""

import importlib.util
import re

import numpy as np
import pytest
import torch

from fdoct_tpu_torch.calibration import Calibration
from fdoct_tpu_torch.config import PipelineConfig
from fdoct_tpu_torch.ops import _build
from fdoct_tpu_torch.ops.kernels import (
    bf16_schedule, fused_recon_accumulate, fused_recon_raw_accumulate, fused_recon_resident,
)
from fdoct_tpu_torch.sources.synthetic import SyntheticSource

_spec = importlib.util.spec_from_file_location("chip_smoke",
                                               _build.PACKAGE_ROOT.parent / "chip_smoke.py")
chip_smoke = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(chip_smoke)

TOL = chip_smoke.BF16_F64_TOL
#: the reduced shape of the CPU cases: (frames, rows), n_in and ndisp the flagship's
REDUCED = (2, 64)
FRAMES = ["u8 noise", "u16 noise", "camera"]
NOISE = FRAMES[:2]


def source_round_stages() -> int:
    text = (_build.PACKAGE_ROOT / "csrc" / "fused_recon.cu").read_text()
    body = text[text.index("namespace ws {"):text.index("}  // namespace ws")]
    return int(re.search(r"constexpr int ROUND_STAGES = (\d+);", body).group(1))


def flagship_cfg() -> PipelineConfig:
    return PipelineConfig(**chip_smoke.FLAGSHIP)


def frames(kind: str, B: int, rows: int, cfg: PipelineConfig, dev) -> dict:
    """raw frames, pi and inv_background of ``kind``: chip_smoke's u8 white
    noise (random_problem, seed SEED + 21) or u16 white noise (u16_problem
    "noise"), or the synthetic source's u8 frames with its pi frame and
    background (chip_smoke.py phase 3's flagship frames)."""
    if kind == "u8 noise":
        inp = chip_smoke.random_problem((B, rows, cfg.width, 1), chip_smoke.SEED + 21, dev)
    elif kind == "u16 noise":
        inp = chip_smoke.u16_problem(cfg, "noise", dev, (B, rows, cfg.width, 1))
    else:
        src = SyntheticSource(height=rows, width=cfg.width, lambda0=cfg.lambda0,
                              dlambda=cfg.lambdabw * 2.3548 / 4.0, noise=0.02,
                              seed=chip_smoke.SEED)
        it = src.frames()
        bg = np.maximum(src.background(), 1)
        inp = {"raw": torch.as_tensor(np.stack([next(it) for _ in range(B)])).to(dev),
               "pi": torch.as_tensor(src.pi_frame()).to(dev, torch.float32),
               "inv": torch.as_tensor(1.0 / bg).to(dev, torch.float32)}
    return {k: inp[k] for k in ("raw", "pi", "inv")}


def ratio(inp: dict) -> torch.Tensor:
    """The float32 ratio every bf16 instance forms, rounded op by op."""
    return (inp["raw"].float() - inp["pi"]) * inp["inv"]


def share(got: torch.Tensor, want: torch.Tensor) -> float:
    atol = TOL * float(want.abs().max())
    return chip_smoke.compare(got, want, TOL, atol)["worst_share_of_tol"]


@pytest.fixture(scope="module")
def flagship_m():
    """The flagship operator (float64 on the host, then float32), rounded
    to bf16 as the 'default' route takes it."""
    calib = Calibration.create(flagship_cfg(), "cpu")
    return calib.op_re.to(torch.bfloat16), calib.op_im.to(torch.bfloat16)


@pytest.fixture(scope="module")
def reduced(flagship_m):
    """{kind: (frames, float32 ratio, float64 product of the rounded
    operands)} at the reduced shape."""
    out = {}
    for kind in FRAMES:
        inp = frames(kind, *REDUCED, flagship_cfg(), torch.device("cpu"))
        x32 = ratio(inp)
        out[kind] = inp, x32, chip_smoke.bf16_f64_product(x32, *flagship_m)
    return out


# --------------------------------------------------------------------------
# the rule


def test_round_stages_is_a_modelled_interval():
    """ROUND_STAGES is one of the intervals the model reads well under the
    limit (1, 2 or 4 stages; at 8 it reads 0.86-0.95 of it), it is the
    interval chip_smoke.py reads, and both bf16 schedules round at it."""
    assert source_round_stages() in (1, 2, 4)
    assert chip_smoke.ws_round_stages() == source_round_stages()
    text = (_build.PACKAGE_ROOT / "csrc" / "fused_recon.cu").read_text()
    tc = text[text.index("fused_recon_tc_kernel(const In*"):]
    tc = tc[:tc.index("\n}\n")]
    assert "if (kt % ws::ROUND_STAGES == 0) tc_zero(part);" in tc
    assert "kt % ws::ROUND_STAGES == ws::ROUND_STAGES - 1 || kt == nk - 1) tc_add_rn(acc, part);" in tc
    ws = text[text.index("fused_recon_ws_kernel(const __grid_constant__"):]
    ws = ws[:ws.index("\n}\n")]
    assert "const bool fresh = kt % ws::ROUND_STAGES == 0;" in ws and "!fresh || kk > 0" in ws
    assert ws.count("ws_add_fragment(acc, part);") == 2


def test_the_model_never_rounded_is_the_old_chain():
    """Without rounds the model is the chain of truncated k16 steps that
    chip_smoke.py held the earlier schedule to; with one round longer than
    n_in it is the same chain."""
    rng = np.random.default_rng(5)
    x = torch.as_tensor(rng.normal(size=(2, 8, 300))).float()
    mr, mi = (torch.as_tensor(rng.normal(size=(300, 24))).to(torch.bfloat16) for _ in range(2))
    chain = chip_smoke.truncating_chain(x, mr, mi, 24)
    assert torch.equal(chain, chip_smoke.truncating_chain(x, mr, mi, 24, round_stages=5))
    assert not torch.equal(chain, chip_smoke.truncating_chain(x, mr, mi, 24, round_stages=1))


# --------------------------------------------------------------------------
# the model at the reduced shape


@pytest.mark.parametrize("kind", NOISE)
def test_white_noise_never_rounded_misses_the_limit(reduced, flagship_m, kind):
    """The fault: a chunk's whole chain in one truncating accumulator errs
    ~3x BF16_F64_TOL on white noise (the ratio's large mean, which M
    cancels), where the camera's frames read ~0.8x."""
    _, x32, want = reduced[kind]
    assert share(chip_smoke.truncating_chain(x32, *flagship_m, 24), want) > 1.0


@pytest.mark.parametrize("kind", FRAMES)
def test_the_shipped_interval_meets_half_the_limit(reduced, flagship_m, kind):
    _, x32, want = reduced[kind]
    got = chip_smoke.truncating_chain(x32, *flagship_m, 24, source_round_stages())
    assert share(got, want) <= 0.5


@pytest.mark.parametrize("kind", FRAMES)
def test_the_23_bit_control_still_misses_the_limit_on_noise(reduced, flagship_m, kind):
    """chip_smoke.py's control, a chain truncated to 23 bits never rounded,
    fails the limit on every kind of frames."""
    _, x32, want = reduced[kind]
    assert share(chip_smoke.truncating_chain(x32, *flagship_m, 23), want) > 1.0


@pytest.fixture
def pallas():
    """The JAX Pallas kernels, imported here so that the CUDA cases below can
    run where JAX is not installed (``--noconftest -m cuda``)."""
    import jax.numpy as jnp
    from fdoct_tpu.ops import pallas_kernels
    return jnp, pallas_kernels


@pytest.mark.parametrize("kind", FRAMES)
def test_the_model_agrees_with_the_jax_kernel(pallas, reduced, flagship_m, kind):
    """JAX's fused_recon_resident (interpret mode: bf16 ratio and operator,
    float32 sums) on the same frames, and the schedules' model, within
    BF16_F64_TOL of each other and each of the float64 product."""
    jnp, pk = pallas
    inp, x32, want = reduced[kind]
    jax_out = torch.as_tensor(np.array(pk.fused_recon_resident(
        jnp.asarray(inp["raw"].numpy()), jnp.asarray(inp["pi"].numpy()),
        jnp.asarray(inp["inv"].numpy()),
        jnp.asarray(flagship_m[0].float().numpy(), jnp.bfloat16),
        jnp.asarray(flagship_m[1].float().numpy(), jnp.bfloat16), interpret=True)))
    model = chip_smoke.truncating_chain(x32, *flagship_m, 24, source_round_stages())
    assert share(jax_out, want) <= 1.0 and share(model, want) <= 1.0
    assert share(model, jax_out.double()) <= 1.0


# --------------------------------------------------------------------------
# on the card


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")
    return torch.device("cuda")


def misaligned(x: torch.Tensor) -> torch.Tensor:
    """The same values through a view one element past an aligned buffer:
    the mma.sync schedule."""
    flat = torch.empty(x.numel() + 1, dtype=x.dtype, device=x.device)
    flat[1:] = x.flatten()
    return flat[1:].view(x.shape)


INSTANCES = {"raw-u8": "u8 noise", "raw-u16": "u16 noise", "yr-f32": "u8 noise",
             "resident": "u8 noise"}


@pytest.mark.cuda
@pytest.mark.parametrize("instance", list(INSTANCES))
def test_cuda_white_noise_meets_the_limit(cuda, instance):
    """Each bf16 instance and the resident entry at the flagship (8 frames
    of 512 x 2048, the flagship M) on white noise (the f32-ratio instance on
    the u8 noise's ratio): within BF16_F64_TOL of the float64 product of its
    rounded operands in the wgmma schedule and, through a misaligned view,
    in the mma.sync schedule, which computes the same sums bit for bit."""
    cfg = flagship_cfg()
    calib = Calibration.create(cfg, cuda)
    ops = (calib.op_re_bf16, calib.op_im_bf16)
    inp = frames(INSTANCES[instance], cfg.averages, cfg.height, cfg, cuda)
    x32 = ratio(inp)
    want = chip_smoke.bf16_f64_product(x32, *ops)
    x = x32 if instance == "yr-f32" else inp["raw"]
    terms = () if instance == "yr-f32" else (inp["pi"], inp["inv"])

    def run(rows):
        if instance == "yr-f32":
            return fused_recon_accumulate(rows, *ops)
        fn = fused_recon_resident if instance == "resident" else fused_recon_raw_accumulate
        return fn(rows, *terms, *ops)

    ptrs = [t.data_ptr() for t in (x, *ops, *terms)]
    assert bf16_schedule(x.dtype, x.shape[-1], ops[0].shape[1], ptrs) == "wgmma"
    got, got_mma = run(x), run(misaligned(x))
    torch.cuda.synchronize()
    assert share(got, want) <= 1.0 and share(got_mma, want) <= 1.0
    assert torch.equal(got, got_mma)


@pytest.mark.cuda
def test_cuda_camera_frames_meet_half_the_limit(cuda):
    """The flagship's camera-like frames (chip_smoke.py phase 3), kernel 1
    u8 bf16: at most half of BF16_F64_TOL, as the model reads them."""
    cfg = flagship_cfg()
    calib = Calibration.create(cfg, cuda)
    ops = (calib.op_re_bf16, calib.op_im_bf16)
    inp = frames("camera", cfg.averages, cfg.height, cfg, cuda)
    got = fused_recon_raw_accumulate(inp["raw"], inp["pi"], inp["inv"], *ops)
    torch.cuda.synchronize()
    assert share(got, chip_smoke.bf16_f64_product(ratio(inp), *ops)) <= 0.5
