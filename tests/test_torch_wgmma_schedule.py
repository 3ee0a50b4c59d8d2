"""The bf16 instances' warp-specialised TMA + wgmma schedule (namespace ws of
``csrc/fused_recon.cu``) and the rule that chooses it.

On the CPU: :func:`ops.kernels.bf16_schedule` against the C rule for each
input type (uint8 rows need n_in % 16, uint16 % 8, float32 % 4; ndisp % 8;
16-byte aligned bases); a view one element off a 16-byte boundary sends
every instance to ``mma.sync``, which the bit-equality checks on the card
rely on; the ring's stage count, computed from the source's constants as
the launch computes it, at every number of frames (at least two stages fit
the 227 KB a block may take, a single frame included); the ring's
barrier counts from the source; ws_trace.py's loads-only copy; the
modelled L2 bytes of a flagship launch; the build hash over the shared
header.  The
rounding of the tensor-core sums (ROUND_STAGES) is
tests/test_torch_bf16_rounding.py's.  On a GPU (cases marked ``cuda``):
every bf16 instance against its plain version at TC_TOL at the flagship,
chip_smoke.py's RESIDENT_RAGGED and every ``EDGE_SHAPES`` entry, and equal
bit for bit to its ``mma.sync`` schedule on the same values through a
misaligned view, for groups of 1, 3, 8 and 12 frames and a single row tile
(fewer rows than a block holds) too.

TC_TOL (rtol 1e-5, atol 1e-5·max): the kernel and its plain version round
the same float32 ratio to bf16, and bf16 × bf16 products are exact in
float32, so only the order of the float32 sums differs.
"""

import re

import numpy as np
import pytest
import torch

from fdoct_tpu_torch.ops import _build
from fdoct_tpu_torch.ops.kernels import (
    EDGE_SHAPES, LAUNCHES, bf16_schedule, fused_recon_accumulate,
    fused_recon_accumulate_reference, fused_recon_raw_accumulate,
    fused_recon_raw_accumulate_reference,
)

TC_TOL = 1e-5
FLAGSHIP = (8, 512, 2048, 512)
#: ragged in every tile of the wgmma schedule (rows % 16, n_in % 64, ndisp %
#: 128) at strides TMA takes (chip_smoke.py's RESIDENT_RAGGED)
RESIDENT_RAGGED = (8, 70, 1040, 200)
#: the input rows of each bf16 instance: its type and the n_in % that TMA's
#: 16-byte row strides need
INSTANCES = {"raw-u8": (torch.uint8, 16), "raw-u16": (torch.uint16, 8),
             "yr-f32": (torch.float32, 4)}


# --------------------------------------------------------------------------
# the rule


@pytest.mark.parametrize("instance", list(INSTANCES))
@pytest.mark.parametrize("n_in,ndisp,ptrs,want", [
    (2048, 512, (0, 256, 512, 1024, 4096), "wgmma"),      # the flagship
    (720, 360, (0,) * 5, "wgmma"),                        # the FLIR shape
    (1040, 200, (0,) * 5, "wgmma"),                       # RESIDENT_RAGGED
    (16, 8, (0,) * 5, "wgmma"),                           # the least strides every type takes
    (2048, 100, (0,) * 5, "mma.sync"),                    # ndisp % 8: bf16 rows not 16 B
    (2048, 4, (0,) * 5, "mma.sync"),
    (2048, 512, (16, 0, 0, 8, 0), "mma.sync"),            # an operator base off 16 B
    (2048, 512, (0, 0, 0, 0, 2), "mma.sync"),
    (2048, 512, (1, 0, 0, 0, 0), "mma.sync"),             # the input rows' base off 16 B
    (2048, 512, (0, 4, 0, 0, 0), "mma.sync"),             # pi_frame's
    (2048, 512, (0, 0, 8, 0, 0), "mma.sync"),             # inv_background's
], ids=["flagship", "flir", "resident-ragged", "least", "ndisp-100", "ndisp-4", "op_re-off",
        "op_im-off", "x-off", "pi-off", "inv-off"])
def test_schedule_follows_the_tma_rule(instance, n_in, ndisp, ptrs, want):
    dtype, _ = INSTANCES[instance]
    assert bf16_schedule(dtype, n_in, ndisp, ptrs) == want


@pytest.mark.parametrize("instance", list(INSTANCES))
def test_row_strides_per_input_type(instance):
    """n_in must make a row a whole number of 16-byte units: 16 u8 samples,
    8 u16 or 4 f32, so e.g. n_in = 300 is TMA's for f32 rows only."""
    dtype, per_16 = INSTANCES[instance]
    for n_in in range(per_16, 20 * per_16 + 1):
        want = "wgmma" if n_in % per_16 == 0 else "mma.sync"
        assert bf16_schedule(dtype, n_in, 512, (0,) * 5) == want, n_in
    assert (bf16_schedule(dtype, 300, 512, (0,) * 5) == "wgmma") == (dtype == torch.float32)
    assert (bf16_schedule(dtype, 360, 512, (0,) * 5) == "wgmma") == (dtype != torch.uint8)


@pytest.mark.parametrize("instance", list(INSTANCES))
def test_a_view_one_element_off_takes_mma_sync(instance):
    """The bit-equality check's second schedule: the same values through a
    view one element past a 16-byte aligned allocation."""
    dtype, _ = INSTANCES[instance]
    x = torch.zeros((2, 4, 64), dtype=dtype)
    op = torch.zeros((64, 16), dtype=torch.bfloat16)
    flat = torch.zeros(x.numel() + 1, dtype=dtype)
    shifted = flat[1:].view(x.shape)
    assert x.data_ptr() % 16 == 0 and flat.data_ptr() % 16 == 0
    assert bf16_schedule(dtype, 64, 16, [x.data_ptr(), op.data_ptr()]) == "wgmma"
    assert bf16_schedule(dtype, 64, 16, [shifted.data_ptr(), op.data_ptr()]) == "mma.sync"


# --------------------------------------------------------------------------
# the ring, from the source's constants


def _ws_constants() -> dict:
    text = (_build.PACKAGE_ROOT / "csrc" / "fused_recon.cu").read_text()
    body = text[text.index("namespace ws {"):text.index("}  // namespace ws")]
    return {name: int(value) for name, value in re.findall(r"constexpr int (\w+) = (\d+);", body)}


def ws_stages(dtype: torch.dtype, B: int) -> tuple[int, int]:
    """(stages, shared-memory bytes) of a launch, as launch_ws computes them:
    F = 1 << FS frames in flight whatever B is, R = BM / F = 8 rows; a stage
    holds the operator (re and im of BN depths), the input rows and (raw
    frames) pi and inv_background; beside the ring, A_TILES tiles of BM
    pairs x KT bf16 samples, which the forming warpgroup writes and both
    consumer warpgroups read, and the barriers of both rings."""
    c = _ws_constants()
    esize = torch.empty((), dtype=dtype).element_size()
    R = c["BM"] >> c["FS"]
    op = 2 * c["BN"] * c["KT"] * 2
    stage = op + c["BM"] * c["KT"] * esize + (2 * R * c["KT"] * 4 if dtype != torch.float32 else 0)
    a_tiles = c["A_TILES"] * c["BM"] * c["KT"] * 2
    extra = 1024 + 2 * (c["MAX_STAGES"] + c["A_TILES"]) * 8
    nst = min(c["MAX_STAGES"], (c["SMEM_LIMIT"] - extra - a_tiles) // stage)
    return nst, nst * stage + a_tiles + extra


def test_ring_constants_match_the_source():
    """64 pairs (the M of one wgmma: R = 8 rows of 8 frames) x 128 depths a
    block, 64 samples a stage; the operator as four 64 x 64 boxes (re and
    im of each warpgroup's 64 depths); one A tile a stage, in a ring of
    three, formed by one warpgroup for both consumer warpgroups."""
    c = _ws_constants()
    assert (c["BM"], c["BN"], c["KT"], c["MAX_STAGES"], c["SMEM_LIMIT"]) == (64, 128, 64, 4, 232448)
    assert c["A_TILES"] == 3 and c["BM"] >> c["FS"] == 8
    text = (_build.PACKAGE_ROOT / "csrc" / "fused_recon.cu").read_text()
    assert "constexpr int A_BYTES = BM * KT * 2;" in text
    assert "constexpr int OP_BYTES = 4 * OP_BOX;" in text and "constexpr int OP_BOX = KT * 64 * 2;" in text
    assert "constexpr int SMEM_EXTRA = 1024 + 2 * MAX_STAGES * 8;" in text
    assert c["FS"] == 3 and "constexpr int fs = ws::FS, R = ws::BM >> fs;" in text


@pytest.mark.parametrize("instance", list(INSTANCES))
@pytest.mark.parametrize("B", [1, 2, 3, 4, 8, 12, 40])
def test_at_least_two_stages_fit(instance, B):
    """A ring of one stage would wait for each load; every number of frames
    gets two or more within the 232,448 bytes a block may take (eight
    frames in flight at every B, the frames past B zero: 16 rows of pi and
    inv_background a stage)."""
    dtype, _ = INSTANCES[instance]
    nst, smem = ws_stages(dtype, B)
    assert 2 <= nst <= 4 and smem <= 232448, (nst, smem)


def test_flagship_stage_counts():
    """Four stages at 8 frames in flight for every input type: 40 KiB for u8
    frames, 44 KiB for u16 frames and 48 KiB for an f32 ratio, beside three
    A tiles of 8 KiB and the barriers of both rings."""
    assert ws_stages(torch.uint8, 8) == (4, 4 * 40 * 1024 + 3 * 8192 + 1024 + 14 * 8)
    assert ws_stages(torch.uint16, 8) == (4, 4 * 44 * 1024 + 3 * 8192 + 1024 + 14 * 8)
    assert ws_stages(torch.float32, 8) == (4, 4 * 48 * 1024 + 3 * 8192 + 1024 + 14 * 8)


# --------------------------------------------------------------------------
# the ring's barrier counts, the loads-only floor and the L2 traffic


def _ws_kernel() -> str:
    text = (_build.PACKAGE_ROOT / "csrc" / "fused_recon.cu").read_text()
    body = text[text.index("fused_recon_ws_kernel(const __grid_constant__"):]
    return body[:body.index("\n}\n")]


def _barrier_counts() -> dict:
    """The arrivals that complete a phase of each barrier, from the source."""
    body = _ws_kernel()
    return {name: int(re.search(rf"mbar_init\(&{name}\[\w\], (\d+)\);", body).group(1))
            for name in ("full", "empty", "a_full", "a_empty")}


def test_the_barrier_counts_are_the_warps_of_each_role():
    """A slot is free once the four forming warps (its rows read) and the
    eight consumer warps (its operator read by their wgmmas) have arrived;
    an A tile is announced by the four forming warps and freed by the eight
    consumer warps; the producer's expect_tx is a stage's one arrival."""
    assert _barrier_counts() == {"full": 1, "empty": 12, "a_full": 4, "a_empty": 8}


def _ws_trace():
    import importlib.util

    spec = importlib.util.spec_from_file_location("ws_trace", _build.PACKAGE_ROOT.parent /
                                                  "ws_trace.py")
    ws_trace = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(ws_trace)
    return ws_trace


def test_loads_only_strips_the_work_and_keeps_the_handoffs(tmp_path):
    """ws_trace.py --loads-only: the bf16 kernel keeps every load, wait and
    arrival but forms, stores and multiplies nothing; the f32 and int8
    schedules and the shipped source are untouched; no trace is inserted."""
    ws_trace = _ws_trace()
    out = ws_trace.make(tmp_path, loads_only=True) / "fdoct_tpu_torch" / "csrc"
    shipped = _build.PACKAGE_ROOT / "csrc"
    text = (out / "fused_recon.cu").read_text()
    body = text[text.index("fused_recon_ws_kernel(const __grid_constant__"):]
    body = body[:body.index("\n}\n")]
    before = _ws_kernel()
    for gone in ("ws_form_a<In", "ws_store_a(", "wgmma_m64n128k16_ss("):
        assert gone in before and gone not in body, gone
    for kept in ("mbar_wait(", "mbar_arrive(", "tma_load_", "mbar_expect_tx(", "fence_proxy_async"):
        assert body.count(kept) == before.count(kept), kept
    assert "clock64" not in text
    ws32 = "fused_recon_ws32_kernel(const __grid_constant__"
    shipped_text = (shipped / "fused_recon.cu").read_text()
    assert text[text.index(ws32):] == shipped_text[shipped_text.index(ws32):]
    assert (out / "int8_bscan.cu").read_text() == (shipped / "int8_bscan.cu").read_text()
    assert (out / "hopper_mma.cuh").read_text() == (shipped / "hopper_mma.cuh").read_text()


def test_wgmma_l2_bytes_at_the_flagship():
    """chip_smoke.wgmma_l2_bytes, a model of the tile's reads: each of the
    64 row tiles reads the whole 4 MiB bf16 operator (256 MiB), each of the
    4 depth tiles every frame (u8 8 MiB, u16 16 MiB, an f32 ratio 32 MiB)
    and, for raw frames, pi and inv_background (8 MiB); a group of one
    frame reads 1 MiB of frames."""
    import chip_smoke

    mib = 2 ** 20
    flagship = (512, 2048, 512)
    assert chip_smoke.wgmma_l2_bytes(8, *flagship, 1, True) == 320 * mib
    assert chip_smoke.wgmma_l2_bytes(8, *flagship, 2, True) == 352 * mib
    assert chip_smoke.wgmma_l2_bytes(8, *flagship, 4, False) == 384 * mib
    assert chip_smoke.wgmma_l2_bytes(1, *flagship, 1, True) == 292 * mib
    assert chip_smoke.wgmma_l2_bytes(0, *flagship, 1, False) == 256 * mib


def test_build_hash_covers_the_shared_header(tmp_path, monkeypatch):
    """An edit of hopper_mma.cuh alone rebuilds the library."""
    header = _build.HEADERS[0]
    before = _build.library_path()
    edited = tmp_path / header.name
    edited.write_text(header.read_text() + "\n// edited\n")
    monkeypatch.setattr(_build, "HEADERS", (edited,))
    assert _build.library_path() != before
    monkeypatch.setattr(_build, "HEADERS", (header,))
    assert _build.library_path() == before


def test_the_trace_is_compiled_out_by_default():
    """The shipped kernel holds no clock64 stage trace: ws_trace.py inserts
    it into a copy of the package."""
    text = (_build.PACKAGE_ROOT / "csrc" / "fused_recon.cu").read_text()
    assert "clock64" not in text and "ws_trace_cycles" not in text
    assert not any("TRACE" in flag for flag in _build.NVCC_FLAGS)


# --------------------------------------------------------------------------
# on the card


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")
    return torch.device("cuda")


def problem(shape, seed, dev):
    """u8 and u16 frames, an f32 ratio, pi, inv_background and a bf16
    operator of shape (B, rows, n_in, ndisp), drawn with numpy."""
    B, rows, n_in, ndisp = shape
    rng = np.random.default_rng(seed)
    t = {"raw-u8": rng.integers(0, 255, (B, rows, n_in)).astype(np.uint8),
         "raw-u16": (rng.integers(0, 4096, (B, rows, n_in)) << 4).astype(np.uint16),
         "yr-f32": rng.normal(size=(B, rows, n_in)).astype(np.float32),
         "pi": rng.uniform(0, 50, (rows, n_in)).astype(np.float32),
         "inv": (1.0 / rng.uniform(50, 200, (rows, n_in))).astype(np.float32),
         "mr": rng.normal(size=(n_in, ndisp)).astype(np.float32),
         "mi": rng.normal(size=(n_in, ndisp)).astype(np.float32)}
    t = {k: torch.as_tensor(v).to(dev) for k, v in t.items()}
    t["mr"], t["mi"] = t["mr"].to(torch.bfloat16), t["mi"].to(torch.bfloat16)
    return t


def run(t, instance, x=None, kernel=True):
    """The instance on problem ``t``, its input rows replaced by ``x``."""
    x = t[instance] if x is None else x
    if instance == "yr-f32":
        fn = fused_recon_accumulate if kernel else fused_recon_accumulate_reference
        return fn(x, t["mr"], t["mi"])
    fn = fused_recon_raw_accumulate if kernel else fused_recon_raw_accumulate_reference
    return fn(x, t["pi"], t["inv"], t["mr"], t["mi"])


def schedule(t, instance, x=None):
    x = t[instance] if x is None else x
    ptrs = [x.data_ptr(), t["mr"].data_ptr(), t["mi"].data_ptr()]
    if instance != "yr-f32":
        ptrs += [t["pi"].data_ptr(), t["inv"].data_ptr()]
    return bf16_schedule(x.dtype, x.shape[-1], t["mr"].shape[1], ptrs)


def misaligned(x):
    """The same values through a view one element past an aligned buffer."""
    flat = torch.empty(x.numel() + 1, dtype=x.dtype, device=x.device)
    flat[1:] = x.flatten()
    return flat[1:].view(x.shape)


CUDA_SHAPES = {"flagship": FLAGSHIP, "resident-ragged": RESIDENT_RAGGED, **EDGE_SHAPES}


@pytest.mark.cuda
@pytest.mark.parametrize("instance", list(INSTANCES))
@pytest.mark.parametrize("shape", list(CUDA_SHAPES.values()), ids=list(CUDA_SHAPES))
def test_cuda_instance_matches_plain(cuda, shape, instance):
    t = problem(shape, 21, cuda)
    if shape in (FLAGSHIP, RESIDENT_RAGGED):
        assert schedule(t, instance) == "wgmma"
    key = "fused_recon_accumulate" if instance == "yr-f32" else "fused_recon_raw_accumulate"
    before = LAUNCHES[key]
    got = run(t, instance)
    torch.cuda.synchronize()
    assert LAUNCHES[key] == before + 1
    want = run(t, instance, kernel=False)
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(), rtol=TC_TOL,
                               atol=TC_TOL * float(want.abs().max()))


@pytest.mark.cuda
@pytest.mark.parametrize("instance", list(INSTANCES))
@pytest.mark.parametrize("shape", [FLAGSHIP, RESIDENT_RAGGED, (1, 70, 1040, 200),
                                   (3, 70, 1040, 200), (12, 70, 1040, 200), (8, 5, 1040, 200)],
                         ids=["flagship", "resident-ragged", "B1", "B3", "B12", "one-row-tile"])
def test_cuda_wgmma_equals_mma_sync_bit_for_bit(cuda, shape, instance):
    """The warp-specialised schedule and the mma.sync one on the same values
    (the second through a misaligned view, which the rule sends to
    mma.sync): the same sums, bit for bit, one row tile (5 rows) too."""
    t = problem(shape, 22, cuda)
    x = misaligned(t[instance])
    assert schedule(t, instance) == "wgmma" and schedule(t, instance, x) == "mma.sync"
    got, want = run(t, instance), run(t, instance, x)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("instance", list(INSTANCES))
@pytest.mark.parametrize("B,rows", [(1, 48), (3, 48), (8, 48), (12, 48), (1, 8)],
                         ids=["1", "3", "8", "12", "1-one-row-tile"])
def test_cuda_frames_per_group(cuda, B, rows, instance):
    """Groups of 1 (eight frames in flight, seven zero and not formed), 3,
    8 and 12 (two chunks, the second of four frames) at a flagship-wide
    shape, and a one-frame group of a single row tile."""
    t = problem((B, rows, 2048, 512), 23 + B, cuda)
    assert schedule(t, instance) == "wgmma"
    got = run(t, instance)
    want = run(t, instance, kernel=False)
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(), rtol=TC_TOL,
                               atol=TC_TOL * float(want.abs().max()))
    assert torch.equal(got, run(t, instance, misaligned(t[instance])))
