"""Kernel 3's warp-specialised TMA + s8 ``wgmma`` schedule (namespace i8ws
of ``csrc/int8_bscan.cu``), the rule that chooses it and what it must keep
of the ``mma.sync`` schedule.

On the CPU: :func:`ops.kernels.int8_schedule` against the C rule
(``i8ws_applies``) at the flagship, the FLIR shape, n_in % 16 != 0 and each
base one byte off; a view one element off a 16-byte boundary; the ring's
stage count from the source's constants; the C entry's ctypes signature;
the build hash over the shared header; the tensor-map helpers and the s8
wrapper in that header; the frame-slot sum of the new epilogue (a
reduce-scatter) emulated in float32 against ``tc::sum_frame_slots``'
butterfly bit for bit, zero slots past B included; the trace edits; and the
plain version (which the wrapper runs on CPU tensors) against the Pallas
kernel in interpret mode past eight frames at strides TMA takes.  On a GPU
(cases marked ``cuda``): every output (db, mn, mx, linear) of the wgmma
schedule ``torch.equal`` to the ``mma.sync`` one's on the same values
through a misaligned view, at the flagship, RESIDENT_RAGGED, RAGGED's rows,
frames and depths at n_in = 304, every ``EDGE_SHAPES`` entry with n_in % 16
== 0 and B = 1, 3, 8, 12, 40; the min/max partials at a ±0 floor; each
against its plain version at INT8_TOL; and a CUDA graph of a call replayed
on new frames equal to the eager call.

Tolerances: INT8_TOL (dB and the partials rtol 1e-5, atol 1e-4; linear
rtol 1e-5, atol 1e-6) is tests/test_torch_int8direct.py's and
chip_smoke.py's: the plain version sums the magnitudes in another order.
Between the two schedules there is none: they compute the same float
operations in the same order on exact s32 sums.
"""

import re

import numpy as np
import pytest
import torch

from fdoct_tpu_torch.ops import _build
from fdoct_tpu_torch.ops.kernels import (
    EDGE_SHAPES, INT8_K_TILE, LAUNCHES, int8_bscan_display_fused,
    int8_bscan_display_fused_reference, int8_schedule, pack_int8_operator,
)

SOURCE = _build.PACKAGE_ROOT / "csrc" / "int8_bscan.cu"
HEADER = _build.PACKAGE_ROOT / "csrc" / "hopper_mma.cuh"
FLAGSHIP = (8, 512, 2048, 512)
#: ragged in every tile of the wgmma schedule (rows % 16, n_in % 128,
#: ndisp % 128) at strides TMA takes (chip_smoke.py's RESIDENT_RAGGED)
RESIDENT_RAGGED = (8, 70, 1040, 200)
#: chip_smoke.py's RAGGED (3, 100, 300, 77) with n_in rounded up to 16
RAGGED16 = (3, 100, 304, 77)
INT8_TOL = (1e-5, 1e-4)


def kernel_args(shape, seed=0, device="cpu"):
    """Kernel 3's positional arguments, drawn with numpy as
    chip_smoke.int8_random_args draws them (dB values of a few tens)."""
    B, rows, n_in, ndisp = shape
    rng = np.random.default_rng(seed)
    return [torch.as_tensor(a).to(device) for a in (
        rng.integers(-128, 128, (B, rows, n_in)).astype(np.int8),
        rng.integers(-127, 128, (n_in, ndisp)).astype(np.int8),
        rng.integers(-127, 128, (n_in, ndisp)).astype(np.int8),
        rng.uniform(1e-4, 2e-4, ndisp).astype(np.float32),
        rng.uniform(1e-4, 2e-4, ndisp).astype(np.float32),
        rng.uniform(0.5, 2.0, (rows, 1)).astype(np.float32),
        rng.normal(0, 0.5, (rows, ndisp)).astype(np.float32),
        rng.normal(0, 0.5, (rows, ndisp)).astype(np.float32))]


# --------------------------------------------------------------------------
# the rule


@pytest.mark.parametrize("n_in,ptrs,want", [
    (2048, (0, 4096), "wgmma"),                  # the flagship
    (720, (0, 0), "wgmma"),                      # the FLIR shape
    (1040, (0, 0), "wgmma"),                     # RESIDENT_RAGGED
    (16, (0, 0), "wgmma"),                       # the least stride TMA takes
    (48, (0, 0), "wgmma"),                       # EDGE_SHAPES k-tail
    (300, (0, 0), "mma.sync"),                   # RAGGED: n_in % 16 == 12
    (2040, (0, 0), "mma.sync"),                  # n_in % 16 == 8
    (2047, (0, 0), "mma.sync"),
    (2048, (1, 0), "mma.sync"),                  # the frames' base one byte off
    (2048, (0, 1), "mma.sync"),                  # the packed operator's
    (2048, (8, 0), "mma.sync"),                  # eight bytes off
    (2048, (4097, 4096), "mma.sync"),
], ids=["flagship", "flir", "resident-ragged", "least", "k-tail", "ragged", "n-2040", "n-2047",
        "frames-off1", "packed-off1", "frames-off8", "frames-off-after"])
def test_schedule_follows_the_tma_rule(n_in, ptrs, want):
    assert int8_schedule(n_in, ptrs) == want


def test_row_strides():
    """n_in must make a frame row a whole number of 16-byte units; the
    number of frames, rows and depths enters no rule."""
    for n_in in range(1, 321):
        assert int8_schedule(n_in, (0, 0)) == ("wgmma" if n_in % 16 == 0 else "mma.sync"), n_in


def _body(text: str, head: str) -> str:
    body = text[text.index(head):]
    return body[:body.index("\n}\n")]


def test_rule_mirrors_the_c_source():
    """int8_schedule's conditions are i8ws_applies', fdoct_int8_bscan asks
    it before either launch, and a tensor map the encoder refuses is an
    error, never the mma.sync schedule."""
    text = SOURCE.read_text()
    body = _body(text, "bool i8ws_applies(")
    assert "return n_in % 16 == 0 && aligned(frames) && aligned(opk);" in body
    entry = _body(text, 'extern "C" int fdoct_int8_bscan(')
    assert entry.index("i8ws_applies(frames, opk, n_in)") < entry.index("return launch_i8ws(")
    assert entry.index("return launch_i8ws(") < entry.index("int8_bscan_kernel<<<")
    launch = _body(text, "int launch_i8ws(")
    assert "if (!ok) return static_cast<int>(cudaErrorInvalidValue);" in launch
    assert "int8_bscan_kernel" not in launch
    assert "CU_TENSOR_MAP_SWIZZLE_128B" in launch and launch.count("tensor_map(&maps[") == 2


def test_a_view_one_element_off_takes_mma_sync():
    args = kernel_args((2, 16, 64, 8))
    packed = pack_int8_operator(args[1], args[2])
    flat = torch.zeros(args[0].numel() + 1, dtype=torch.int8)
    shifted = flat[1:].view(args[0].shape)
    assert int8_schedule(64, [args[0].data_ptr(), packed.data_ptr()]) == "wgmma"
    assert int8_schedule(64, [shifted.data_ptr(), packed.data_ptr()]) == "mma.sync"


# --------------------------------------------------------------------------
# the ring and the block, from the source's constants


def _constants() -> dict:
    text = SOURCE.read_text()
    body = text[text.index("namespace i8ws {"):text.index("}  // namespace i8ws")]
    return {name: int(value) for name, value in re.findall(r"constexpr int (\w+) = (\d+);", body)}


def i8ws_stages(B: int) -> tuple[int, int]:
    """(stages, shared-memory bytes) of a launch, as the source computes
    them: a stage holds the operator box (KT samples x re and im of BN
    depths) and the frames box (KT samples x BM pairs), whatever B is;
    beside the ring the block's dequantisation tables (const_re, const_im
    of R = BM / 8 rows x BN depths, s_re, s_im, row_gain; f32)."""
    c = _constants()
    stage = 2 * c["BN"] * c["KT"] + c["BM"] * c["KT"]
    R = c["BM"] >> c["FS"]
    tables = (2 * R * c["BN"] + 2 * c["BN"] + R) * 4
    extra = 1024 + 2 * c["MAX_STAGES"] * 8
    nst = min(c["MAX_STAGES"], (c["SMEM_LIMIT"] - extra - tables) // stage)
    return nst, nst * stage + tables + extra


@pytest.mark.parametrize("B", [1, 3, 8, 12, 40])
def test_at_least_two_stages_fit(B):
    nst, smem = i8ws_stages(B)
    assert 2 <= nst <= 4 and smem <= 232448, (nst, smem)


def test_ring_constants_match_the_source():
    """128 pairs (two consumer warpgroups of wgmma m64) x 128 depths (re and
    im make N = 256), 128 s8 samples a stage (one 128-byte swizzle row, four
    k32 steps), 8 frames in flight, four 48 KiB stages beside 17 KiB of
    tables, registers moved to the consumers within the register file."""
    c = _constants()
    assert (c["BM"], c["BN"], c["KT"], c["FS"], c["THREADS"]) == (128, 128, 128, 3, 384)
    assert 128 * c["PRODUCER_REGS"] + 256 * c["CONSUMER_REGS"] <= 65536
    assert c["PRODUCER_REGS"] % 8 == c["CONSUMER_REGS"] % 8 == 0
    assert i8ws_stages(8) == (4, 4 * 49152 + 17472 + 1088)
    text = SOURCE.read_text()
    for line in ("constexpr int OP_BYTES = 2 * BN * KT;", "constexpr int IN_BYTES = BM * KT;",
                 "constexpr int STAGE_BYTES = OP_BYTES + IN_BYTES;",
                 "constexpr int TABLE_BYTES = (2 * R * BN + 2 * BN + R) * 4;",
                 "constexpr int SMEM_BYTES = STAGES * STAGE_BYTES + TABLE_BYTES + SMEM_EXTRA;",
                 'static_assert(STAGES >= 2, "a ring of at least two stages");'):
        assert line in text, line
    kernel = _body(text, "int8_bscan_ws_kernel(")
    assert kernel.count("wgmma_m64n256k32_s8_ss(acc, ") == 1 and "kk < 4" in kernel
    assert "wgmma_wait<1>();" in kernel and "setmaxnreg_inc<" in kernel
    launch = _body(text, "int launch_i8ws(")
    assert "const cuuint32_t in_box[3] = {i8ws::KT, 1u << i8ws::FS, i8ws::R};" in launch
    assert "const cuuint32_t op_box[3] = {i8ws::KT, i8ws::BN, 2};" in launch
    # the packed operator's rows stay INT8_K_TILE-padded, a multiple of 16 bytes
    assert INT8_K_TILE % 16 == 0


def test_c_entry_signature_is_unchanged():
    """fdoct_int8_bscan keeps its arguments: seven pointers, four floats,
    four pointers, five ints and the stream."""
    ptr, flt, i32 = _build._PTR, _build._FLOAT, _build._INT
    want = [ptr] * 7 + [flt] * 4 + [ptr] * 4 + [i32] * 5 + [ptr]
    assert _build.SIGNATURES["fdoct_int8_bscan"] == want
    entry = _body(SOURCE.read_text(), 'extern "C" int fdoct_int8_bscan(')
    params = entry[entry.index("(") + 1:entry.index(")")].split(",")
    kinds = {"const void*": ptr, "void*": ptr, "float": flt, "int": i32}
    assert [kinds[" ".join(p.split()[:-1])] for p in params] == want


@pytest.mark.parametrize("which", ["header", "source"])
def test_build_hash_covers_the_header_and_the_source(tmp_path, monkeypatch, which):
    """An edit of hopper_mma.cuh or of int8_bscan.cu alone rebuilds."""
    attr = "HEADERS" if which == "header" else "SOURCES"
    files = getattr(_build, attr)
    target = HEADER if which == "header" else SOURCE
    before = _build.library_path()
    edited = tmp_path / target.name
    edited.write_text(target.read_text() + "\n// edited\n")
    monkeypatch.setattr(_build, attr, tuple(edited if f == target else f for f in files))
    assert _build.library_path() != before
    monkeypatch.setattr(_build, attr, files)
    assert _build.library_path() == before


def test_header_holds_the_tma_helpers_and_the_s8_wgmma():
    """The tensor-map encoding is the shared header's, used by both
    sources; the header has the s8 wgmma and an int accumulator hold."""
    header = HEADER.read_text()
    fused = (_build.PACKAGE_ROOT / "csrc" / "fused_recon.cu").read_text()
    for name in ("EncodeTiledFn encode_tiled()", "bool tensor_map("):
        assert header.count(f"inline {name}") == 1 and name not in fused
    assert "tensor_map(&" in fused and "tensor_map(&" in SOURCE.read_text()
    assert "wgmma.mma_async.sync.aligned.m64n256k32.s32.s8.s8" in header
    assert "void wgmma_hold(int (&r)[N])" in header
    assert "void wgmma_m64n256k32_s8_ss(int (&d)[128]" in header


# --------------------------------------------------------------------------
# the frame-slot sum, emulated


def butterfly(mag: np.ndarray, F: int) -> np.ndarray:
    """tc::sum_frame_slots over the first F slots: each step every slot adds
    the value of the slot ``bit`` apart (float32); every slot ends with the
    row's sum."""
    v = mag[:F].copy()
    bit = 1
    while bit < F:
        v = (v + v[np.arange(F) ^ bit]).astype(np.float32)
        bit <<= 1
    return v


def halving(mag: np.ndarray) -> np.ndarray:
    """The kernel's reduce-scatter over 8 slots (i8ws_halve three times):
    slot s keeps z[s, 4l + 2h + e] of depth group jb(s) + l."""
    v = mag.copy()
    for k in range(3):
        n = v.shape[1]
        up = (np.arange(8) >> k) & 1
        lo, hi = v[:, :n // 2], v[:, n // 2:]
        keep = np.where(up[:, None] == 1, hi, lo)
        send = np.where(up[:, None] == 1, lo, hi)
        v = (keep + send[np.arange(8) ^ (1 << k)]).astype(np.float32)
    return v


def jb(s: int) -> int:
    return 8 * (s & 1) + 4 * ((s >> 1) & 1) + 2 * ((s >> 2) & 1)


def frames_shift(B: int) -> int:
    fs = 0
    while (1 << fs) < B and (1 << fs) < 8:
        fs += 1
    return fs


@pytest.mark.parametrize("B", [1, 2, 3, 4, 5, 7, 8])
def test_halving_sums_the_slots_as_the_butterfly(B):
    """Each slot ends with 8 of the 64 sums, every (j, h, e) in exactly one
    slot, bit for bit the mma.sync schedule's butterfly over F =
    frames_shift(B) slots: the slots past B hold +0 and add nothing."""
    rng = np.random.default_rng(B)
    mag = np.zeros((8, 64), np.float32)
    mag[:B] = np.exp(rng.normal(size=(B, 64)) * 3).astype(np.float32)    # magnitudes >= 0
    want = butterfly(mag, 1 << frames_shift(B))
    assert all((want[s] == want[0]).all() for s in range(1 << frames_shift(B)))
    z = halving(mag)
    seen = set()
    for s in range(8):
        for k in range(8):
            l, h, e = k >> 2, (k >> 1) & 1, k & 1
            i = 4 * (jb(s) + l) + 2 * h + e
            seen.add(i)
            assert z[s, k].view(np.int32) == want[0, i].view(np.int32), (s, k)
    assert seen == set(range(64))


def test_each_depth_tile_is_folded_in_once():
    """A lane's 8 values lie in depth tile jb >> 2; the lanes that fold the
    partials in (tq == 0, slot < 4) cover the block's four tiles once, and
    the lanes that share a tile differ in tq and slot bit 2 only."""
    assert sorted(jb(s) >> 2 for s in range(4)) == [0, 1, 2, 3]
    for s in range(8):
        assert jb(s) >> 2 == jb(s ^ 4) >> 2
        assert {(jb(s) + l) >> 2 for l in range(2)} == {jb(s) >> 2}


# --------------------------------------------------------------------------
# the trace and the plain version


def test_the_trace_edits_apply_to_the_int8_schedule(tmp_path):
    """ws_trace.py's edits find each anchor once in int8_bscan.cu, and the
    shipped source holds no trace."""
    import importlib.util

    spec = importlib.util.spec_from_file_location("ws_trace", _build.PACKAGE_ROOT.parent /
                                                  "ws_trace.py")
    ws_trace = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(ws_trace)
    traced = (ws_trace.make(tmp_path) / "fdoct_tpu_torch" / "csrc" /
              "int8_bscan.cu").read_text()
    body = _body(traced, "int8_bscan_ws_kernel(")
    assert body.count("WS_TRACE_START;") == 1 and body.count("WS_TRACE_END(total);") == 1
    for mark in range(7):
        assert body.count(f"WS_MARK({mark});") == 1, mark
    assert 'extern "C" int fdoct_int8_trace_read(' in traced
    assert "clock64" not in SOURCE.read_text()


@pytest.fixture
def pallas():
    jnp = pytest.importorskip("jax.numpy")
    from fdoct_tpu.ops.pallas_kernels import int8_bscan_display_fused as pallas_int8
    return jnp, pallas_int8


@pytest.mark.parametrize("shape", [(12, 16, 64, 24), (3, 10, 48, 7)], ids=["B12", "B3"])
def test_plain_matches_pallas_kernel_at_tma_strides(pallas, shape):
    """At strides the wgmma schedule takes (n_in % 16 == 0), past eight
    frames and short of them, the wrapper on CPU tensors (its plain
    version) against the TPU kernel in interpret mode: dB and the global
    min/max at INT8_TOL."""
    jnp, pallas_int8 = pallas
    args = kernel_args(shape, seed=4)
    assert int8_schedule(shape[2], [a.data_ptr() for a in args[:1]]) == "wgmma"
    B = shape[0]
    db, mn, mx = pallas_int8(*(jnp.asarray(a.numpy()) for a in args),
                             jnp.asarray(-30.0, jnp.float32), averages=B, eps=1e-5,
                             denom=2.303, interpret=True)
    before = dict(LAUNCHES)
    got = int8_bscan_display_fused(*args, -30.0, B, eps=1e-5, denom=2.303)
    assert LAUNCHES == before
    rtol, atol = INT8_TOL
    np.testing.assert_allclose(got.db.numpy(), np.asarray(db), rtol=rtol, atol=atol)
    np.testing.assert_allclose(float(got.mn.min()), float(jnp.min(mn)), rtol=rtol, atol=atol)
    np.testing.assert_allclose(float(got.mx.max()), float(jnp.max(mx)), rtol=rtol, atol=atol)


# --------------------------------------------------------------------------
# on the card


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")
    return torch.device("cuda")


def misaligned(x):
    """The same values through a view one element past an aligned buffer."""
    flat = torch.empty(x.numel() + 1, dtype=x.dtype, device=x.device)
    flat[1:] = x.flatten()
    return flat[1:].view(x.shape)


CUDA_SHAPES = {"flagship": FLAGSHIP, "resident-ragged": RESIDENT_RAGGED, "ragged16": RAGGED16,
               **{k: v for k, v in EDGE_SHAPES.items() if v[2] % 16 == 0},
               **{f"B{B}": (B, 48, 2048, 512) for B in (1, 3, 8, 12, 40)}}


@pytest.mark.cuda
@pytest.mark.parametrize("with_linear", [False, True], ids=["no-linear", "linear"])
@pytest.mark.parametrize("shape", list(CUDA_SHAPES.values()), ids=list(CUDA_SHAPES))
def test_cuda_wgmma_equals_mma_sync_bit_for_bit(cuda, shape, with_linear):
    args = kernel_args(shape, 41, cuda)
    packed = pack_int8_operator(args[1], args[2])
    y = misaligned(args[0])
    assert int8_schedule(shape[2], [args[0].data_ptr(), packed.data_ptr()]) == "wgmma"
    assert int8_schedule(shape[2], [y.data_ptr(), packed.data_ptr()]) == "mma.sync"
    before = LAUNCHES["int8_bscan_display_fused"]
    got = int8_bscan_display_fused(*args, -30.0, shape[0], with_linear=with_linear,
                                   oq_packed=packed)
    want = int8_bscan_display_fused(y, *args[1:], -30.0, shape[0], with_linear=with_linear,
                                    oq_packed=packed)
    torch.cuda.synchronize()
    assert LAUNCHES["int8_bscan_display_fused"] == before + 2
    for part in got._fields:
        if not with_linear and part == "linear":
            assert got.linear is None and want.linear is None
            continue
        assert torch.equal(getattr(got, part), getattr(want, part)), part


@pytest.mark.cuda
@pytest.mark.parametrize("shape", list(CUDA_SHAPES.values()), ids=list(CUDA_SHAPES))
def test_cuda_wgmma_matches_plain(cuda, shape):
    args = kernel_args(shape, 42, cuda)
    assert int8_schedule(shape[2], [args[0].data_ptr(), 0]) == "wgmma"
    got = int8_bscan_display_fused(*args, -30.0, shape[0], with_linear=True)
    want = int8_bscan_display_fused_reference(*args, -30.0, shape[0], with_linear=True)
    torch.cuda.synchronize()
    rtol, atol = INT8_TOL
    for part in ("db", "mn", "mx"):
        np.testing.assert_allclose(getattr(got, part).cpu().numpy(),
                                   getattr(want, part).cpu().numpy(), rtol=rtol, atol=atol,
                                   err_msg=part)
    np.testing.assert_allclose(got.linear.cpu().numpy(), want.linear.cpu().numpy(), rtol=rtol,
                               atol=1e-6)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(8, 64, 64, 64), (12, 48, 2048, 512)], ids=["small", "B12"])
@pytest.mark.parametrize("thresh", [-0.0, 0.0], ids=["minus-zero", "plus-zero"])
def test_cuda_wgmma_partials_at_a_zero_floor(cuda, thresh, shape):
    """test_cuda_int8_partials_at_a_zero_floor's values on the wgmma
    schedule: every dB negative, so every partial is the floor's zero, its
    sign kept by the ordered-bits atomics."""
    args = kernel_args(shape, 0, cuda)
    for i in (3, 4, 6, 7):                        # scales and constants: |x| << 1
        args[i] = args[i] * 1e-4
    assert int8_schedule(shape[2], [args[0].data_ptr(), 0]) == "wgmma"
    want = int8_bscan_display_fused_reference(*args, thresh, shape[0])
    assert float(want.db.max()) < 0.0
    got = int8_bscan_display_fused(*args, thresh, shape[0])
    torch.cuda.synchronize()
    for name in ("mn", "mx"):
        assert torch.equal(getattr(got, name).view(torch.int32),
                           getattr(want, name).view(torch.int32)), name


@pytest.mark.cuda
def test_cuda_graph_replays_on_new_frames(cuda):
    """A captured call bakes its tensor maps into the graph: they address
    the static frames, so a replay after new frames are copied in equals an
    eager call on them."""
    args = kernel_args((8, 64, 2048, 512), 43, cuda)
    packed = pack_int8_operator(args[1], args[2])
    static = args[0].clone()

    def call():
        return int8_bscan_display_fused(static, *args[1:], -30.0, 8, with_linear=True,
                                        oq_packed=packed)

    call()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = call()
    fresh = kernel_args((8, 64, 2048, 512), 44, cuda)[0]
    static.copy_(fresh)
    graph.replay()
    want = int8_bscan_display_fused(fresh, *args[1:], -30.0, 8, with_linear=True,
                                    oq_packed=packed)
    torch.cuda.synchronize()
    for part in out._fields:
        assert torch.equal(getattr(out, part), getattr(want, part)), part
