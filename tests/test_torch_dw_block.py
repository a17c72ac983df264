"""Port parity: the block schedule of the dW kernel.

`csrc/gather_dw.cu` (replaces efg_tpu's `_dw_kernel`) gives a block one
pair, KC channels of each of its three taps, ON ≤ 128 columns of O (two
column blocks at O = 256) and a chunk of steps of TM output rows. It loads the chunk's rulebook words, lists the steps where some
row has one of the pair's flags, stages each listed step's three tap rows as
one A tile [TM, 3·KC] and its gradient rows as one G tile [TM, O] (zero
where a tap's flag is off or its row is out of range, G zero where the row
has no flag of the pair), accumulates Aᵀ·G with its warps splitting the
tile WM × WN and a step's rows WK ways, sums the WK partials in order and
writes the block's partial into a workspace [chunks, P·3·C, O] that a
second kernel sums over the chunks in chunk order. A CUDA kernel cannot run
here, so a numpy model of that schedule, its Plan read from the source's
`constexpr` lines, is held in f64 at 1e-5·max|ref| against efg_tpu's
`fused_gather_dw` in Pallas interpret mode and against `gather_dw_plain`,
on the gather-GEMM's hazard cases (those at 256 channels too) and on
cases of the dW kernel's own.
Every step with a live tap runs, a skipped step's slice of A is zero, the
blocks write every row of the workspace once, and a planted fault (a skip
rule blind to a step's last row, tap 2 read at pos) fails the model. The
Plans' shared memory and accumulators are held against the H100's limits.
The kernel itself is held against the plain version and the stacked path's
dW on the card by chip_smoke.py (phase `train_kernels`; at 256 channels
phases `kernels`, on WIDE_EDGE_CASES, and `detr_train`, on ConQueR's res4)."""

import functools
import re
from pathlib import Path

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
import jax.numpy as jnp

from efg_tpu.ops.pallas import sparse_kernels as PK
from efg_tpu_torch.ops import sparse as TS
from efg_tpu_torch.ops.cuda import sparse_kernels as K

from test_torch_sparse_gemm_cases import (GEMM_CASES, WIDE_CASES, _c_eval, _gemm_case,
                                          _pair_no_flag)
from test_torch_sparse_kernels import NO_LAUNCHES, both_tensors, sites

# one intra-op thread: the workers of the parallel test run share the cores,
# which torch's thread pool in each of them would oversubscribe
torch.set_num_threads(1)

PK.set_interpret(True)

ROOT = Path(__file__).resolve().parents[1]
SOURCE = ROOT / "efg_tpu_torch" / "csrc" / "gather_dw.cu"
SMEM_LIMIT = 232448  # dynamic shared memory a block may take on the H100 (227 KB)
REGS_PER_SM = 65536  # 32-bit registers of an SM, at most 255 a thread
PAD = 8  # row padding of the staged bf16 tiles (gather_gemm_core.cuh kPad)


# ---------------------------------------------------------------------------
# the Plan, read from the source
# ---------------------------------------------------------------------------


def plan_lines(text: str) -> list:
    """(member, expression) of each `static constexpr int` line of the
    source's `struct Plan`, in order."""
    body = text.split("struct Plan {", 1)[1].split("};", 1)[0]
    return re.findall(r"static constexpr int (\w+) = ([^;]+);", body)


def dw_plan(c: int, o: int, text: str = None) -> dict:
    """gather_dw.cu's Plan<C, O> and what its Layout derives from it."""
    env = {"C": c, "O": o}
    for member, expr in plan_lines(text if text is not None else SOURCE.read_text()):
        env[member] = _c_eval(expr, env)
    kc, tm, wg, on = env["KC"], env["TM"], bool(env["WG"]), env["ON"]
    m = 3 * kc
    if wg:  # a warpgroup per tap over all of a step's rows; unpadded swizzled tiles
        ring = env["STAGES"] * tm * (m + on) * 2
        out = 0
    else:
        ring = env["STAGES"] * tm * (m + PAD + on + PAD) * 2
        out = env["WK"] * m * (on + 4) * 4
    env.update(CH=c // kc, OS=o // on, M=m,
               THREADS=3 * 128 if wg else 32 * env["WM"] * env["WN"] * env["WK"],
               WTM=m // env["WM"], WTN=on // env["WN"], KW=tm // env["WK"],
               BODY=max(ring, out), MAX_STEPS=env["ROWS"] // tm)
    if wg:  # each warpgroup takes all of a step's rows
        env.update(WK=1, KW=tm)
    env.update(MT=env["WTM"] // 16, NT=env["WTN"] // 8)
    env["ACC"] = on // 2 if wg else env["MT"] * env["NT"] * 4
    return env


def smem_bytes(plan: dict, steps: int) -> int:
    """gather_dw.cu `smem_bytes`: the ring (or the partials), the rulebook
    words, each step's flag and the list of steps."""
    return plan["BODY"] + steps * (plan["TM"] + 2) * 4 + 16 + (1024 if plan["WG"] else 0)


def row_chunks(plan: dict, v_out: int, n_pairs: int, resident: int) -> int:
    """gather_dw.cu `chunks_for`: blocks for WAVES times the resident ones,
    at most ROWS rows a block, no more chunks than tiles, then as few chunks
    as hold the steps a chunk takes."""
    tiles = -(-v_out // plan["TM"]) if v_out > 0 else 1
    n = -(-resident * plan["WAVES"] // (n_pairs * plan["CH"] * plan["OS"]))
    n = min(max(n, -(-tiles // plan["MAX_STEPS"])), tiles)
    steps = -(-tiles // n)
    return -(-tiles // steps)


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------


def runs_kernel(words):
    """The kernel's rule: a step runs when any of its rows has a flag."""
    return bool((words & 7).any())


def runs_blind_last_row(words):
    """A planted fault: a skip rule that does not look at a step's last row."""
    return bool((words[:-1] & 7).any())


def tap_rows(pos, fl):
    """rows of the three taps: (pos − 1, pos, pos + f0)."""
    return [pos - 1, pos, pos + ((fl >> 1) & 1)]


def tap_rows_fp_at_pos(pos, fl):
    """A planted fault: tap 2 read at pos instead of pos + f0."""
    return [pos - 1, pos, pos]


def model_dw(feats, packed, g, resident, rule=runs_kernel, rows_of=tap_rows):
    """dW as gather_dw.cu's blocks and its chunk sum form it, in f64 from
    the bf16-rounded inputs, at the kernel's widths (the wrapper pads C and
    O with zero channels) and cut back to C and O. Returns (dW, steps run,
    steps in all, chunks)."""
    v_in, c0 = feats.shape
    n_pairs, v_out = packed.shape
    o0 = g.shape[1]
    c, o = K._width(c0), K._width(o0)
    f = np.zeros((v_in, c))
    f[:, :c0] = torch.from_numpy(feats).to(torch.bfloat16).double().numpy()
    gd = np.zeros((v_out, o))
    gd[:, :o0] = torch.from_numpy(g).to(torch.bfloat16).double().numpy()
    plan = dw_plan(c, o)
    tm, kc, wk_n, kw, ncol = plan["TM"], plan["KC"], plan["WK"], plan["KW"], plan["ON"]
    chunks = row_chunks(plan, v_out, n_pairs, resident)
    tiles = -(-v_out // tm) if v_out > 0 else 1
    steps = -(-tiles // chunks)
    assert steps <= plan["MAX_STEPS"] and -(-tiles // steps) == chunks
    ws = np.full((chunks, n_pairs * 3 * c, o), np.nan)
    ran = total = 0
    for k in range(chunks):
        s0 = k * steps
        ns = min(steps, tiles - s0)
        assert ns >= 1, "an empty chunk"
        row0 = s0 * tm
        for p in range(n_pairs):
            words = np.zeros(ns * tm, np.int64)
            real = np.arange(row0, min(row0 + ns * tm, v_out))
            words[:len(real)] = packed[p, real]
            for ch, col0 in ((ch, col0) for ch in range(plan["CH"]) for col0 in range(0, o, ncol)):
                cols = slice(col0, col0 + ncol)  # the block's columns of G and of dW
                acc = np.zeros((wk_n, 3 * kc, ncol))
                for s in range(ns):
                    w = words[s * tm:(s + 1) * tm]
                    pos, fl = w >> 3, w & 7
                    a = np.zeros((tm, 3 * kc))  # the A tile as the copies fill it
                    live = np.zeros((tm, 3), bool)
                    for t, src in enumerate(rows_of(pos, fl)):
                        on = ((fl >> (2 - t)) & 1).astype(bool) & (src >= 0) & (src < v_in)
                        live[:, t] = on
                        a[on, t * kc:(t + 1) * kc] = f[src[on], ch * kc:(ch + 1) * kc]
                    gt = np.zeros((tm, ncol))
                    live_rows = np.flatnonzero(fl != 0)
                    gt[live_rows] = gd[row0 + s * tm + live_rows, cols]
                    total += 1
                    if not rule(w):
                        assert not live.any(), "a step with a live tap skipped"
                        assert not a.any(), "a skipped step's slice of A is not zero"
                        continue
                    ran += 1
                    for wk in range(wk_n):  # each warp's rows of the step
                        r = slice(wk * kw, (wk + 1) * kw)
                        acc[wk] += a[r].T @ gt[r]
                part = acc[0].copy()
                for wk in range(1, wk_n):  # the warps' partials, in order
                    part += acc[wk]
                for t in range(3):
                    dst = slice((p * 3 + t) * c + ch * kc, (p * 3 + t) * c + (ch + 1) * kc)
                    assert np.isnan(ws[k, dst, cols]).all(), "a workspace element written twice"
                    ws[k, dst, cols] = part[t * kc:(t + 1) * kc]
    assert not np.isnan(ws).any(), "a workspace element never written"
    dw = ws[0].copy()
    for k in range(1, chunks):  # the chunk sum, in chunk order
        dw += ws[k]
    dw = dw.reshape(n_pairs * 3, c, o)[:, :c0, :o0].reshape(-1, o0)
    return dw, ran, total, chunks


def _pallas_dw(feats, packed, g):
    """efg_tpu's Pallas `fused_gather_dw` (interpret mode, tile 128); its
    grid takes pairs in groups of three, so P is padded there with flag-off
    pairs, whose rows of dW are zero and cut off."""
    n_pairs, v_out = packed.shape
    pad = -(-n_pairs // 3) * 3 - n_pairs
    pk = np.concatenate([packed, np.zeros((pad, v_out), np.int32)])
    dw = PK.fused_gather_dw(jnp.asarray(feats), jnp.asarray(pk), jnp.asarray(g), tile=128)
    return np.asarray(dw, np.float64)[:n_pairs * 3 * feats.shape[1]]


def _close(got, want):
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-5 * max(float(np.abs(want).max(initial=0.0)), 1e-6))


def check_dw(feats, packed, g, resident, pallas=None, **faults):
    """The model against the plain version and the Pallas kernel (its dW
    given, or computed here)."""
    got, ran, total, chunks = model_dw(feats, packed, g, resident, **faults)
    plain = K.gather_dw_plain(torch.from_numpy(feats), torch.from_numpy(packed),
                              torch.from_numpy(g)).double().numpy()
    assert got.shape == plain.shape == (packed.shape[0] * 3 * feats.shape[1], g.shape[1])
    _close(got, plain)
    _close(got, _pallas_dw(feats, packed, g) if pallas is None else pallas)
    return ran, total, chunks


# ---------------------------------------------------------------------------
# the cases
# ---------------------------------------------------------------------------

TM = dw_plan(16, 16)["TM"]


def _edge_rows(packed, v_in):
    """Tap rows at 0 and V_in − 1, pos kept monotone: f0 at pos 0 and fm at
    pos 1 (row 0), f0 and fp at pos V_in − 2 (rows V_in − 2 and V_in − 1),
    f0 at pos V_in − 1."""
    packed = np.clip(packed >> 3, 1, v_in - 2) * 8 + (packed & 7)
    packed[:, :2] = 0 * 8 + 2
    packed[:, 2:4] = 1 * 8 + 4
    packed[:, -6:-3] = (v_in - 2) * 8 + 2 + 1
    packed[:, -3:] = (v_in - 1) * 8 + 2
    return packed


def _last_row_only(packed, v_in):
    """Pair 0's flags (all three taps) only on the last row of each step,
    pair 1's (f0) only on the first; pos kept monotone."""
    packed = packed.copy()
    packed[0] = np.clip(packed[0] >> 3, 1, v_in - 2) * 8
    packed[1] = np.minimum(packed[1] >> 3, v_in - 1) * 8
    packed[0, TM - 1::TM] += 7
    packed[1, ::TM] += 2
    return packed


DW_CASES = {
    **GEMM_CASES,
    **WIDE_CASES,
    "cout_5x8": functools.partial(_gemm_case, 80, 300, 5, 8),
    "edge_rows": functools.partial(_gemm_case, 81, 2 * TM + 9, 32, 16, edit=_edge_rows),
    "pair_no_flag": functools.partial(_gemm_case, 82, 300, 16, 32, edit=_pair_no_flag),
    "v_out_ragged": functools.partial(_gemm_case, 83, 5 * TM + 37, 16, 16, density=0.1),
    "last_row_only": functools.partial(_gemm_case, 84, 3 * TM, 16, 16, edit=_last_row_only),
}


def dw_case(name):
    """(features, packed, g) of a case: its features and rulebook, and a
    gradient [V_out, O] from its seed."""
    feats, packed, w = DW_CASES[name]()
    rs = np.random.RandomState(list(DW_CASES).index(name) + 500)
    g = rs.randn(packed.shape[1], w.shape[1]).astype(np.float32)
    return feats, packed, g


@functools.lru_cache(maxsize=None)
def pallas_of_case(name):
    return _pallas_dw(*dw_case(name))


# a chunk a step (blocks for a card of 132 SMs with 2 blocks each) and one
# chunk of every step (a card of one resident block)
RESIDENT = {"132x2": 264, "one": 1}


def test_cases_are_planted():
    f, p, g = dw_case("edge_rows")
    v_in = f.shape[0]
    pos, fl = p >> 3, p & 7
    rows0 = np.stack([pos - 1, pos, pos + ((fl >> 1) & 1)], -1)
    on = np.stack([(fl >> 2) & 1, (fl >> 1) & 1, fl & 1], -1).astype(bool)
    assert (rows0[on] == 0).any() and (rows0[on] == v_in - 1).any()
    assert ((p[:, -6:-3] & 3) == 3).all()  # fp at pos + f0 = V_in − 1
    assert not (dw_case("pair_no_flag")[1][4] & 7).any()
    assert dw_case("v_out_ragged")[1].shape[1] % TM != 0
    f, p, g = dw_case("cout_5x8")
    assert (f.shape[1], g.shape[1]) == (5, 8)
    p = dw_case("last_row_only")[1]
    assert ((p[0] & 7) != 0).sum() == p.shape[1] // TM
    assert all(((p[0, s * TM:(s + 1) * TM - 1] & 7) == 0).all() for s in range(p.shape[1] // TM))
    for name in DW_CASES:  # pos monotone per pair, as the rulebooks (the Pallas windows need it)
        assert (np.diff(DW_CASES[name]()[1] >> 3, axis=1) >= 0).all(), name


@pytest.mark.parametrize("resident", list(RESIDENT))
@pytest.mark.parametrize("name", list(DW_CASES))
def test_dw_schedule_on_case(name, resident):
    """The model's dW = plain = Pallas; every live step runs; with one
    resident block a chunk holds every step of the call."""
    feats, packed, g = dw_case(name)
    ran, total, chunks = check_dw(feats, packed, g, RESIDENT[resident], pallas_of_case(name))
    plan = dw_plan(K._width(feats.shape[1]), K._width(g.shape[1]))
    tiles = max(-(-packed.shape[1] // plan["TM"]), 1)
    assert total == tiles * packed.shape[0] * plan["CH"] * plan["OS"]
    if resident == "one" and packed.shape[0] * plan["CH"] * plan["OS"] >= plan["WAVES"]:
        assert chunks == -(-tiles // plan["MAX_STEPS"])  # every step in as few chunks as fit
    if name == "all_off":
        assert ran == 0
    if name in ("pair_no_flag", "tile_empty", "middle_only", "wide_tile_empty_128x256",
                "wide_pair_no_flag_16x256"):
        assert ran < total
    assert K.launches == NO_LAUNCHES  # CPU: plain versions


@pytest.mark.parametrize("kind,c,o", [("subm", 16, 16), ("strided", 16, 32), ("strided", 64, 128),
                                      ("strided_311", 128, 128), ("inverse", 32, 64)])
def test_dw_schedule_on_rulebooks(kind, c, o):
    """The model on the rulebooks the port builds: SubM, a (3,3,3) stride-2
    conv, the (3,1,1) conv (two flag-free pairs in each group of three) and
    a strided conv's inverse (P = 18)."""
    feats, coords, valid, shape = sites(8, bsz=2, n=150, cap=160, c=c, shape=(8, 12, 12))
    _, st_t = both_tensors(feats, coords, valid, shape)
    ks = (3, 1, 1) if kind == "strided_311" else (3, 3, 3)
    stride = (2, 1, 1) if kind == "strided_311" else (2, 2, 2)
    pad = (0, 0, 0) if kind == "strided_311" else (1, 1, 1)
    if kind == "subm":
        packed = K.build_monotone_rule9(st_t, 3)
    else:
        out = TS.spconv_downsample(st_t, torch.zeros(int(np.prod(ks)), c, 16), kernel_size=ks,
                                   stride=stride, padding=pad, max_out=200)
        if kind == "inverse":
            packed, _ = K.build_monotone_rule_strided_inverse(st_t, out.keys, out.spatial_shape,
                                                              ks, stride, pad)
        else:
            cc = out.coords
            packed = K.build_monotone_rule_strided(st_t, cc[:, 0], cc[:, 1], cc[:, 2], cc[:, 3],
                                                   out.valid, ks, stride, pad)
    packed = packed.numpy()
    v_in = 200 if kind == "inverse" else st_t.features.shape[0]
    rs = np.random.RandomState(10)
    f = rs.randn(v_in, c).astype(np.float32)
    g = rs.randn(packed.shape[1], o).astype(np.float32)
    assert (packed & 7).any()
    ran, total, _ = check_dw(f, packed, g, RESIDENT["132x2"])
    if kind == "strided_311":
        assert ran <= total // 3


def test_planted_blind_last_row_fails():
    """A skip rule that does not look at a step's last row skips pair 0's
    steps: the model rejects it; the kernel's rule holds on the same call."""
    feats, packed, g = dw_case("last_row_only")
    with pytest.raises(AssertionError, match="skipped"):
        model_dw(feats, packed, g, RESIDENT["one"], rule=runs_blind_last_row)
    check_dw(feats, packed, g, RESIDENT["one"], pallas_of_case("last_row_only"))


@pytest.mark.parametrize("name", ["width_32x32", "edge_rows"])
def test_planted_fp_at_pos_fails(name):
    """Tap 2 read at pos instead of pos + f0: the model's dW leaves the
    plain version's."""
    feats, packed, g = dw_case(name)
    assert ((packed & 3) == 3).any()  # fp with f0: the two rows differ
    with pytest.raises(AssertionError):
        check_dw(feats, packed, g, RESIDENT["132x2"], rows_of=tap_rows_fp_at_pos)


DW_WIDTHS = list(K.GEMM_CHANNELS)  # what the dW entry takes
WIDTHS = [(c, o) for c in DW_WIDTHS for o in DW_WIDTHS]


@pytest.mark.parametrize("c,o", WIDTHS, ids=[f"C{c}xO{o}" for c, o in WIDTHS])
def test_plan_fits_the_h100(c, o):
    """Each Plan's shared memory at its most rows fits a block's 227 KB, its
    warps tile dW and a step's rows as the Layout's asserts ask, and its
    accumulators and operand fragments fit the registers its launch bound
    leaves a thread."""
    plan = dw_plan(c, o)
    assert smem_bytes(plan, plan["MAX_STEPS"]) <= SMEM_LIMIT
    assert plan["TM"] % 32 == 0 and plan["MAX_STEPS"] >= 1
    assert c % plan["KC"] == 0 and plan["KC"] % 16 == 0
    assert plan["ON"] == min(o, 128) and plan["OS"] * plan["ON"] == o
    if 256 in (c, o):  # the 128-wide block: the plan at 128 but for its channel and column blocks
        small = dw_plan(min(c, 128), min(o, 128))
        assert {k: v for k, v in plan.items() if k not in ("C", "O", "CH", "OS", "WAVES")} == \
            {k: v for k, v in small.items() if k not in ("C", "O", "CH", "OS", "WAVES")}
    regs = min(255, REGS_PER_SM // (plan["THREADS"] * plan["MIN_BLOCKS"]))
    if plan["WG"]:  # a warpgroup per tap: one 64-channel block, m64nOk16 over O
        assert plan["WG"] == (c >= 64 and o >= 64) and plan["KC"] == 64 and o % 64 == 0
        assert plan["THREADS"] == 384 and plan["TM"] % 16 == 0
        assert plan["ACC"] + 16 <= regs, (plan["ACC"], regs)
        return
    assert plan["WM"] * plan["WN"] * plan["WK"] == 8
    assert plan["M"] % (16 * plan["WM"]) == 0 and o % (16 * plan["WN"]) == 0
    assert plan["KW"] % 16 == 0
    frags = plan["MT"] * 4 + plan["NT"] * 2
    assert plan["ACC"] + frags <= regs - 16, (plan["ACC"], frags, regs)


@pytest.mark.parametrize("v_out,n_pairs,c,resident", [
    (320000, 9, 16, 396), (320000, 9, 32, 264), (200000, 9, 64, 132), (120000, 9, 128, 132),
    (100000, 3, 128, 132), (30000, 9, 256, 132), (1, 9, 16, 264), (0, 9, 16, 264),
    (129, 18, 64, 132),
    (5000, 1, 16, 1), (2_000_000, 9, 16, 396)])
def test_row_chunks_cover_the_call(v_out, n_pairs, c, resident):
    """The chunks partition the call's tiles with no empty chunk and at
    most ROWS rows each, and fill the card WAVES times where the call has
    the tiles for it."""
    plan = dw_plan(c, c)
    chunks = row_chunks(plan, v_out, n_pairs, resident)
    tiles = max(-(-v_out // plan["TM"]), 1)
    steps = -(-tiles // chunks)
    assert 1 <= chunks <= tiles and steps <= plan["MAX_STEPS"]
    assert (chunks - 1) * steps < tiles <= chunks * steps
    per_chunk = n_pairs * plan["CH"] * plan["OS"]  # at least half the aim, or a block a tile
    assert 2 * chunks * per_chunk >= min(resident * plan["WAVES"], tiles * per_chunk)


def test_model_follows_the_kernel_source():
    """The rules the model mirrors are the source's: its step rule, tap
    rows, G rows, the warp split, the partials' order, the chunk formula
    and the shared memory."""
    src = SOURCE.read_text()
    for line in (
            "const bool on = ((fl >> (2 - tap)) & 1) && src >= 0 && src < v_in;",
            "const int src = tap == 0 ? pos - 1 : (tap == 1 ? pos : pos + ((fl >> 1) & 1));",
            "const bool on = (pk[r] & 7) != 0;",
            "const int any = __reduce_or_sync(0xffffffffu, v & 7);",
            "const int v = r < v_out ? packed[(size_t)p * v_out + r] : 0;",
            "cp_async16(g0 + dst, on ? g + (grow + r) * O + col0 + vc * 8 : g, on ? 16 : 0);",
            "const int p = blockIdx.x / L::CH, ch = blockIdx.x % L::CH, col0 = blockIdx.z * L::ON;",
            "const dim3 grid((unsigned)(n_pairs * L::CH), (unsigned)chunks, (unsigned)L::OS);",
            "const long long per_chunk = (long long)n_pairs * L::CH * L::OS;",
            "const int wk = warp / (L::WM * L::WN), wmn = warp % (L::WM * L::WN);",
            "const int m0 = (wmn / L::WN) * L::WTM, n0 = (wmn % L::WN) * L::WTN, k0 = wk * L::KW;",
            "for (int w = 1; w < L::WK; ++w) {",
            "const int row = (p * 3 + m / L::KC) * C + ch * L::KC + m % L::KC;",
            "for (int k = 1; k < chunks; ++k) {",
            "return L::BODY_BYTES + (size_t)steps * (L::TM + 2) * 4 + 16 + (L::WGMMA ? 1024 : 0);",
            "const int dst = L::WGMMA ? tap * L::TM * 128 + r * 128 + ((cv ^ (r & 7)) << 4)",
            "const uint32_t a_tap = a_base + (threadIdx.x / 128) * L::TM * 128;",
            "dst + ((size_t)(p * 3 + warp / 4) * C + ch * L::KC + m) * O + col0 + (lane & 3) * 2;",
            "*reinterpret_cast<float4*>(dst + (size_t)row * O + col0 + c) = sum;",
            "long long n = ((long long)resident * P::WAVES + per_chunk - 1) / per_chunk;",
            "const long long fewest = (tiles + L::MAX_STEPS - 1) / L::MAX_STEPS;",
            "const long long steps = (tiles + n - 1) / n;",
            "*chunks = (int)((tiles + steps - 1) / steps);"):
        assert line in src, line
    assert "atomicAdd" not in src
    members = [m for m, _ in plan_lines(src)]
    assert members == ["TM", "ON", "KC", "WG", "STAGES", "WM", "WN", "WK", "ROWS", "WAVES",
                       "MIN_BLOCKS"]


def test_c_eval():
    env = {"C": 64, "O": 128, "WM": 4}
    assert _c_eval("O < 64 ? 1 : (O / 32 < 8 / WM ? O / 32 : 8 / WM)", env) == 2
    assert _c_eval("C == 16 && O <= 64 ? 3 : 2", env) == 2
    assert _c_eval("C < 64 ? C : 64", {"C": 32}) == 32
    assert _c_eval("!(C >= 64) || O % 3 == 2", env) == 1
