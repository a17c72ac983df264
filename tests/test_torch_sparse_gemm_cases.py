"""Port parity: the sparse gather-GEMM on its hazard cases.

The plain versions of `fused_gather_gemm` and `gather_gemm_stacked`
(efg_tpu_torch.ops.cuda.sparse_kernels) against efg_tpu's Pallas
`fused_gather_gemm` (emit_stacked) in interpret mode, on small cases that
plant what the Hopper kernel `csrc/gather_gemm.cu` has to get right: V_out
around its 128-row tile, every (C, O) ≤ 128 it takes and C128·O256 and
C256·O256 (ConQueR's res4), P of 1, 7, 9 and 18, tiles and calls without a
flag, a lone tap, set flags on rows outside [0, V_in), and pos = V_in. A
numpy model of the kernel's block schedule (tiles of 128 rows, one block
a tile over all O columns, 256 included; steps of a pair, a tap or a tap's
64-channel part; steps that no row of a tile needs skipped), its plan
evaluated from the source, is held on the same cases, on hazard cases at
256 channels (WIDE_CASES: ragged V_out, an empty tile, flags on rows −1
and V_in, a flag-free pair) and on the trunk's rulebooks, through both
entries: every set flag whose row is in range is read by exactly one step
that runs, no such step is skipped and no step without one runs, each
tile's taps are gathered once, every output element is written by one
block, every element of the stacked taps is written exactly once (zeros
for the skipped steps), and the steps that run give the plain versions'
results. Planted faults (two blocks a tile over O, the earlier plan at
O = 256; a flag-free step multiplied) fail the model, and each plan's
shared memory and registers fit the H100. Every entry, the dW one
included, takes C, O ≤ 256 and refuses wider on either device.
chip_smoke.py keeps its own copies of the cases (GEMM_EDGE_CASES,
WIDE_EDGE_CASES) and runs them through the kernels on the card."""

import functools
import importlib.util
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

from test_torch_sparse_kernels import NO_LAUNCHES, both_tensors, sites

# one intra-op thread: the workers of the parallel test run share the cores,
# which torch's thread pool in each of them would oversubscribe
torch.set_num_threads(1)

PK.set_interpret(True)

ROOT = Path(__file__).resolve().parents[1]
GEMM_TM = 128  # output rows per block of csrc/gather_gemm.cu (its kTM)


def _gemm_case(seed, v_out, c=32, o=32, n_pairs=9, v_in=None, density=0.3, edit=None):
    """A random rulebook whose set flags all name rows in [0, V_in), unless
    `edit(packed, v_in)` plants a hazard. No fm at pos = V_in: a padded
    sparse tensor's rulebook never has it, and efg_tpu's Pallas kernel reads
    that tap (row V_in − 1) as 0, where the contract reads the row."""
    rs = np.random.RandomState(seed)
    v_in = v_out if v_in is None else v_in
    pos = np.sort(rs.randint(0, v_in + 1, (n_pairs, v_out)), axis=1)
    fl = rs.rand(n_pairs, v_out, 3) < density
    fm = fl[..., 0] & (pos >= 1) & (pos < v_in)
    f0 = fl[..., 1] & (pos < v_in)
    fp = fl[..., 2] & (pos + f0 < v_in)
    packed = (pos * 8 + fm * 4 + f0 * 2 + fp).astype(np.int32)
    if edit is not None:
        packed = edit(packed, v_in).astype(np.int32)
    feats = rs.randn(v_in, c).astype(np.float32)
    w = (rs.randn(n_pairs * 3 * c, o) * 0.1).astype(np.float32)
    return feats, packed, w


def _tile_empty(packed, v_in):
    packed[:, GEMM_TM:2 * GEMM_TM] &= ~7  # the second tile has no flag
    return packed


def _all_off(packed, v_in):
    return packed & ~7


def _one_tap(packed, v_in):
    packed = packed & ~7
    r = int(np.argmax((packed[4] >> 3) < v_in))  # a row of pair 4 whose pos names a row
    packed[4, r] |= 2
    return packed


def _outside_rows(packed, v_in):
    """Set flags on rows −1 and V_in: pos 0 with fm (pair 0), pos V_in with
    f0 and fp (pair 1), pos V_in − 1 with all three (pair 2, fp at V_in)."""
    packed[0, :3] = 0 * 8 + 4 + 2
    packed[1, -3:] = v_in * 8 + 2 + 1
    pos2 = np.minimum(packed[2] >> 3, v_in - 1)
    packed[2] = pos2 * 8 + (packed[2] & 7)
    packed[2, -3:] = (v_in - 1) * 8 + 7
    return packed


def _pos_v_in_off(packed, v_in):
    packed[:, -40:] = v_in * 8  # pos = V_in, every flag off
    return packed


def _pair_no_flag(packed, v_in):
    packed = packed.copy()
    packed[4] &= ~7  # pair 4 has no flag in any row
    return packed


def _middle_only(packed, v_in):
    """Only the middle taps of pairs 3-5, as a (3, 1, 1) conv's rulebook:
    24 of the 27 taps empty in every tile."""
    keep = np.zeros_like(packed)
    keep[3:6] = 2
    return packed & (~7 | keep)


GEMM_CASES = {
    **{f"v_out_{v}": functools.partial(_gemm_case, 30 + i, v)
       for i, v in enumerate((1, GEMM_TM - 1, GEMM_TM, GEMM_TM + 1, 3 * GEMM_TM + 5))},
    **{f"width_{c}x{o}": functools.partial(_gemm_case, 40 + 4 * i + j, 200, c, o)
       for i, c in enumerate((16, 32, 64, 128)) for j, o in enumerate((16, 32, 64, 128))},
    "width_128x256": functools.partial(_gemm_case, 56, 200, 128, 256),
    "width_256x256": functools.partial(_gemm_case, 57, 200, 256, 256),
    "pairs_1": functools.partial(_gemm_case, 60, 300, 16, 16, n_pairs=1),
    "pairs_18": functools.partial(_gemm_case, 61, 300, 64, 32, n_pairs=18, v_in=150),
    "pairs_18_c16": functools.partial(_gemm_case, 68, 300, 16, 16, n_pairs=18),
    "pairs_18_c32": functools.partial(_gemm_case, 69, 300, 32, 32, n_pairs=18, v_in=250),
    "pairs_7": functools.partial(_gemm_case, 70, 260, 32, 16, n_pairs=7),
    "tile_empty": functools.partial(_gemm_case, 62, 3 * GEMM_TM + 5, edit=_tile_empty),
    "all_off": functools.partial(_gemm_case, 63, 300, edit=_all_off),
    "one_tap": functools.partial(_gemm_case, 64, 300, 128, 64, edit=_one_tap),
    "outside_rows": functools.partial(_gemm_case, 65, 300, 16, 32, v_in=250, edit=_outside_rows),
    "pos_v_in_off": functools.partial(_gemm_case, 66, 300, 64, 64, v_in=120, edit=_pos_v_in_off),
    "middle_only": functools.partial(_gemm_case, 67, 300, 128, 128, density=0.6,
                                     edit=_middle_only),
}


# hazards at 256 channels, one at each corner of the widths the entries
# take there (C256·O256, C128·O256, C256·O16, C16·O256), V_out ≤ 300
WIDE_CASES = {
    "wide_ragged_256x256": functools.partial(_gemm_case, 90, 2 * GEMM_TM + 37, 256, 256,
                                             density=0.2),
    "wide_tile_empty_128x256": functools.partial(_gemm_case, 91, 2 * GEMM_TM + 37, 128, 256,
                                                 edit=_tile_empty),
    "wide_outside_rows_256x16": functools.partial(_gemm_case, 92, 300, 256, 16, v_in=250,
                                                  edit=_outside_rows),
    "wide_pair_no_flag_16x256": functools.partial(_gemm_case, 93, 300, 16, 256,
                                                  edit=_pair_no_flag),
}


def _close(got, want):
    want = np.asarray(want, np.float32)
    np.testing.assert_allclose(np.asarray(got, np.float32), want, rtol=0,
                               atol=1e-4 * float(np.abs(want).max(initial=0.0)) + 1e-6)


@pytest.mark.parametrize("name", list(GEMM_CASES))
def test_plain_matches_pallas_on_case(name):
    """Both plain versions against efg_tpu's Pallas kernel with
    emit_stacked (its [P·3·C, vt] buffer transposed): taps bit for bit, out
    at 1e-4·max|ref| (both sum exact bf16 products in f32; only the order
    differs). The Pallas grid takes pairs in groups of three, so P = 1 is
    padded there with flag-off pairs and zero weights, which add nothing.
    Every case goes through both wrappers, the 256-wide ones included."""
    feats, packed, w = GEMM_CASES[name]()
    n_pairs, v_out = packed.shape
    c, o = feats.shape[1], w.shape[1]
    g = -(-n_pairs // 3) * 3
    pk3 = np.concatenate([packed, np.zeros((g - n_pairs, v_out), np.int32)])
    w3 = np.concatenate([w, np.zeros(((g - n_pairs) * 3 * c, o), np.float32)])
    want_out, want_st = PK.fused_gather_gemm(jnp.asarray(feats), jnp.asarray(pk3),
                                             jnp.asarray(w3), tile=128, emit_stacked=True)
    want_st = np.asarray(want_st, np.float32)[:n_pairs * 3 * c, :v_out].T
    f, p, wt = torch.from_numpy(feats), torch.from_numpy(packed), torch.from_numpy(w)
    K.reset_launches()
    got_out, got_st = K.gather_gemm_stacked(f, p, wt)
    got_fwd = K.fused_gather_gemm(f, p, wt)
    assert got_st.dtype == torch.bfloat16 and got_st.shape == (v_out, n_pairs * 3 * c)
    np.testing.assert_array_equal(got_st.float().numpy(), want_st)
    assert got_out.shape == got_fwd.shape == (v_out, o)
    _close(got_out, want_out)
    _close(got_fwd, want_out)
    assert K.launches == NO_LAUNCHES  # CPU: plain versions


def test_hazards_are_planted():
    """Each hazard case holds what its name says."""
    def flags(p):
        return p & 7

    _, p, _ = GEMM_CASES["tile_empty"]()
    assert not flags(p[:, GEMM_TM:2 * GEMM_TM]).any() and flags(p[:, :GEMM_TM]).any()
    assert not flags(GEMM_CASES["all_off"]()[1]).any()
    assert int(((GEMM_CASES["one_tap"]()[1] >> np.arange(3)[:, None, None]) & 1).sum()) == 1
    f, p, _ = GEMM_CASES["outside_rows"]()
    v_in = f.shape[0]
    assert ((p[0] >> 3) == 0).any() and (p[0, :3] & 4).all()  # row −1, flag set
    assert ((p[1, -3:] >> 3) == v_in).all() and (p[1, -3:] & 3 == 3).all()  # rows V_in, V_in+1
    f, p, _ = GEMM_CASES["pos_v_in_off"]()
    assert ((p[:, -40:] >> 3) == f.shape[0]).all() and not flags(p[:, -40:]).any()
    p = GEMM_CASES["middle_only"]()[1]
    assert not (p[:3] & 7).any() and not (p[6:] & 7).any() and not (p & 5).any()
    widths = set()
    for name, make in WIDE_CASES.items():
        f, p, w = make()
        widths.add((f.shape[1], w.shape[1]))
        assert p.shape[1] <= 300 and 256 in (f.shape[1], w.shape[1]), name
    assert widths == {(256, 256), (128, 256), (256, 16), (16, 256)}
    f, p, _ = WIDE_CASES["wide_ragged_256x256"]()
    assert p.shape[1] % GEMM_TM != 0
    p = WIDE_CASES["wide_tile_empty_128x256"]()[1]
    assert not flags(p[:, GEMM_TM:2 * GEMM_TM]).any() and flags(p[:, 2 * GEMM_TM:]).any()
    f, p, _ = WIDE_CASES["wide_outside_rows_256x16"]()
    assert (p[0, :3] & 4).all() and ((p[1, -3:] >> 3) == f.shape[0]).all()
    p = WIDE_CASES["wide_pair_no_flag_16x256"]()[1]
    assert not flags(p[4]).any() and flags(p[3]).any()
    for name, make in {**GEMM_CASES, **WIDE_CASES}.items():  # pos monotone per pair
        assert (np.diff(make()[1] >> 3, axis=1) >= 0).all(), name


def test_chip_smoke_cases_are_these():
    """chip_smoke.py's own copy of the cases, which it runs through both
    entries of gather_gemm.cu on the card, makes the same arrays."""
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    assert cs.GEMM_TM == GEMM_TM and list(cs.GEMM_EDGE_CASES) == list(GEMM_CASES)
    assert list(cs.WIDE_EDGE_CASES) == list(WIDE_CASES)
    theirs = {**cs.GEMM_EDGE_CASES, **cs.WIDE_EDGE_CASES}
    for name, make in {**GEMM_CASES, **WIDE_CASES}.items():
        for a, b in zip(theirs[name](), make()):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)


# ---------------------------------------------------------------------------
# numpy model of the kernel's block schedule
# ---------------------------------------------------------------------------

SOURCE = ROOT / "efg_tpu_torch" / "csrc" / "gather_gemm.cu"
SMEM_LIMIT = 232448  # dynamic shared memory a block may take on the H100 (227 KB)
REGS_PER_SM = 65536  # 32-bit registers of an SM, at most 255 a thread
GEMM_THREADS = 256  # gather_gemm_core.cuh kThreads
PAD = 8  # row padding of the staged bf16 tiles (mma.sync; gather_gemm_core.cuh kPad)


def _c_eval(expr: str, env: dict) -> int:
    """The value of a C integer constant expression (literals, names in
    `env`, ?:, || && ! == != < <= > >= + - * / %, parentheses)."""
    toks = re.findall(r"\d+|\w+|&&|\|\||==|!=|<=|>=|[-+*/%<>!?:()]", expr)
    pos = 0

    def peek():
        return toks[pos] if pos < len(toks) else None

    def take(t=None):
        nonlocal pos
        tok = toks[pos]
        assert t is None or tok == t, (expr, tok, t)
        pos += 1
        return tok

    def primary():
        t = take()
        if t == "(":
            v = ternary()
            take(")")
            return v
        if t == "!":
            return int(not primary())
        if t == "-":
            return -primary()
        if t.isdigit():
            return int(t)
        return {"true": 1, "false": 0}[t] if t in ("true", "false") else env[t]

    levels = [("||",), ("&&",), ("==", "!="), ("<", "<=", ">", ">="), ("+", "-"), ("*", "/", "%")]
    ops = {"||": lambda a, b: int(bool(a) or bool(b)), "&&": lambda a, b: int(bool(a) and bool(b)),
           "==": lambda a, b: int(a == b), "!=": lambda a, b: int(a != b),
           "<": lambda a, b: int(a < b), "<=": lambda a, b: int(a <= b),
           ">": lambda a, b: int(a > b), ">=": lambda a, b: int(a >= b),
           "+": lambda a, b: a + b, "-": lambda a, b: a - b, "*": lambda a, b: a * b,
           "/": lambda a, b: int(a / b), "%": lambda a, b: a - int(a / b) * b}

    def binary(level):
        if level == len(levels):
            return primary()
        v = binary(level + 1)
        while peek() in levels[level]:
            op = take()
            v = ops[op](v, binary(level + 1))
        return v

    def ternary():
        cond = binary(0)
        if peek() == "?":
            take("?")
            a = ternary()
            take(":")
            b = ternary()
            return a if cond else b
        return cond

    v = ternary()
    assert pos == len(toks), (expr, toks[pos:])
    return v


def gemm_plan(c: int, o: int, emit: bool, text: str = None) -> dict:
    """gather_gemm.cu's Plan<C, O, EMIT>, evaluated from its `constexpr`
    lines, and what gather_gemm_core.cuh's Layout derives from it."""
    text = SOURCE.read_text() if text is None else text
    body = text.split("struct Plan {", 1)[1].split("};", 1)[0]
    env = {"C": c, "O": o, "EMIT": int(emit), "kTM": GEMM_TM}
    for member, expr in re.findall(r"static constexpr (?:int|bool) (\w+) = ([^;]+);", body):
        env[member] = _c_eval(expr, env)
    wg = c >= 64 and o >= 64
    lag = env["LAG"] if wg else 0
    ks, tm = env["KS"], env["TM"]
    lda, ldw = (ks, o) if wg else (ks + PAD, o + PAD)
    wn = 1 if wg or o == 16 else 2
    wtm, wtn = tm // (8 // wn), o // wn
    env.update(WG=wg, LAG=lag, AHEAD=env["STAGES"] - 1 - lag,
               RING=env["STAGES"] * (tm * lda + ks * ldw) * 2, WN=wn, MT=wtm // 16, NT=wtn // 8)
    env["ACC"] = env["MT"] * env["NT"] * 4
    return env


def gemm_smem(plan: dict, n_pairs: int) -> int:
    """gather_gemm_core.cuh `smem_bytes` of a block per tile: the ring, the
    rulebook entries, masks and step list (+ 1024 to align a wgmma ring)."""
    return plan["RING"] + n_pairs * (plan["TM"] + 1 + plan["SPP"]) * 4 + 16 + \
        (1024 if plan["WG"] else 0)


def step_plan(c):
    """(taps per step, channels of a tap per step, steps per tap, steps per
    pair) of gather_gemm.cu at width C."""
    plan = gemm_plan(c, 16, False)
    return plan["TAPS"], plan["KC"], plan["CHUNKS"], plan["SPP"]


def runs_kernel(mask, t0, taps):
    """The kernel's rule (Step::active): a step runs when any row of the
    tile has a flag among its taps (the OR of the pair's 3 flag bits for a
    whole-pair step)."""
    return mask != 0 if taps == 3 else bool((mask >> (2 - t0)) & 1)


def runs_every_step(mask, t0, taps):
    """A planted fault: no step is skipped, so flag-free steps multiply."""
    return True


def block_schedule(packed, c, rule=runs_kernel):
    """For each tile of GEMM_TM output rows: (first row, [(pair, first tap,
    channel chunk, runs)] in step order)."""
    n_pairs, v_out = packed.shape
    taps, _, chunks, spp = step_plan(c)
    tiles = []
    for row0 in range(0, v_out, GEMM_TM):
        mask = np.bitwise_or.reduce(packed[:, row0:row0 + GEMM_TM] & 7, axis=1)
        steps = []
        for e in range(n_pairs * spp):
            p, j = divmod(e, spp)
            t0, ch = (0, 0) if taps == 3 else divmod(j, chunks)
            steps.append((p, t0, ch, rule(int(mask[p]), t0, taps)))
        tiles.append((row0, steps))
    return tiles


def _tap_rows(packed, v_in):
    """rows [P, V, 3] of the three taps, and whether each is set and in range."""
    pos = packed >> 3
    fl = np.stack([(packed >> 2) & 1, (packed >> 1) & 1, packed & 1], -1).astype(bool)
    rows = np.stack([pos - 1, pos, pos + fl[..., 1]], -1)
    return rows, fl & (rows >= 0) & (rows < v_in)


def check_schedule(feats, packed, w, emit, blocks=1, rule=runs_kernel):
    """Hold the model on one call through one entry (`emit`: the stacked
    one; inputs rounded to bf16, as the plain version rounds them; the model
    sums in f64); returns (steps run, steps in all), counted over every
    block. The kernel runs one block a tile over all O columns; `blocks` > 1
    plants blocks side by side over O, each staging the tile's steps (the
    first one writing the stacked taps). A step runs only where one of its
    taps is live in the tile, and each live tap of a tile is gathered once.
    With the stacked entry's writes: each step's A tile (zeros for a
    skipped step) lands in its columns of the stacked row; every element is
    written once and the taps are the plain version's."""
    v_in, c = feats.shape
    n_pairs, v_out = packed.shape
    o = w.shape[1]
    taps, kc, _, _ = step_plan(c)
    width = o // blocks
    feats, w = (torch.from_numpy(a).to(torch.bfloat16).double().numpy() for a in (feats, w))
    rows, live = _tap_rows(packed, v_in)
    out = np.zeros((v_out, o), np.float64)
    written = np.zeros((v_out, o), np.int32)
    stacked = np.zeros((v_out, n_pairs * 3 * c), np.float64)
    st_written = np.zeros((v_out, n_pairs * 3 * c), np.int32)
    wk = w.reshape(n_pairs, 3, c, -1).astype(np.float64)
    ran = total = 0
    for row0, steps in block_schedule(packed, c, rule):
        r1 = min(row0 + GEMM_TM, v_out)
        need = live[:, row0:r1].any(axis=1)  # [P, 3]: taps some row of the tile reads
        gathered = np.zeros((n_pairs, 3, c), np.int32)  # the tile's gathers, all its blocks
        for col0 in range(0, o, width):  # the blocks of one tile, side by side over O
            cols = slice(col0, col0 + width)
            taps_block = emit and col0 == 0  # blockIdx.y == 0 writes the tile's stacked taps
            cover = np.zeros((n_pairs, 3, c), np.int32)  # reads of each (pair, tap, channel)
            every = np.zeros((n_pairs, 3, c), np.int32)  # and of every step, run or not
            for p, t0, ch, runs in steps:
                sl = (p, slice(t0, t0 + taps), slice(ch * kc, ch * kc + kc))
                every[sl] += 1
                total += 1
                # the step's columns of a stacked row: (p·3 + t0)·C + ch·KC, K = taps·KC wide
                scol = (p * 3 + t0) * c + ch * kc
                scols = [scol + t * c + k for t in range(taps) for k in range(kc)] if taps == 3 \
                    else list(range(scol, scol + kc))
                if taps_block:
                    st_written[row0:r1, scols] += 1
                if not runs:
                    assert not live[p, row0:r1, t0:t0 + taps].any(), "a step with a live tap skipped"
                    continue
                assert need[p, t0:t0 + taps].any(), "a step without a live tap multiplied"
                ran += 1
                cover[sl] += 1
                gathered[sl] += 1
                for t in range(t0, t0 + taps):  # the step's product, as the kernel forms it
                    on = live[p, row0:r1, t]
                    a = np.where(on[:, None], feats[np.clip(rows[p, row0:r1, t], 0, v_in - 1)], 0)
                    out[row0:r1, cols] += (a[:, ch * kc:ch * kc + kc]
                                           @ wk[p, t, ch * kc:ch * kc + kc, cols])
                    if taps_block:  # the A tile, as it lands in shared memory
                        c0 = (p * 3 + t) * c + ch * kc
                        stacked[row0:r1, c0:c0 + kc] = a[:, ch * kc:ch * kc + kc]
            written[row0:r1, cols] += 1
            assert (every == 1).all(), "the steps do not partition the stacked row"
            assert (cover[need] == 1).all(), "a live tap read not exactly once"
        assert (gathered[need] == 1).all(), "a tile's taps gathered more than once"
    assert (written == 1).all(), "an output element not written by exactly one block"
    ref = K.gather_gemm_plain(torch.from_numpy(feats).double(), torch.from_numpy(packed),
                              torch.from_numpy(w).double()).numpy()
    np.testing.assert_allclose(out, ref, rtol=0, atol=1e-5 * max(np.abs(ref).max(initial=0), 1))
    if emit:
        assert (st_written == 1).all(), "a stacked tap element not written by exactly one block"
        _, ref_st = K.gather_gemm_stacked_plain(torch.from_numpy(feats), torch.from_numpy(packed),
                                                torch.from_numpy(w))
        np.testing.assert_array_equal(stacked, ref_st.double().numpy())
    return ran, total


ENTRIES = {"forward": False, "stacked": True}


@pytest.mark.parametrize("name", list(GEMM_CASES))
def test_block_schedule_on_case(name):
    """Both entries: every live flag read once by a step that runs; no live
    step skipped and no dead one run; the steps that run give the plain
    version's out (and taps)."""
    feats, packed, w = GEMM_CASES[name]()
    tiles = -(-packed.shape[1] // GEMM_TM)
    counts = {entry: check_schedule(feats, packed, w, emit) for entry, emit in ENTRIES.items()}
    assert counts["forward"] == counts["stacked"]
    for ran, total in counts.values():
        assert total == packed.shape[0] * step_plan(feats.shape[1])[3] * tiles
        if name == "all_off":
            assert ran == 0
        if name == "middle_only":  # 3 of 27 taps, two 64-channel halves each
            assert (ran, total) == (2 * 3 * tiles, 54 * tiles)
    if name == "width_256x256":  # 12 steps a pair, one block a tile
        assert counts["forward"][1] == 9 * 12 * tiles


@pytest.mark.parametrize("name", list(WIDE_CASES))
def test_block_schedule_on_wide_case(name):
    """The 256-wide hazards through both entries, one block a tile, each
    live tap gathered once. An empty tile or a flag-free pair runs no step
    of its own."""
    feats, packed, w = WIDE_CASES[name]()
    fwd = check_schedule(feats, packed, w, emit=False)
    assert check_schedule(feats, packed, w, emit=True) == fwd
    if "empty" in name or "no_flag" in name:
        assert fwd[0] < fwd[1]


@pytest.mark.parametrize("emit", [False, True], ids=["forward", "stacked"])
@pytest.mark.parametrize("name", ["width_256x256", "wide_tile_empty_128x256"])
def test_planted_two_blocks_fail(name, emit):
    """O = 256 split into two blocks of 128 columns (the earlier plan)
    gathers each tile's taps twice: the model rejects it."""
    feats, packed, w = {**GEMM_CASES, **WIDE_CASES}[name]()
    with pytest.raises(AssertionError, match="more than once"):
        check_schedule(feats, packed, w, emit, blocks=2)
    check_schedule(feats, packed, w, emit)


@pytest.mark.parametrize("name", ["middle_only", "wide_pair_no_flag_16x256"])
def test_planted_multiplied_skip_fails(name):
    """A schedule that runs a step none of whose taps the tile has (no
    skipping) is caught, though its products add zeros."""
    feats, packed, w = {**GEMM_CASES, **WIDE_CASES}[name]()
    with pytest.raises(AssertionError, match="without a live tap"):
        check_schedule(feats, packed, w, emit=False, rule=runs_every_step)


def test_model_follows_the_kernel_source():
    """The model's tile and step rules are the kernel's (its Plan evaluated
    from the source): one block a tile over all O columns; the core's step
    rule and ring schedule are the model's."""
    src = SOURCE.read_text()
    assert int(re.search(r"constexpr int kTM = (\d+);", src).group(1)) == GEMM_TM
    for line in ("int TAPS = C <= 32 ? 3 : 1;", "int KC = C < 64 ? C : 64;",
                 "int CHUNKS = C / KC;", "int SPP = 3 / TAPS * CHUNKS;", "int KS = TAPS * KC;",
                 "bool WIDE = O > 128;"):
        assert f"static constexpr {line}" in src, line
    assert step_plan(256) == (1, 64, 4, 12)
    assert "OSPLIT" not in src and "blockIdx.y" not in src
    core = (ROOT / "efg_tpu_torch" / "csrc" / "gather_gemm_core.cuh").read_text()
    for line in ("return L::TAPS == 3 ? m != 0 : ((m >> (2 - t0)) & 1) != 0;",
                 "cp_async_wait<L::AHEAD - 1>();", "const int nx = i + L::AHEAD;",
                 'asm volatile("wgmma.wait_group.sync.aligned %0;\\n" ::"n"(L::LAG) : "memory");',
                 "static constexpr int AHEAD = STAGES - 1 - LAG;",
                 "kernel<<<(unsigned)blocks, kThreads, smem, stream>>>("):
        assert line in core, line
    assert "blockIdx.y" not in core


PLAN_WIDTHS = [(c, o, e) for c in K.GEMM_CHANNELS for o in K.GEMM_CHANNELS for e in (False, True)]


@pytest.mark.parametrize("c,o,emit", PLAN_WIDTHS,
                         ids=[f"C{c}xO{o}-{'stacked' if e else 'forward'}" for c, o, e in PLAN_WIDTHS])
def test_plan_fits_the_h100(c, o, emit):
    """Each plan's shared memory at P = 18 fits a block's 227 KB, and its
    accumulators and operand fragments fit the registers its launch bound
    leaves a thread; at O = 256 both entries take all 256 columns in one
    block an SM (wgmma.m64n256k16, or mma.sync at C ≤ 32)."""
    plan = gemm_plan(c, o, emit)
    assert gemm_smem(plan, 18) <= SMEM_LIMIT, gemm_smem(plan, 18)
    regs = min(255, REGS_PER_SM // (GEMM_THREADS * plan["MIN_BLOCKS"]))
    frags = 16 if plan["WG"] else plan["MT"] * 4 + plan["NT"] * 2  # wgmma: descriptors
    assert plan["ACC"] + frags <= regs - 16, (plan["ACC"], frags, regs)
    assert plan["AHEAD"] >= 1 and plan["LAG"] in (0, 1)
    if o == 256:
        assert plan["MIN_BLOCKS"] == 1 and plan["LAG"] == (1 if c >= 64 else 0)
        assert plan["ACC"] == 128
    else:
        assert plan["LAG"] == 0 and plan["MIN_BLOCKS"] == 2


def test_shared_memory_note_is_the_plans():
    """The source's note of the shared memory at O = 256 and P = 9 is the
    plans', in either entry."""
    note = " ".join(SOURCE.read_text().split("At O = 256 (4 slots")[1].split("Registers")[0]
                    .replace("//", " ").split())
    for c in K.GEMM_CHANNELS:
        b = gemm_smem(gemm_plan(c, 256, False), 9)
        assert b == gemm_smem(gemm_plan(c, 256, True), 9)
        assert f"C{c} {b // 1000} {b % 1000:03d}" in note, (c, b)


@pytest.mark.parametrize("entry", ["gather_gemm_stacked", "fused_gather_dw"])
@pytest.mark.parametrize("c,o", [(256, 256), (128, 256), (256, 64)])
def test_taps_entries_refuse_256(entry, c, o):
    """Every entry takes 256 channels and refuses wider (272, 512) on either
    device, before it looks at the device: the stacked entry's out is the
    forward's, the dW entry's result is the plain version's."""
    f, p, w = (torch.from_numpy(a) for a in _gemm_case(c + o, 40, c, o))
    fwd = K.fused_gather_gemm(f, p, w)
    assert fwd.shape == (40, o)
    wide_f = torch.zeros(40, 272)
    for name, call in (("fused_gather_gemm", lambda: K.fused_gather_gemm(wide_f, p, w)),
                       ("gather_gemm_stacked", lambda: K.gather_gemm_stacked(f, p, torch.zeros(
                           w.shape[0], 512))),
                       ("fused_gather_dw", lambda: K.fused_gather_dw(f, p, torch.zeros(40, 272))),
                       ("fused_gather_dw", lambda: K.fused_gather_dw(wide_f.to("meta"), p,
                                                                    torch.zeros(40, o)))):
        with pytest.raises(ValueError, match=rf"{name} takes at most 256 channels"):
            call()
    if entry == "fused_gather_dw":
        g = torch.from_numpy(np.random.RandomState(c + o).randn(40, o).astype(np.float32))
        dw = K.fused_gather_dw(f, p, g)
        assert dw.shape == (27 * c, o) and torch.equal(dw, K.gather_dw_plain(f, p, g))
        assert (dw != 0).any()
        return
    out, stacked = K.gather_gemm_stacked(f, p, w)
    assert stacked.shape == (40, 27 * c) and stacked.dtype == torch.bfloat16
    assert torch.equal(out, fwd) or float((out - fwd).abs().max()) <= 1e-4 * float(fwd.abs().max())
    assert (stacked != 0).any()


@pytest.mark.parametrize("kind,c", [("subm", 16), ("subm", 64), ("strided", 128),
                                    ("strided_311", 128), ("inverse", 32), ("inverse", 128),
                                    ("subm", 256), ("strided_311", 256)])
def test_block_schedule_on_rulebooks(kind, c):
    """The model on the rulebooks the port builds for a trunk's convs: SubM,
    a (3,3,3) stride-2 conv, the (3,1,1) conv (two dummy pairs in each group
    of three: two thirds of its steps and more skipped) and a strided conv's
    inverse (P = 18). Skips are exact: the out of the steps that run is the
    plain version's."""
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
    rs = np.random.RandomState(9)
    f = rs.randn(v_in, c).astype(np.float32)
    w = rs.randn(packed.shape[0] * 3 * c, 16).astype(np.float32)
    assert (packed & 7).any()
    for emit in ENTRIES.values():
        ran, total = check_schedule(f, packed, w, emit)
        if kind == "strided_311":
            assert ran <= total // 3
