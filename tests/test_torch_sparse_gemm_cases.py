"""Port parity: the sparse gather-GEMM on its hazard cases.

The plain versions of `fused_gather_gemm` and `gather_gemm_stacked`
(efg_tpu_torch.ops.cuda.sparse_kernels) against efg_tpu's Pallas
`fused_gather_gemm` (emit_stacked) in interpret mode, on small cases that
plant what the Hopper kernel `csrc/gather_gemm.cu` has to get right: V_out
around its 128-row tile, every (C, O) ≤ 128 it takes and the forward's
C128·O256 and C256·O256 (ConQueR's res4), P of 1, 7, 9 and 18, tiles and
calls without a flag, a lone tap, set flags on rows outside [0, V_in), and
pos = V_in. A numpy model of the kernel's block schedule (tiles of 128 rows,
steps of a pair, a tap or a tap's 64-channel part, steps that no row of a
tile needs skipped, O = 256 split over two blocks of 128 columns) is held
on the same cases and on the trunk's rulebooks: every set flag whose row
is in range is read by exactly one step that runs in each column block, no
such step is skipped, every output column is written by one block, every
element of the stacked taps is written exactly once, by the column block
of y = 0 (zeros for the skipped steps), and the steps that run give the
plain versions' results. Both gather-GEMM entries take C, O ≤ 256 (ConQueR's
res4 backward runs the stacked one at 256); the dW entry stops at 128
channels and says so.
chip_smoke.py keeps its own copy of the cases (GEMM_EDGE_CASES) and runs
them through both entries of the kernel on the card."""

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
    for name, make in GEMM_CASES.items():  # pos monotone per pair, as the rulebooks
        assert (np.diff(make()[1] >> 3, axis=1) >= 0).all(), name


def test_chip_smoke_cases_are_these():
    """chip_smoke.py's own copy of the cases, which it runs through both
    entries of gather_gemm.cu on the card, makes the same arrays."""
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    assert cs.GEMM_TM == GEMM_TM and list(cs.GEMM_EDGE_CASES) == list(GEMM_CASES)
    for name, make in GEMM_CASES.items():
        for a, b in zip(cs.GEMM_EDGE_CASES[name](), make()):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)


# ---------------------------------------------------------------------------
# numpy model of the kernel's block schedule
# ---------------------------------------------------------------------------


def test_model_follows_the_kernel_source():
    """The model's tile and step rules are the kernel's (its Plan)."""
    src = (ROOT / "efg_tpu_torch" / "csrc" / "gather_gemm.cu").read_text()
    assert int(re.search(r"constexpr int kTM = (\d+);", src).group(1)) == GEMM_TM
    for line in ("TAPS = C <= 32 ? 3 : 1;", "KC = C < 64 ? C : 64;", "CHUNKS = C / KC;",
                 "SPP = 3 / TAPS * CHUNKS;", "KS = TAPS * KC;", "OSPLIT = O > 128 ? 2 : 1;"):
        assert f"static constexpr int {line}" in src, line
    assert step_plan(256) == (1, 64, 4, 12) and column_blocks(256) == (2, 128)


def column_blocks(o):
    """(blocks a tile, columns of each) of gather_gemm.cu at width O."""
    split = 2 if o > 128 else 1
    return split, o // split


def step_plan(c):
    """(taps per step, channels of a tap per step, steps per tap, steps per
    pair) of gather_gemm.cu at width C."""
    taps = 3 if c <= 32 else 1
    kc = c if c < 64 else 64
    chunks = c // kc
    return taps, kc, chunks, 3 // taps * chunks


def block_schedule(packed, c):
    """For each tile of GEMM_TM output rows: (first row, [(pair, first tap,
    channel chunk, runs)] in step order). A step runs when any row of the
    tile has a flag among its taps (the OR of the pair's 3 flag bits for a
    whole-pair step)."""
    n_pairs, v_out = packed.shape
    taps, _, chunks, spp = step_plan(c)
    tiles = []
    for row0 in range(0, v_out, GEMM_TM):
        mask = np.bitwise_or.reduce(packed[:, row0:row0 + GEMM_TM] & 7, axis=1)
        steps = []
        for e in range(n_pairs * spp):
            p, j = divmod(e, spp)
            t0, ch = (0, 0) if taps == 3 else divmod(j, chunks)
            runs = mask[p] != 0 if taps == 3 else bool((mask[p] >> (2 - t0)) & 1)
            steps.append((p, t0, ch, runs))
        tiles.append((row0, steps))
    return tiles


def _tap_rows(packed, v_in):
    """rows [P, V, 3] of the three taps, and whether each is set and in range."""
    pos = packed >> 3
    fl = np.stack([(packed >> 2) & 1, (packed >> 1) & 1, packed & 1], -1).astype(bool)
    rows = np.stack([pos - 1, pos, pos + fl[..., 1]], -1)
    return rows, fl & (rows >= 0) & (rows < v_in)


def check_schedule(feats, packed, w):
    """Hold the model on one call (inputs rounded to bf16, as the plain
    version rounds them; the model sums in f64); returns (steps run, steps
    in all), counted over every block (a tile × a column block). With the
    stacked entry's writes: the block of the first columns writes each
    step's A tile (zeros for a skipped step) to its columns of the stacked
    row, the other column blocks none; every element is written once and
    the taps are the plain version's."""
    v_in, c = feats.shape
    n_pairs, v_out = packed.shape
    o = w.shape[1]
    taps, kc, _, _ = step_plan(c)
    _, width = column_blocks(o)
    feats, w = (torch.from_numpy(a).to(torch.bfloat16).double().numpy() for a in (feats, w))
    rows, live = _tap_rows(packed, v_in)
    out = np.zeros((v_out, o), np.float64)
    written = np.zeros((v_out, o), np.int32)
    stacked = np.zeros((v_out, n_pairs * 3 * c), np.float64)
    st_written = np.zeros((v_out, n_pairs * 3 * c), np.int32)
    wk = w.reshape(n_pairs, 3, c, -1).astype(np.float64)
    ran = total = 0
    for row0, steps in block_schedule(packed, c):
        r1 = min(row0 + GEMM_TM, v_out)
        for col0 in range(0, o, width):  # the blocks of one tile, side by side over O
            cols = slice(col0, col0 + width)
            taps_block = col0 == 0  # blockIdx.y == 0 writes the tile's stacked taps
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
                ran += 1
                cover[sl] += 1
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
            need = live[:, row0:r1].any(axis=1)  # [P, 3]: taps some row of the tile reads
            assert (cover[need] == 1).all(), "a live tap read not exactly once"
    assert (written == 1).all(), "an output element not written by exactly one block"
    assert (st_written == 1).all(), "a stacked tap element not written by exactly one block"
    ref = K.gather_gemm_plain(torch.from_numpy(feats).double(), torch.from_numpy(packed),
                              torch.from_numpy(w).double()).numpy()
    np.testing.assert_allclose(out, ref, rtol=0, atol=1e-5 * max(np.abs(ref).max(initial=0), 1))
    _, ref_st = K.gather_gemm_stacked_plain(torch.from_numpy(feats), torch.from_numpy(packed),
                                            torch.from_numpy(w))
    np.testing.assert_array_equal(stacked, ref_st.double().numpy())
    return ran, total


@pytest.mark.parametrize("name", list(GEMM_CASES))
def test_block_schedule_on_case(name):
    """Every live flag read once by a step that runs; no live step skipped;
    the steps that run give the plain version's out."""
    ran, total = check_schedule(*GEMM_CASES[name]())
    if name == "all_off":
        assert ran == 0
    if name == "middle_only":  # 3 of 27 taps, two 64-channel halves each
        assert (ran, total) == (2 * 3 * -(-300 // GEMM_TM), 54 * -(-300 // GEMM_TM))
    if name == "width_256x256":  # 12 steps a pair, each tile twice (two column blocks)
        assert total == 2 * 9 * 12 * -(-200 // GEMM_TM)


@pytest.mark.parametrize("entry", ["gather_gemm_stacked", "fused_gather_dw"])
@pytest.mark.parametrize("c,o", [(256, 256), (128, 256), (256, 64)])
def test_taps_entries_refuse_256(entry, c, o):
    """Only the dW entry refuses 256 channels (its kernel is ROADMAP queue 2
    item 1), on either device; the stacked entry takes them, as the forward
    does, and its out is the forward's."""
    f, p, w = (torch.from_numpy(a) for a in _gemm_case(c + o, 40, c, o))
    fwd = K.fused_gather_gemm(f, p, w)
    assert fwd.shape == (40, o)
    if entry == "fused_gather_dw":
        with pytest.raises(ValueError, match=r"at most 128 channels.*ROADMAP queue 2 item 1"):
            K.fused_gather_dw(f, p, torch.zeros(40, o))
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
    ran, total = check_schedule(f, packed, w)
    if kind == "strided_311":
        assert ran <= total // 3
