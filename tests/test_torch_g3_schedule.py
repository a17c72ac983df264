"""Port parity: the block schedule of the group-merged gather-GEMM.

`csrc/gather_gemm_g3.cu` (replaces efg_tpu's `_fwd_kernel_g3`) runs the
block of `gather_gemm_core.cuh` with its own step plan: a step is one
δz-group of three pairs with all their taps (K = 9·C) at C = 16 and at
C = 32 with O ≤ 32, else one pair with its three taps (K = 3·C); a step
runs when any row of the 128-row tile has a flag in any of its pairs, and
a group past the last pair reads its missing pairs as flag-free rows and
zero weights. A CUDA kernel cannot run here, so a numpy model of that
schedule builds each step's A tile as the kernel's copies fill it and is
held, on the hazard cases that efg_tpu's g3 gate (`use_g3`) admits and on
the rulebooks the port builds: every live tap is read by exactly one step
that runs, no step with a live tap is skipped, each running step's A tile
is the plain stacked taps' slice it writes, the skipped steps' slices are
zero, and the steps that run give `gather_gemm_plain`'s out in f64 at
1e-5·max|ref|. A planted wrong step rule fails the model. The kernel
itself is held against the plain versions on the card by chip_smoke.py
(phase `variant_kernels`, with GEMM_EDGE_CASES)."""

from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from efg_tpu_torch.ops import sparse as TS
from efg_tpu_torch.ops.cuda import sparse_kernels as K

from test_torch_sparse_gemm_cases import GEMM_CASES
from test_torch_sparse_kernels import both_tensors, sites

# one intra-op thread: the workers of the parallel test run share the cores,
# which torch's thread pool in each of them would oversubscribe
torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
SMEM_LIMIT = 232448  # dynamic shared memory a block may take on the H100
SM_SMEM = 233472  # shared memory of an SM; each resident block also holds 1 KB


def g3_plan(c, o, emit, group=False):
    """gather_gemm_g3.cu's Plan<C, O, EMIT> (TM, PAIRS, TAPS, KC, STAGES,
    PERSIST): as the source has it, δz-group steps for the stacked entry at
    C = 16 and gather_gemm.cu's steps elsewhere (a pair at C ≤ 32, a tap at
    C = 64), persistent blocks for the stacked entry at C = 16 and at
    C = O = 32 and the forward at C16·O32, C32·O64 and C64·O64; with
    `group`, δz-group
    steps wherever a two-slot ring of them fits (C = 16, and C = 32 at
    O ≤ 32; tools/port_kernel_sweep.py's plan "group")."""
    g = (emit and c == 16) or (group and (c == 16 or (c == 32 and o <= 32)))
    persist = ((c == 16 or (c == 32 and o == 32)) if emit
               else (c, o) in ((16, 32), (32, 64), (64, 64))) or group
    return dict(TM=128, PAIRS=3 if g else 1, TAPS=1 if c == 64 else 3, KC=c,
                STAGES=2 if g or c == 32 else 3, PERSIST=persist)


def smem_bytes(c, o, n_pairs, plan):
    """gather_gemm_core.cuh `smem_bytes`: the ring, then the rulebook, masks
    and step list of the pairs rounded up to whole groups (+1024 to align a
    wgmma ring)."""
    ks = plan["PAIRS"] * plan["TAPS"] * plan["KC"]
    spp = 3 // plan["TAPS"] * (c // plan["KC"])
    wg = c >= 64 and o >= 64
    lda, ldw = (ks, o) if wg else (ks + 8, o + 8)
    ring = plan["STAGES"] * (plan["TM"] * lda + ks * ldw) * 2
    n_pp = -(-n_pairs // plan["PAIRS"]) * plan["PAIRS"]
    second = n_pp * plan["TM"] * 4 + 16 if plan["PERSIST"] else 0  # the next tile's rulebook
    return ring + n_pp * (plan["TM"] + 1 + spp) * 4 + 16 + second + (1024 if wg else 0)


def steps_of(n_pairs, c, plan):
    """The steps of a tile in order: (first pair, first tap, channel chunk),
    as gather_gemm_core.cuh's Step numbers them."""
    chunks = c // plan["KC"]
    spp = 3 // plan["TAPS"] * chunks
    n_groups = -(-n_pairs // plan["PAIRS"])
    out = []
    for e in range(n_groups * spp):
        j = e % spp
        t0, ch = (0, 0) if plan["TAPS"] == 3 else divmod(j, chunks)
        out.append((e // spp * plan["PAIRS"], t0, ch))
    return out


def runs_kernel(mask, p0, t0, plan):
    """The kernel's rule: OR of the masks of the step's pairs, then its taps."""
    m = int(np.bitwise_or.reduce(mask[p0:p0 + plan["PAIRS"]]))
    return m != 0 if plan["TAPS"] == 3 else bool((m >> (2 - t0)) & 1)


def runs_first_pair(mask, p0, t0, plan):
    """A planted fault: a group step that looks at its first pair only."""
    return runs_kernel(mask[:p0 + 1], p0, t0, plan)


def runs_mirrored_tap(mask, p0, t0, plan):
    """A planted fault: a tap step that reads its tap's bit mirrored."""
    m = int(np.bitwise_or.reduce(mask[p0:p0 + plan["PAIRS"]]))
    return m != 0 if plan["TAPS"] == 3 else bool((m >> t0) & 1)


def check_g3(feats, packed, w, plan, rule=runs_kernel):
    """Hold the model on one call (inputs rounded to bf16 as the plain
    version rounds them; products summed in f64). Returns (steps run, steps
    in all)."""
    v_in, c = feats.shape
    n_pairs, v_out = packed.shape
    o = w.shape[1]
    pairs, taps, kc, tm = plan["PAIRS"], plan["TAPS"], plan["KC"], plan["TM"]
    ks = pairs * taps * kc
    f, wd = (torch.from_numpy(a).to(torch.bfloat16).double().numpy() for a in (feats, w))
    n_pp = -(-n_pairs // pairs) * pairs
    pk = np.concatenate([packed, np.zeros((n_pp - n_pairs, v_out), packed.dtype)])
    w_rows = n_pairs * 3 * c
    _, st_ref = K.gather_gemm_stacked_plain(torch.from_numpy(feats), torch.from_numpy(packed),
                                            torch.from_numpy(w))
    st_ref = st_ref.double().numpy()
    pos = pk >> 3
    fl = np.stack([(pk >> 2) & 1, (pk >> 1) & 1, pk & 1], -1).astype(bool)
    rows = np.stack([pos - 1, pos, pos + fl[..., 1]], -1)
    live = fl & (rows >= 0) & (rows < v_in)  # [P', V, 3]
    out = np.zeros((v_out, o))
    ran = total = 0
    for row0 in range(0, v_out, tm):
        r1 = min(row0 + tm, v_out)
        mask = np.bitwise_or.reduce(pk[:, row0:r1] & 7, axis=1)
        cover = np.zeros((n_pp, 3, c), np.int32)  # reads of each (pair, tap, channel)
        written = np.zeros(3 * n_pairs * c, np.int32)  # stacked columns written, run or not
        for p0, t0, ch in steps_of(n_pairs, c, plan):
            col = (p0 * 3 + t0) * c + ch * kc
            k = np.arange(ks)
            pj, tap = k // (taps * kc), t0 + (k % (taps * kc)) // kc
            cc = ch * kc + k % kc
            real = col + k < 3 * n_pairs * c  # a missing pair's columns are not written
            written[(col + k)[real]] += 1
            total += 1
            tile = np.arange(row0, r1)[:, None]
            lv = live[p0 + pj[None, :], tile, tap[None, :]]  # [rows, K]
            if not rule(mask, p0, t0, plan):
                assert not lv.any(), "a step with a live tap skipped"
                assert not st_ref[row0:r1, (col + k)[real]].any()  # its zero columns
                continue
            ran += 1
            for j in range(pairs):
                for t in range(t0, t0 + taps):
                    cover[p0 + j, t, ch * kc:ch * kc + kc] += 1
            # the A tile as the copies fill it: each (row, K) one tap row's
            # channel, zero where the flag is off or the row is out of range
            src = rows[p0 + pj[None, :], tile, tap[None, :]]
            a = np.where(lv, f[np.clip(src, 0, v_in - 1), cc[None, :]], 0.0)
            np.testing.assert_array_equal(a[:, real], st_ref[row0:r1, (col + k)[real]])
            wk = np.where(((col + k) < w_rows)[:, None], wd[np.minimum(col + k, w_rows - 1)], 0.0)
            out[row0:r1] += a @ wk
        assert (written == 1).all(), "the steps do not partition the stacked row"
        need = live[:, row0:r1].any(axis=1)  # [P', 3]: taps some row of the tile reads
        assert (cover[np.broadcast_to(need[..., None], cover.shape)] == 1).all(), \
            "a live tap read not exactly once"
    ref = K.gather_gemm_plain(torch.from_numpy(f), torch.from_numpy(packed),
                              torch.from_numpy(wd)).numpy()
    np.testing.assert_allclose(out, ref, rtol=0, atol=1e-5 * max(np.abs(ref).max(initial=0), 1))
    return ran, total


def _admitted(name):
    feats, packed, w = GEMM_CASES[name]()
    return feats.shape[1] <= 64 and packed.shape[0] // 3 >= 2


G3_CASES = [n for n in GEMM_CASES if _admitted(n)]


def test_g3_cases_cover_the_gate():
    """The hazard cases the g3 gate admits hold every C of g3 at P = 9 and
    18, every O at each C, and a P that leaves the last group short."""
    shapes = {(GEMM_CASES[n]()[0].shape[1], GEMM_CASES[n]()[1].shape[0]) for n in G3_CASES}
    for c in (16, 32, 64):
        assert (c, 9) in shapes and (c, 18) in shapes, c
    assert (32, 7) in shapes
    widths = {(GEMM_CASES[n]()[0].shape[1], GEMM_CASES[n]()[2].shape[1]) for n in G3_CASES}
    assert {(c, o) for c in (16, 32, 64) for o in (16, 32, 64, 128)} <= widths


PLANS = [(False, False), (True, False), (False, True)]
PLAN_IDS = ["forward", "stacked", "group"]


@pytest.mark.parametrize("emit,group", PLANS, ids=PLAN_IDS)
@pytest.mark.parametrize("name", G3_CASES)
def test_g3_schedule_on_case(name, emit, group):
    """Every live tap read once by a running step, no live step skipped,
    each step's A tile the stacked slice it writes, out = plain; for the
    source's plans of both entries and for δz-group steps."""
    feats, packed, w = GEMM_CASES[name]()
    plan = g3_plan(feats.shape[1], w.shape[1], emit, group)
    ran, total = check_g3(feats, packed, w, plan)
    n_tiles = -(-packed.shape[1] // plan["TM"])
    spp = 3 // plan["TAPS"]
    assert total == n_tiles * -(-packed.shape[0] // plan["PAIRS"]) * spp
    if name == "all_off":
        assert ran == 0
    if name == "tile_empty":
        assert ran < total


@pytest.mark.parametrize("emit,group", PLANS, ids=PLAN_IDS)
@pytest.mark.parametrize("kind,c", [("subm", 16), ("subm", 32), ("subm", 64), ("strided", 16),
                                    ("strided_311", 32), ("inverse", 32), ("inverse", 64)])
def test_g3_schedule_on_rulebooks(kind, c, emit, group):
    """The model on the rulebooks the port builds: SubM (three groups), a
    (3,3,3) stride-2 conv, the (3,1,1) conv (one group, its two dummy pairs
    flag-free; the gate keeps g3 off it, the kernel takes it all the same)
    and a strided conv's inverse (P = 18)."""
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
    w = rs.randn(packed.shape[0] * 3 * c, 32).astype(np.float32)
    assert (packed & 7).any()
    assert packed.shape[0] == {"subm": 9, "strided": 9, "strided_311": 9, "inverse": 18}[kind]
    check_g3(f, packed, w, g3_plan(c, 32, emit, group))


@pytest.mark.parametrize("name", ["pairs_18_c16", "width_16x16"])
def test_planted_wrong_group_rule_fails(name):
    """A group step that runs by its first pair's mask alone skips live
    taps of its other two pairs: the model rejects it."""
    feats, packed, w = GEMM_CASES[name]()
    packed = packed.copy()
    packed[0::3] &= ~7  # the first pair of every group without a flag
    plan = g3_plan(feats.shape[1], w.shape[1], emit=True)
    assert plan["PAIRS"] == 3
    with pytest.raises(AssertionError, match="skipped"):
        check_g3(feats, packed, w, plan, rule=runs_first_pair)
    check_g3(feats, packed, w, plan)  # the kernel's rule holds on the same call


@pytest.mark.parametrize("name", ["width_64x64", "pairs_18"])
def test_planted_wrong_tap_rule_fails(name):
    """A tap step (C = 64) that reads its tap's flag bit mirrored skips the
    live fm or fp taps: the model rejects it (on the case with every fp
    flag cleared, so that the two bits differ in every tile)."""
    feats, packed, w = GEMM_CASES[name]()
    packed = packed & ~1
    plan = g3_plan(feats.shape[1], w.shape[1], emit=False)
    with pytest.raises(AssertionError, match="skipped"):
        check_g3(feats, packed, w, plan, rule=runs_mirrored_tap)
    check_g3(feats, packed, w, plan)


def test_model_follows_the_kernel_source():
    """The model's plan is gather_gemm_g3.cu's, its shared memory is what
    the source states and fits the card; the core's step numbering and
    active rule are the model's."""
    src = (ROOT / "efg_tpu_torch" / "csrc" / "gather_gemm_g3.cu").read_text()
    for line in ("bool GROUP = EMIT && C == 16;", "int TM = 128;", "int PAIRS = GROUP ? 3 : 1;",
                 "int TAPS = C == 64 ? 1 : 3;", "int KC = C;",
                 "int STAGES = GROUP || C == 32 ? 2 : 3;",
                 "int MIN_BLOCKS = !EMIT && C == 16 && O == 32 ? 4 : 2;"):
        assert f"static constexpr {line}" in src, line
    persist = " ".join(src.split("static constexpr bool PERSIST =")[1].split(";")[0].split())
    assert persist == ("EMIT ? C == 16 || (C == 32 && O == 32) : (C == 16 && O == 32) || "
                       "(C == 32 && O == 64) || (C == 64 && O == 64)"), persist
    note = " ".join(src.split("Shared memory per block (bytes) at P = 9")[1].split("Registers")[0]
                    .replace("//", " ").split())
    forward, stacked = note.split("Forward:")[1].split("Stacked:")
    for emit, header in ((False, forward), (True, stacked)):
        for c in (16, 32, 64):
            for o in (16, 32, 64, 128):
                plan = g3_plan(c, o, emit)
                b9, b18 = smem_bytes(c, o, 9, plan), smem_bytes(c, o, 18, plan)
                assert f"C{c}·O{o} {b9 // 1000} {b9 % 1000:03d}" in header, (emit, c, o, b9)
                assert b18 <= SMEM_LIMIT, (emit, c, o)
                assert smem_bytes(c, o, 18, g3_plan(c, o, emit, group=True)) <= SMEM_LIMIT
    core = (ROOT / "efg_tpu_torch" / "csrc" / "gather_gemm_core.cuh").read_text()
    for line in ("p0 = e / L::SPP * L::PAIRS;", "for (int j = 0; j < L::PAIRS; ++j) m |= s_mask[p0 + j];",
                 "return L::TAPS == 3 ? m != 0 : ((m >> (2 - t0)) & 1) != 0;",
                 "return (p0 * 3 + t0) * C + ch * Layout<C, O, EMIT>::KC;"):
        assert line in core, line
