"""tools/port_kernel_sweep.py on the CPU: every plan it times names
`constexpr` lines that exist once each in the kernel source it edits, and
its library swap reaches the cache the kernel wrappers load from and
restores it; the parent's matcher wrapper loads under a name of its own,
and each thread plan of device_match.cu is a power of two that the
wrapper's plan reads back. tools/match_profile.py finds each of its
anchors once in device_match.cu, and reads the row of every Dijkstra
step. (The timing itself needs the card.)"""

import importlib.util
import re
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent


def _sweep():
    spec = importlib.util.spec_from_file_location(
        "port_kernel_sweep", ROOT / "tools" / "port_kernel_sweep.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


S = _sweep()
PLANS = ([("gather_gemm_g3", n, p) for n, p in S.G3_PLANS.items()]
         + [("rank_flags", n, p) for n, p in S.RANK_PLANS.items()]
         + [("gather_dw", n, p) for n, p in S.DW_PLANS.items()]
         + [("gather_gemm", n, p) for n, p in S.GEMM_PLANS.items()]
         + [("device_match", n, p) for n, p in S.MATCH_PLANS.items()])


@pytest.mark.parametrize("stem,name,lines", PLANS, ids=[f"{s}-{n}" for s, n, _ in PLANS])
def test_plan_names_one_source_line_per_member(stem, name, lines):
    src = (ROOT / "efg_tpu_torch" / "csrc" / f"{stem}.cu").read_text()
    got = S.plan_source(stem, name, lines)
    for member, expr in lines.items():
        assert len(re.findall(rf"constexpr \w+ {member} = [^;]+;", src)) == 1, member
        assert re.findall(rf"constexpr \w+ {member} = ([^;]+);", got) == [expr], member
    # nothing but the plan's statements changed
    unplanned = src
    for member in lines:
        unplanned = re.sub(rf"constexpr \w+ {member} = [^;]+;", "", unplanned)
        got = re.sub(rf"constexpr \w+ {member} = [^;]+;", "", got)
    assert got == unplanned


def test_plan_of_a_missing_member_fails():
    with pytest.raises(AssertionError, match="0 lines for NO_SUCH_MEMBER"):
        S.plan_source("gather_gemm_g3", "planted", {"NO_SUCH_MEMBER": "1"})


@pytest.mark.parametrize("held", [False, True])
def test_library_swap_reaches_the_wrappers_cache(held):
    from efg_tpu_torch.ops.cuda import build as B

    stem = "gather_gemm_g3"
    saved = B._LIBS.pop(stem, None)
    before = object()
    try:
        if held:
            B._LIBS[stem] = before
        swapped = object()
        with S.library(stem, swapped):
            assert B.load(stem, {}) is swapped
        assert (B._LIBS.get(stem) is before) if held else stem not in B._LIBS
    finally:
        B._LIBS.pop(stem, None)
        if saved is not None:
            B._LIBS[stem] = saved


@pytest.mark.parametrize("name", list(S.MATCH_PLANS))
def test_match_plan_threads(name, tmp_path):
    """A plan's source gives the wrapper's plan its threads: a power of two
    that holds the plan's kCols columns a thread (ConQueR's Q = 1000,
    Mask2Former's Q = 100), at most kMaxThreads, in a block of at least
    kStageThreads."""
    from efg_tpu_torch.ops.cuda import match_kernels as MK

    src = tmp_path / "device_match.cu"
    src.write_text(S.plan_source("device_match", name, S.MATCH_PLANS[name]))
    k = MK.source_constants(str(src))
    for q in (100, 1000):
        p = MK.plan(1, q, 100, str(src))
        t = p["threads"]
        assert t & (t - 1) == 0 and 32 <= t <= k["kMaxThreads"] <= 1024
        assert t * k["kCols"] >= q or t == k["kMaxThreads"]
        assert t == 32 or t // 2 * k["kCols"] < q
        assert p["block"] == max(t, k["kStageThreads"])


def test_parent_match_module_loads():
    """The parent's match_kernels.py loads from a checkout (here this one)
    as a module apart from the package's, with its own C signatures."""
    from efg_tpu_torch.ops.cuda import match_kernels as MK

    mod = S.parent_match_module(str(ROOT))
    assert mod is not MK and mod.__name__ == "parent_match_kernels"
    assert set(mod._SIGNATURES["device_match"]) >= {"efg_device_match", "efg_argmin_chain"}


def _profile():
    spec = importlib.util.spec_from_file_location("match_profile",
                                                  ROOT / "tools" / "match_profile.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_match_profile_anchors():
    """Every anchor once in the kernel source, each replaced by its timed
    form; the copy exports its cycle counts."""
    text = _profile().instrumented_source()
    assert text.count("clock64()") == 8 and 'extern "C" int efg_prof_get' in text


def test_match_profile_rows_read():
    """One row a Dijkstra step, the first the first valid row, every row
    read a valid one."""
    import numpy as np
    import torch

    rs = np.random.RandomState(0)
    cost = torch.from_numpy(rs.randint(0, 3, (12, 9)).astype(np.float32))
    valid = torch.from_numpy(rs.rand(9) < 0.7)
    P = _profile()
    rows = P.rows_read(cost, valid)
    shares = P.cache_shares(cost[None], valid[None])[0]
    assert rows[0] == int(valid.nonzero()[0]) and all(bool(valid[r]) for r in rows)
    assert shares["steps"] == len(rows) >= int(valid.sum())
    assert shares["first64"] == len(rows) and shares["first16"] <= len(rows)
