"""tools/port_kernel_sweep.py on the CPU: every plan it times names
`constexpr` lines that exist once each in the kernel source it edits, and
its library swap reaches the cache the kernel wrappers load from and
restores it. (The timing itself needs the card.)"""

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
         + [("gather_gemm", n, p) for n, p in S.GEMM_PLANS.items()])


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
