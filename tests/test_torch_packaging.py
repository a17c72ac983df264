"""The port's package data: an installed efg_tpu_torch carries every file
its kernel build and its CLI read (the CUDA sources and the headers they
include, default.yaml, the experiments' net.py files)."""

import re
import tomllib
from pathlib import Path

from efg_tpu_torch.ops.cuda import build

ROOT = Path(__file__).resolve().parents[1]
PKG = ROOT / "efg_tpu_torch"


def _package_data():
    with open(ROOT / "pyproject.toml", "rb") as f:
        project = tomllib.load(f)
    return project, project["tool"]["setuptools"]["package-data"]["efg_tpu_torch"]


def _shipped(rel: str, globs) -> bool:
    # setuptools globs: "**" spans directories, "*" does not
    for g in globs:
        pattern = re.escape(g).replace(r"\*\*/", "(?:.*/)?").replace(r"\*", "[^/]*")
        if re.fullmatch(pattern, rel):
            return True
    return False


def test_kernel_sources_and_their_includes_are_shipped():
    _, globs = _package_data()
    sources = sorted(PKG.glob("csrc/*.cu")) + sorted(PKG.glob("csrc/*.cuh"))
    assert len(sources) >= 8
    for src in sources:
        assert _shipped(str(src.relative_to(PKG)), globs), src
        for inc in re.findall(r'#include\s+"([^"]+)"', src.read_text()):
            assert (src.parent / inc).is_file(), (src.name, inc)
            assert _shipped(str((src.parent / inc).relative_to(PKG)), globs), (src.name, inc)
    # every header the build hashes into a library's name is shipped
    hashed = sorted(build.CSRC.glob("*.cuh"))
    assert [h.name for h in hashed] == ["gather_gemm_core.cuh", "rank_walk.cuh"]
    assert all(_shipped(f"csrc/{h.name}", globs) for h in hashed)


def test_config_and_experiments_are_shipped_and_the_cli_is_a_script():
    project, globs = _package_data()
    assert _shipped("config/default.yaml", globs)
    nets = sorted(PKG.glob("playground/**/net.py"))
    assert nets and all(_shipped(str(n.relative_to(PKG)), globs) for n in nets)
    assert not _shipped("csrc/sub/x.cu", globs)
    assert project["project"]["scripts"]["efg_run_torch"] == "efg_tpu_torch.cli.main:main"
