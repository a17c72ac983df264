"""The port stands alone: efg_tpu_torch and chip_smoke.py import neither
jax, flax nor any module of efg_tpu, in their source and at run time."""

import ast
import json
import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "efg_tpu")


def _forbidden(module: str) -> bool:
    return any(module == f or module.startswith(f + ".") for f in FORBIDDEN)


def _imported_modules(tree: ast.AST):
    """Every module an import statement, `__import__` or
    `importlib.import_module` with a literal name brings in."""
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module
            yield from (f"{node.module}.{a.name}" for a in node.names)
        elif isinstance(node, ast.Call) and node.args and isinstance(node.args[0], ast.Constant):
            fn = node.func
            name = fn.attr if isinstance(fn, ast.Attribute) else getattr(fn, "id", "")
            if name in ("__import__", "import_module") and isinstance(node.args[0].value, str):
                yield node.args[0].value


def test_sources_import_no_jax_nor_efg_tpu():
    files = sorted((ROOT / "efg_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) > 20
    bad = [
        f"{f.relative_to(ROOT)}: {m}"
        for f in files
        for m in _imported_modules(ast.parse(f.read_text(), str(f)))
        if _forbidden(m)
    ]
    assert not bad, bad
    assert not _forbidden("efg_tpu_torch.ops") and _forbidden("efg_tpu.ops")


def test_importing_every_port_module_loads_no_jax():
    code = """
import json, pkgutil, importlib, sys
import efg_tpu_torch
import importlib.util, pathlib
names = [m.name for m in pkgutil.walk_packages(efg_tpu_torch.__path__, "efg_tpu_torch.")]
for name in names:
    importlib.import_module(name)
# the experiments' net.py files are loaded by file path, as the CLI does
root = pathlib.Path(efg_tpu_torch.__file__).parent
nets = sorted(str(p.relative_to(root)) for p in (root / "playground").rglob("net.py"))
for i, rel in enumerate(nets):
    spec = importlib.util.spec_from_file_location(f"experiment_net_{i}", root / rel)
    spec.loader.exec_module(importlib.util.module_from_spec(spec))
print(json.dumps({"modules": names, "nets": nets, "loaded": sorted(sys.modules)}))
"""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = str(ROOT)
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env, capture_output=True,
                         text=True, timeout=300, check=True)
    res = json.loads(out.stdout.strip().splitlines()[-1])
    for name in ("models.centerpoint", "ops.cuda.sparse_kernels", "ops.gaussian",
                 "solver.optimizers", "solver.schedulers", "engine.trainer", "engine.hooks",
                 "config.config", "data.builder", "data.prefetcher", "data.datasets.synthetic",
                 "data.processors.extend_3d", "data.samplers.dataset_sampler", "cli.main",
                 "utils.events", "utils.logger", "evaluator.build", "evaluator.evaluator",
                 "evaluator.det3d_metrics", "evaluator.waymo_official",
                 "evaluator.waymo_evaluator", "utils.distributed", "ops.iou_rotated",
                 "ops.matcher", "ops.box_attention", "models.voxel_detr", "models.conquer",
                 "geometry.box_ops_torch"):
        assert f"efg_tpu_torch.{name}" in res["modules"], name
    assert "playground/detection.3d/synthetic/centerpoint.synth.voxelnet/net.py" in res["nets"]
    assert "playground/detection.3d/synthetic/conquer.synth.res18/net.py" in res["nets"]
    for name in ("ops.nms2d", "modeling.backbones.resnet", "modeling.assigners.anchor_generator",
                 "models.fcos", "models.retinanet", "models.autoassign",
                 "data.processors.basic_2d", "data.datasets.coco", "data.image_io",
                 "evaluator.coco_eval_np", "evaluator.coco_evaluator"):
        assert f"efg_tpu_torch.{name}" in res["modules"], name
    for exp in ("synthetic/fcos.synth.res50", "synthetic/retinanet.synth.res50",
                "synthetic/autoassign.synth.res50", "coco/fcos/fcos.res50.fpn.coco.800size.1x"):
        assert f"playground/detection.2d/{exp}/net.py" in res["nets"], exp
    for name in ("ops.resize", "ops.ms_deform_attn", "modeling.backbones.swin",
                 "modeling.common.layers", "modeling.post_processing", "models.mask2former",
                 "evaluator.panoptic_evaluator", "utils.torch_import", "utils.jax_import"):
        assert f"efg_tpu_torch.{name}" in res["modules"], name
    # every playground experiment has the port's net.py at its path
    experiments = sorted(str(p.parent.relative_to(ROOT)) + "/net.py"
                         for p in (ROOT / "playground").rglob("config.yaml"))
    assert len(experiments) == 22 and sorted(res["nets"]) == experiments
    assert [m for m in res["loaded"] if _forbidden(m)] == []
    # image decoders are imported where an image is read or resized, not
    # with the modules
    assert [m for m in res["loaded"] if m.split(".")[0] in ("cv2", "PIL")] == []


def test_every_kernel_source_is_bound_and_built():
    """Each csrc/*.cu has C entries bound in sparse_kernels and is among the
    sources the build compiles; no source is left out."""
    from efg_tpu_torch.ops.cuda import sparse_kernels as K

    sources = sorted(p.stem for p in (ROOT / "efg_tpu_torch" / "csrc").glob("*.cu"))
    assert sources == sorted(K.KERNEL_SOURCES) == [
        "gather_dw", "gather_gemm", "gather_gemm_g3", "rank_flags", "rank_flags_hostwin",
        "rank_flags_seq4"]
    for stem in sources:
        text = (ROOT / "efg_tpu_torch" / "csrc" / f"{stem}.cu").read_text()
        for entry in K._SIGNATURES[stem]:
            assert f'extern "C" int {entry}(' in text, entry
    assert set(K.launches) == {
        "rank_flags", "gather_gemm", "gather_gemm_stacked", "gather_dw", "rank_flags_seq4",
        "rank_flags_hostwin", "gather_gemm_g3", "gather_gemm_g3_stacked", "gather_gemm_256",
        "gather_gemm_stacked_256", "gather_dw_256"}
