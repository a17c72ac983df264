"""nuScenes → SemanticKITTI-style sequence folders, devkit-free (a copy of
efg_tpu's `cli/data_preparation/nuscenes/nuscenes2kitti.py`). Per scene it
writes

    <out>/<scene_id>/velodyne/{000000..}.bin   float32 [x, y, z, remission]
    <out>/<scene_id>/labels/{..}.label         uint32 sem | (instance << 16)
    <out>/<scene_id>/poses.txt                 3×4 rows, relative to scan 0
    <out>/<scene_id>/calib.txt                 identity P0..P3/Tr (KITTI shape)
    <out>/<scene_id>/files_mapping.txt, lidar_tokens.txt

The nuScenes relational tables are plain JSON, parsed directly (as in
`create_data.py`); lidarseg/panoptic labels are attached when those tables
exist in the version dir.

    python -m efg_tpu_torch.cli.data_preparation.nuscenes.nuscenes2kitti \
        --root <nuscenes root> --out <dir> --version v1.0-mini
"""

from __future__ import annotations

import argparse
import json
import os
from typing import Dict

import numpy as np

from efg_tpu_torch.cli.data_preparation.nuscenes.create_data import _quat_to_rot, _transform

_CALIB_LINES = ["P0", "P1", "P2", "P3", "Tr"]
_IDENTITY_34 = "1 0 0 0 0 1 0 0 0 0 1 0"


def _load_json(root: str, version: str, name: str):
    path = os.path.join(root, version, f"{name}.json")
    if not os.path.exists(path):
        return None
    with open(path) as f:
        return json.load(f)


def convert_scenes(
    root: str,
    out_dir: str,
    version: str = "v1.0-mini",
    normalize_remission: bool = False,
    with_labels: bool = True,
) -> int:
    tables: Dict[str, Dict[str, dict]] = {}
    for name in ("scene", "sample", "sample_data", "ego_pose", "calibrated_sensor"):
        tables[name] = {r["token"]: r for r in _load_json(root, version, name)}
    # lidarseg / panoptic tables key on the sample_data token
    lidarseg = {r["sample_data_token"]: r for r in (_load_json(root, version, "lidarseg") or [])}
    panoptic = {r["sample_data_token"]: r for r in (_load_json(root, version, "panoptic") or [])}

    lidar_by_sample = {}
    for sd in tables["sample_data"].values():
        if "LIDAR_TOP" in sd["filename"] and sd["is_key_frame"]:
            lidar_by_sample[sd["sample_token"]] = sd

    n_scans = 0
    for scene in tables["scene"].values():
        seq_dir = os.path.join(out_dir, scene["name"][6:])  # strip "scene-"
        vel_dir = os.path.join(seq_dir, "velodyne")
        lab_dir = os.path.join(seq_dir, "labels")
        os.makedirs(vel_dir, exist_ok=True)
        os.makedirs(lab_dir, exist_ok=True)
        with open(os.path.join(seq_dir, "calib.txt"), "w") as f:
            f.writelines(f"{k}: {_IDENTITY_34}\n" for k in _CALIB_LINES)

        poses, mapping, tokens = [], [], []
        tok = scene["first_sample_token"]
        idx = 0
        while tok:
            sample = tables["sample"][tok]
            tok = sample["next"]
            sd = lidar_by_sample.get(sample["token"])
            if sd is None:
                continue
            scan = np.fromfile(os.path.join(root, sd["filename"]), dtype=np.float32)
            pts = scan.reshape(-1, 5)[:, :4].copy()
            if normalize_remission:
                lo, hi = pts[:, 3].min(), pts[:, 3].max()
                pts[:, 3] = (pts[:, 3] - lo) / max(hi - lo, 1e-12)
            pts.tofile(os.path.join(vel_dir, f"{idx:06d}.bin"))

            cs = tables["calibrated_sensor"][sd["calibrated_sensor_token"]]
            ego = tables["ego_pose"][sd["ego_pose_token"]]
            poses.append(
                _transform(ego["rotation"], ego["translation"])
                @ _transform(cs["rotation"], cs["translation"])
            )

            if with_labels and sd["token"] in lidarseg:
                sem = np.fromfile(
                    os.path.join(root, lidarseg[sd["token"]]["filename"]), dtype=np.uint8
                ).astype(np.uint32)
                if sd["token"] in panoptic:
                    pan = np.load(os.path.join(root, panoptic[sd["token"]]["filename"]))["data"]
                    inst = (pan % 1000).astype(np.uint32)
                else:
                    inst = np.zeros_like(sem)
                ((inst << 16) | sem).astype(np.uint32).tofile(
                    os.path.join(lab_dir, f"{idx:06d}.label")
                )

            mapping.append(os.path.join(root, sd["filename"]))
            tokens.append(sd["token"])
            idx += 1
            n_scans += 1

        if poses:
            ref = np.linalg.inv(poses[0])
            with open(os.path.join(seq_dir, "poses.txt"), "w") as f:
                f.writelines(
                    " ".join(str(v) for v in (ref @ p)[:3, :4].flatten()) + "\n"
                    for p in poses
                )
        with open(os.path.join(seq_dir, "files_mapping.txt"), "w") as f:
            f.writelines(m + "\n" for m in mapping)
        with open(os.path.join(seq_dir, "lidar_tokens.txt"), "w") as f:
            f.writelines(t + "\n" for t in tokens)
    return n_scans


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--root", required=True)
    p.add_argument("--out", required=True)
    p.add_argument("--version", default="v1.0-mini")
    p.add_argument("--normalize-remission", action="store_true")
    p.add_argument("--no-labels", action="store_true")
    args = p.parse_args()
    n = convert_scenes(
        args.root, args.out, args.version, args.normalize_remission, not args.no_labels
    )
    print(f"Converted {n} scans → {args.out}")


if __name__ == "__main__":
    main()
