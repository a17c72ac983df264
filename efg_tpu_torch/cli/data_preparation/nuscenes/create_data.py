"""nuScenes offline data preparation: sweep-chained infos, devkit-free (a
copy of efg_tpu's `cli/data_preparation/nuscenes/create_data.py`).

The nuScenes relational tables (plain JSON) are parsed directly: `sample`,
`sample_data`, `ego_pose`, `calibrated_sensor`, `sample_annotation`,
`scene`, `category`, `instance` and the optional `attribute`. Out comes the
`infos_*.pkl` list that `nuScenesDetectionDataset` reads: per key frame the
LIDAR_TOP entry, its pose-chained sweeps and its annotations in the EFG box
convention (x, y, z, l, w, h, vx, vy, yaw in the key frame's lidar frame).

    python -m efg_tpu_torch.cli.data_preparation.nuscenes.create_data \
        --root <nuscenes root> --version v1.0-mini --nsweeps 10 --split train
"""

from __future__ import annotations

import argparse
import json
import os
import pickle
from typing import Dict, List

import numpy as np


def _quat_to_rot(q) -> np.ndarray:
    """nuScenes [w, x, y, z] quaternion → 3×3 rotation."""
    w, x, y, z = q
    return np.array(
        [
            [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
            [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
            [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
        ]
    )


def _transform(rotation, translation) -> np.ndarray:
    t = np.eye(4)
    t[:3, :3] = _quat_to_rot(rotation)
    t[:3, 3] = translation
    return t


def _load_tables(root: str, version: str) -> Dict[str, Dict[str, dict]]:
    tables = {}
    for name in ("sample", "sample_data", "ego_pose", "calibrated_sensor",
                 "sample_annotation", "scene", "category", "instance",
                 "attribute"):
        path = os.path.join(root, version, f"{name}.json")
        if name == "attribute" and not os.path.exists(path):
            tables[name] = {}  # optional table (absent in stripped dumps)
            continue
        with open(path) as f:
            rows = json.load(f)
        tables[name] = {r["token"]: r for r in rows}
    return tables


def build_infos(
    root: str,
    version: str = "v1.0-mini",
    nsweeps: int = 10,
    occ: bool = False,
    seg: bool = False,
):
    """occ/seg mirror the reference flags (`create_data.py:252-343`):
    occ attaches the per-sample occupancy GT path from
    `occupancy/annotations.json`; seg attaches the lidarseg record."""
    t = _load_tables(root, version)

    occ_ann = None
    if occ:
        with open(os.path.join(root, "occupancy", "annotations.json")) as f:
            occ_ann = json.load(f)["scene_infos"]
    lidarseg = {}
    if seg:
        path = os.path.join(root, version, "lidarseg.json")
        with open(path) as f:
            lidarseg = {r["sample_data_token"]: r for r in json.load(f)}

    # keyframe LIDAR_TOP sample_data per sample
    lidar_by_sample = {}
    for sd in t["sample_data"].values():
        if "LIDAR_TOP" in sd.get("channel", "") or "LIDAR_TOP" in sd["filename"]:
            if sd["is_key_frame"]:
                lidar_by_sample[sd["sample_token"]] = sd

    infos: List[dict] = []
    for sample in t["sample"].values():
        sd = lidar_by_sample.get(sample["token"])
        if sd is None:
            continue
        cs = t["calibrated_sensor"][sd["calibrated_sensor_token"]]
        pose = t["ego_pose"][sd["ego_pose_token"]]
        car_from_lidar = _transform(cs["rotation"], cs["translation"])
        global_from_car = _transform(pose["rotation"], pose["translation"])
        global_from_ref = global_from_car @ car_from_lidar
        ref_from_global = np.linalg.inv(global_from_ref)

        sweeps = []
        cur = sd
        ref_time = sd["timestamp"] * 1e-6
        while len(sweeps) < nsweeps - 1 and cur["prev"]:
            cur = t["sample_data"][cur["prev"]]
            cs_s = t["calibrated_sensor"][cur["calibrated_sensor_token"]]
            pose_s = t["ego_pose"][cur["ego_pose_token"]]
            global_from_cur = _transform(pose_s["rotation"], pose_s["translation"]) @ _transform(
                cs_s["rotation"], cs_s["translation"]
            )
            sweeps.append(
                {
                    "data_path": os.path.join(root, cur["filename"]),
                    "transform_matrix": ref_from_global @ global_from_cur,
                    "time_lag": ref_time - cur["timestamp"] * 1e-6,
                }
            )

        boxes, names, velocities, attrs = [], [], [], []
        for ann_token in sample["anns"]:
            ann = t["sample_annotation"][ann_token]
            # nuScenes anns carry 0 or 1 attribute; '' when none
            atoks = ann.get("attribute_tokens") or []
            attrs.append(
                t["attribute"].get(atoks[0], {}).get("name", "") if atoks else ""
            )
            # global → lidar frame
            center = ref_from_global[:3, :3] @ np.asarray(ann["translation"]) + ref_from_global[:3, 3]
            rot = ref_from_global[:3, :3] @ _quat_to_rot(ann["rotation"])
            yaw = np.arctan2(rot[1, 0], rot[0, 0])
            w, l, h = ann["size"]
            # velocity via finite differences over the annotation chain
            vel = np.zeros(2)
            prev_t, next_t = ann.get("prev"), ann.get("next")
            if prev_t and next_t:
                p = t["sample_annotation"][prev_t]
                n = t["sample_annotation"][next_t]
                dt = (
                    t["sample"][n["sample_token"]]["timestamp"]
                    - t["sample"][p["sample_token"]]["timestamp"]
                ) * 1e-6
                if dt > 0:
                    gv = (np.asarray(n["translation"]) - np.asarray(p["translation"])) / dt
                    vel = (ref_from_global[:3, :3] @ gv)[:2]
            # EFG convention: l along x (swap to y, −x happens at load)
            boxes.append([*center, l, w, h, *vel, yaw])
            inst = t["instance"][ann["instance_token"]]
            names.append(t["category"][inst["category_token"]]["name"])

        annotations = {
            "gt_boxes": np.asarray(boxes, np.float32).reshape(-1, 9),
            "gt_names": np.asarray(names),
            "gt_attrs": np.asarray(attrs),
        }
        if occ_ann is not None:
            scene_name = t["scene"][sample["scene_token"]]["name"]
            sample_occ = occ_ann.get(scene_name, {}).get(sample["token"])
            if sample_occ is not None:
                annotations["occ_path"] = os.path.join(
                    root, "occupancy", sample_occ["gt_path"]
                )
        if sd["token"] in lidarseg:
            annotations["lidarseg"] = lidarseg[sd["token"]]

        infos.append(
            {
                "sample_token": sample["token"],
                "LIDAR_TOP": {
                    "data_path": os.path.join(root, sd["filename"]),
                    "sweeps": sweeps,
                },
                "annotations": annotations,
            }
        )
    return infos


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--root", required=True)
    p.add_argument("--version", default="v1.0-mini")
    p.add_argument("--nsweeps", type=int, default=10)
    p.add_argument("--split", default="train")
    p.add_argument("--occ", action="store_true")
    p.add_argument("--seg", action="store_true")
    args = p.parse_args()
    infos = build_infos(args.root, args.version, args.nsweeps, occ=args.occ, seg=args.seg)
    out = os.path.join(
        args.root, f"infos_{args.split}_{args.nsweeps:02d}sweeps_withvelo_filterZero.pkl"
    )
    with open(out, "wb") as f:
        pickle.dump(infos, f)
    print(f"Wrote {len(infos)} infos → {out}")


if __name__ == "__main__":
    main()
