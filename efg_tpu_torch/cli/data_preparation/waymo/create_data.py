"""Waymo offline data preparation: infos + GT-crop database (a copy of
efg_tpu's `cli/data_preparation/waymo/create_data.py`).

Consumes the per-frame pickles that `tfrecord_decoder.py` writes (`lidar/`
+ `annos/` directories of each split) and writes
`infos_{split}_XXsweeps_sampled.pkl` plus, for the train split, the GT-crop
database (class-sharded directories of raw float32 point crops +
`..._infos.pkl`) in the format `WaymoDetectionDataset` and
`DatabaseSampling` read:

    python -m efg_tpu_torch.cli.data_preparation.waymo.create_data \
        --root <root> --split train --nsweeps 1 --gt-database
"""

from __future__ import annotations

import argparse
import os
import pickle

import numpy as np

from efg_tpu_torch.geometry import box_ops_np as G

CAT_NAMES = {1: "VEHICLE", 2: "PEDESTRIAN", 3: "SIGN", 4: "CYCLIST"}
# reference subsampling when building the GT database (`create_data.py:330-341`)
DB_KEEP_FRACTION = {"VEHICLE": 4, "PEDESTRIAN": 2, "CYCLIST": 1}


def _frame_files(root: str, split: str):
    d = os.path.join(root, split, "annos")
    return sorted(os.listdir(d)) if os.path.isdir(d) else []


def build_infos(root: str, split: str, nsweeps: int = 1):
    """One info dict per frame: token, lidar path, pose-chained sweeps,
    annotations (reference `_fill_infos`)."""
    infos = []
    files = _frame_files(root, split)
    by_seq = {}
    for f in files:
        seq = f.split("_frame_")[0]
        by_seq.setdefault(seq, []).append(f)

    for seq, frames in by_seq.items():
        poses = {}
        metas = {}
        for f in frames:
            with open(os.path.join(root, split, "annos", f), "rb") as fh:
                metas[f] = pickle.load(fh)
            poses[f] = np.asarray(metas[f].get("veh_to_global", np.eye(4))).reshape(4, 4)
        for i, f in enumerate(frames):
            anno = metas[f]
            objs = anno.get("objects", [])
            gt_boxes = np.asarray([o["box"] for o in objs], np.float32).reshape(-1, 9)
            info = {
                "path": os.path.join(split, "lidar", f),
                "anno_path": os.path.join(split, "annos", f),
                "token": f,
                "timestamp": anno.get("frame_id", i),
                "gt_boxes": gt_boxes,
                "gt_names": np.asarray([CAT_NAMES.get(o["label"], "UNKNOWN") for o in objs]),
                "difficulty": np.asarray(
                    [o.get("combined_difficulty_level", 0) for o in objs], np.int8
                ),
                "num_points_in_gt": np.asarray(
                    [o.get("num_points", -1) for o in objs], np.int64
                ),
                "sweeps": [],
            }
            ref_inv = np.linalg.inv(poses[f])
            for j in range(1, nsweeps):
                if i - j < 0:
                    break
                pf = frames[i - j]
                tm = ref_inv @ poses[pf]
                info["sweeps"].append(
                    {
                        "path": os.path.join(split, "lidar", pf),
                        "transform_matrix": tm,
                        "time_lag": 0.1 * j,
                    }
                )
            infos.append(info)
    return infos


def build_gt_database(root: str, infos, out_name: str, num_point_features: int = 5):
    """Crop per-object point clusters into the class-sharded database
    (reference `create_data.py:266-430`)."""
    db_root = os.path.join(root, out_name)
    os.makedirs(db_root, exist_ok=True)
    db_infos = {}
    counters = {}
    for info in infos:
        with open(os.path.join(root, info["path"]), "rb") as fh:
            obj = pickle.load(fh)
        points = np.concatenate(
            [obj["lidars"]["points_xyz"], obj["lidars"]["points_feature"]], axis=-1
        ).astype(np.float32)[:, :num_point_features]
        boxes = info["gt_boxes"]
        names = info["gt_names"]
        if len(boxes) == 0:
            continue
        b7 = boxes[:, [0, 1, 2, 3, 4, 5, 8]]
        inside = G.points_in_rbbox(points, b7)
        for i, name in enumerate(names):
            if name not in DB_KEEP_FRACTION:
                continue
            counters[name] = counters.get(name, 0) + 1
            if counters[name] % DB_KEEP_FRACTION[name] != 0:
                continue
            pts = points[inside[:, i]]
            if len(pts) == 0:
                continue
            pts = pts.copy()
            pts[:, :3] -= boxes[i, :3]
            shard = counters[name] % 10
            shard_dir = os.path.join(db_root, f"{name}_{shard}")
            os.makedirs(shard_dir, exist_ok=True)
            fn = f"{info['token']}_{name}_{i}.bin"
            with open(os.path.join(shard_dir, fn), "wb") as fh:
                fh.write(pts.tobytes())
            db_infos.setdefault(name, []).append(
                {
                    "name": name,
                    "path": os.path.join(out_name, f"{name}_{shard}", fn),
                    "box3d_lidar": boxes[i],
                    "num_points_in_gt": len(pts),
                    "difficulty": int(info["difficulty"][i]) if len(info["difficulty"]) > i else 0,
                }
            )
    with open(os.path.join(root, f"{out_name}_infos.pkl"), "wb") as fh:
        pickle.dump(db_infos, fh)
    return db_infos


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--root", required=True, help="dataset root with <split>/{lidar,annos}")
    p.add_argument("--split", default="train")
    p.add_argument("--nsweeps", type=int, default=1)
    p.add_argument("--gt-database", action="store_true")
    args = p.parse_args()

    infos = build_infos(args.root, args.split, args.nsweeps)
    out = os.path.join(args.root, f"infos_{args.split}_{args.nsweeps:02d}sweeps_sampled.pkl")
    with open(out, "wb") as fh:
        pickle.dump(infos, fh)
    print(f"Wrote {len(infos)} infos → {out}")

    if args.gt_database and args.split == "train":
        db = build_gt_database(
            args.root, infos, f"gt_database_train_{args.nsweeps:02d}sweeps_withvelo_sampled"
        )
        print({k: len(v) for k, v in db.items()})


if __name__ == "__main__":
    main()
