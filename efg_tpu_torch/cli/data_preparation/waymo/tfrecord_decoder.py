"""Waymo TFRecord → per-frame pickle converter, self-contained (a copy of
efg_tpu's `cli/data_preparation/waymo/tfrecord_decoder.py`, its Python
record reader only: efg_tpu's native C++ record scan is not ported).

No `waymo_open_dataset` / TensorFlow: a minimal TFRecord reader plus a
protobuf wire-format decoder for the handful of `dataset.proto` fields the
pipeline needs, and a numpy port of the range-image → point-cloud math
(`waymo_open_dataset/utils/range_image_utils.py`):

    python -m efg_tpu_torch.cli.data_preparation.waymo.tfrecord_decoder \
        --root_path <root>/<split> --record_path '<dir>/*.tfrecord'

Outputs the pickle schema that `efg_tpu_torch/data/datasets/waymo.py`
consumes:
  lidar/seq_{i}_frame_{j}.pkl: {scene_name, frame_name, frame_id,
      lidars: {points_xyz [N,3] f32, points_feature [N,2] f32}}
  annos/seq_{i}_frame_{j}.pkl: {scene_name, frame_name, frame_id,
      veh_to_global [16] f64, objects: [{id, name, label, box[9],
      num_points, detection_difficulty_level, combined_difficulty_level,
      global_speed[2], global_accel[2]}]}

Field numbers follow the public `dataset.proto`/`label.proto` of
waymo-open-dataset.
"""

from __future__ import annotations

import argparse
import glob
import os
import pickle
import struct
import zlib
from typing import Dict, Iterator, List, Tuple

import numpy as np

# ---------------------------------------------------------------------------
# TFRecord container
# ---------------------------------------------------------------------------


_CRC32C_TABLE = None


def _crc32c(data: bytes) -> int:
    """Software CRC32C (Castagnoli), used by the record writer."""
    global _CRC32C_TABLE
    if _CRC32C_TABLE is None:
        tbl = []
        for i in range(256):
            c = i
            for _ in range(8):
                c = (0x82F63B78 ^ (c >> 1)) if (c & 1) else (c >> 1)
            tbl.append(c)
        _CRC32C_TABLE = tbl
    c = 0xFFFFFFFF
    for b in data:
        c = _CRC32C_TABLE[(c ^ b) & 0xFF] ^ (c >> 8)
    return c ^ 0xFFFFFFFF


def _masked_crc(data: bytes) -> int:
    c = _crc32c(data)
    return (((c >> 15) | (c << 17)) + 0xA282EAD8) & 0xFFFFFFFF


def read_tfrecord(path: str) -> Iterator[bytes]:
    """Yield record payloads. Layout per record: uint64 length, uint32
    masked-crc(length), payload, uint32 masked-crc(payload).

    The CRC fields are not checked (efg_tpu checks them only in its native
    scan, which is not ported): corruption surfaces as parse errors."""
    with open(path, "rb") as f:
        while True:
            header = f.read(8)
            if len(header) < 8:
                return
            (length,) = struct.unpack("<Q", header)
            f.read(4)
            payload = f.read(length)
            if len(payload) < length:
                return
            f.read(4)
            yield payload


def write_tfrecord(path: str, records: List[bytes]) -> None:
    """Writer with real masked CRC32C fields (valid TFRecord files)."""
    with open(path, "wb") as f:
        for payload in records:
            header = struct.pack("<Q", len(payload))
            f.write(header)
            f.write(struct.pack("<I", _masked_crc(header)))
            f.write(payload)
            f.write(struct.pack("<I", _masked_crc(payload)))


# ---------------------------------------------------------------------------
# protobuf wire format
# ---------------------------------------------------------------------------


def _read_varint(buf: bytes, pos: int) -> Tuple[int, int]:
    result = shift = 0
    while True:
        b = buf[pos]
        result |= (b & 0x7F) << shift
        pos += 1
        if not b & 0x80:
            return result, pos
        shift += 7


def parse_message(buf: bytes) -> Dict[int, List]:
    """field number → list of raw values (int for varint/fixed, bytes for
    length-delimited)."""
    fields: Dict[int, List] = {}
    pos = 0
    n = len(buf)
    while pos < n:
        tag, pos = _read_varint(buf, pos)
        fnum, wtype = tag >> 3, tag & 7
        if wtype == 0:  # varint
            val, pos = _read_varint(buf, pos)
        elif wtype == 1:  # fixed64
            val = struct.unpack_from("<Q", buf, pos)[0]
            pos += 8
        elif wtype == 2:  # length-delimited
            ln, pos = _read_varint(buf, pos)
            val = buf[pos : pos + ln]
            pos += ln
        elif wtype == 5:  # fixed32
            val = struct.unpack_from("<I", buf, pos)[0]
            pos += 4
        else:
            raise ValueError(f"unsupported wire type {wtype}")
        fields.setdefault(fnum, []).append(val)
    return fields


def _as_double(v) -> float:
    if isinstance(v, int):
        return struct.unpack("<d", struct.pack("<Q", v))[0]
    return float(v)


def _as_float(v) -> float:
    if isinstance(v, int):
        return struct.unpack("<f", struct.pack("<I", v))[0]
    return float(v)


def _packed_doubles(chunks: List) -> np.ndarray:
    out = []
    for c in chunks:
        if isinstance(c, bytes):
            out.append(np.frombuffer(c, "<f8"))
        else:
            out.append(np.asarray([_as_double(c)]))
    return np.concatenate(out) if out else np.zeros(0)


def _packed_floats(chunks: List) -> np.ndarray:
    out = []
    for c in chunks:
        if isinstance(c, bytes):
            out.append(np.frombuffer(c, "<f4"))
        else:
            out.append(np.asarray([_as_float(c)], np.float32))
    return np.concatenate(out) if out else np.zeros(0, np.float32)


def _packed_ints(chunks: List) -> List[int]:
    out = []
    for c in chunks:
        if isinstance(c, bytes):
            pos = 0
            while pos < len(c):
                v, pos = _read_varint(c, pos)
                out.append(v)
        else:
            out.append(int(c))
    return out


# --- dataset.proto / label.proto field numbers -----------------------------

FRAME = dict(context=1, timestamp_micros=2, pose=3, lasers=5, laser_labels=6)
CONTEXT = dict(name=1, laser_calibrations=3, stats=4)
STATS = dict(time_of_day=2, location=3)
TRANSFORM = dict(transform=1)
LASER_CALIB = dict(
    name=1, beam_inclinations=2, beam_inclination_min=3,
    beam_inclination_max=4, extrinsic=5,
)
LASER = dict(name=1, ri_return1=2, ri_return2=3)
RANGE_IMAGE = dict(range_image_compressed=2, range_image_pose_compressed=4)
MATRIX_FLOAT = dict(data=1, shape=2)
MATRIX_SHAPE = dict(dims=1)
LABEL = dict(
    box=1, metadata=2, type=3, id=4, detection_difficulty_level=5,
    num_lidar_points_in_box=7,
)
BOX = dict(center_x=1, center_y=2, center_z=3, width=4, length=5, height=6, heading=7)
METADATA = dict(speed_x=1, speed_y=2, accel_x=3, accel_y=4)

TOP_LIDAR = 1  # LaserName.TOP


def _get_scalar(fields, num, conv, default=0.0):
    return conv(fields[num][0]) if num in fields else default


def parse_matrix_float(buf: bytes) -> np.ndarray:
    f = parse_message(buf)
    data = _packed_floats(f.get(MATRIX_FLOAT["data"], []))
    dims = [1]
    if MATRIX_FLOAT["shape"] in f:
        sh = parse_message(f[MATRIX_FLOAT["shape"]][0])
        dims = _packed_ints(sh.get(MATRIX_SHAPE["dims"], []))
    return data.reshape(dims)


def parse_transform(buf: bytes) -> np.ndarray:
    f = parse_message(buf)
    return _packed_doubles(f.get(TRANSFORM["transform"], []))


# ---------------------------------------------------------------------------
# range image → points (numpy port of range_image_utils)
# ---------------------------------------------------------------------------


def compute_inclination(inc_min: float, inc_max: float, height: int) -> np.ndarray:
    """`range_image_utils.compute_inclination`: bin centers low→high."""
    return inc_min + (inc_max - inc_min) * (0.5 + np.arange(height)) / height


def range_image_to_points(
    ri: np.ndarray,  # [H, W, C] (range, intensity, elongation, [nlz])
    extrinsic: np.ndarray,  # [4, 4]
    inclinations: np.ndarray,  # [H] top row first (reversed beam order)
    pixel_pose: np.ndarray = None,  # [H, W, 6] (roll, pitch, yaw, x, y, z)
    frame_pose: np.ndarray = None,  # [4, 4]
) -> np.ndarray:
    """[N, 3+C-1]: xyz in vehicle frame + the remaining channels."""
    h, w = ri.shape[:2]
    r = ri[..., 0]
    mask = r > 0

    az_correction = np.arctan2(extrinsic[1, 0], extrinsic[0, 0])
    ratios = (np.arange(w, 0, -1) - 0.5) / w
    azimuth = (ratios * 2 - 1) * np.pi - az_correction  # [W]

    cos_i = np.cos(inclinations)[:, None]
    sin_i = np.sin(inclinations)[:, None]
    x = cos_i * np.cos(azimuth)[None, :] * r
    y = cos_i * np.sin(azimuth)[None, :] * r
    z = sin_i * r  # [H, W]
    pts = np.stack([x, y, z], axis=-1)  # sensor frame

    rot, tr = extrinsic[:3, :3], extrinsic[:3, 3]
    pts = pts @ rot.T + tr  # vehicle frame

    if pixel_pose is not None:
        # per-pixel vehicle→global, then global→vehicle of this frame
        roll, pitch, yaw = pixel_pose[..., 0], pixel_pose[..., 1], pixel_pose[..., 2]
        cr, sr = np.cos(roll), np.sin(roll)
        cp, sp = np.cos(pitch), np.sin(pitch)
        cy, sy = np.cos(yaw), np.sin(yaw)
        # R = Rz(yaw) @ Ry(pitch) @ Rx(roll)
        R = np.stack(
            [
                cy * cp, cy * sp * sr - sy * cr, cy * sp * cr + sy * sr,
                sy * cp, sy * sp * sr + cy * cr, sy * sp * cr - cy * sr,
                -sp, cp * sr, cp * cr,
            ],
            axis=-1,
        ).reshape(h, w, 3, 3)
        t = pixel_pose[..., 3:6]
        pts = np.einsum("hwij,hwj->hwi", R, pts) + t  # global
        inv = np.linalg.inv(frame_pose)
        pts = pts @ inv[:3, :3].T + inv[:3, 3]

    feats = ri[..., 1:]
    out = np.concatenate([pts, feats], axis=-1)
    return out[mask].astype(np.float32)


# ---------------------------------------------------------------------------
# frame decoding (mirrors reference decode_frame / decode_annos)
# ---------------------------------------------------------------------------


def decode_frame_bytes(payload: bytes, frame_id: int) -> Tuple[dict, dict]:
    """One Frame proto → (lidar pickle dict, annos pickle dict)."""
    frame = parse_message(payload)
    ctx = parse_message(frame[FRAME["context"]][0])
    scene = ctx.get(CONTEXT["name"], [b""])[0].decode()
    stats_f = (
        parse_message(ctx[CONTEXT["stats"]][0]) if CONTEXT["stats"] in ctx else {}
    )
    location = stats_f.get(STATS["location"], [b""])[0]
    tod = stats_f.get(STATS["time_of_day"], [b""])[0]
    location = location.decode() if isinstance(location, bytes) else ""
    tod = tod.decode() if isinstance(tod, bytes) else ""
    ts = frame.get(FRAME["timestamp_micros"], [0])[0]
    frame_name = f"{scene}_{location}_{tod}_{ts}"

    pose16 = parse_transform(frame[FRAME["pose"]][0])
    frame_pose = pose16.reshape(4, 4)

    calibs = {}
    for cb in ctx.get(CONTEXT["laser_calibrations"], []):
        cf = parse_message(cb)
        name = cf.get(LASER_CALIB["name"], [0])[0]
        beams = _packed_doubles(cf.get(LASER_CALIB["beam_inclinations"], []))
        calibs[name] = dict(
            beam_inclinations=beams,
            inc_min=_get_scalar(cf, LASER_CALIB["beam_inclination_min"], _as_double),
            inc_max=_get_scalar(cf, LASER_CALIB["beam_inclination_max"], _as_double),
            extrinsic=parse_transform(cf[LASER_CALIB["extrinsic"]][0]).reshape(4, 4),
        )

    xyz_all, feat_all = [], []
    lasers = sorted(
        (parse_message(lb) for lb in frame.get(FRAME["lasers"], [])),
        key=lambda lf: lf.get(LASER["name"], [0])[0],
    )
    for lf in lasers:
        name = lf.get(LASER["name"], [0])[0]
        cal = calibs[name]
        for ret_field in (LASER["ri_return1"], LASER["ri_return2"]):
            if ret_field not in lf:
                continue
            rf = parse_message(lf[ret_field][0])
            if RANGE_IMAGE["range_image_compressed"] not in rf:
                continue
            ri = parse_matrix_float(
                zlib.decompress(rf[RANGE_IMAGE["range_image_compressed"]][0])
            )
            h = ri.shape[0]
            if cal["beam_inclinations"].size:
                incl = cal["beam_inclinations"][::-1]
            else:
                incl = compute_inclination(cal["inc_min"], cal["inc_max"], h)[::-1]
            pixel_pose = fp = None
            if name == TOP_LIDAR and RANGE_IMAGE["range_image_pose_compressed"] in rf:
                pixel_pose = parse_matrix_float(
                    zlib.decompress(rf[RANGE_IMAGE["range_image_pose_compressed"]][0])
                )
                fp = frame_pose
            pts = range_image_to_points(ri, cal["extrinsic"], incl, pixel_pose, fp)
            xyz_all.append(pts[:, :3])
            feat_all.append(pts[:, 3:5])

    lidar = {
        "scene_name": scene,
        "frame_name": frame_name,
        "frame_id": frame_id,
        "lidars": {
            "points_xyz": np.concatenate(xyz_all) if xyz_all else np.zeros((0, 3), np.float32),
            "points_feature": np.concatenate(feat_all) if feat_all else np.zeros((0, 2), np.float32),
        },
    }

    # --- annotations -------------------------------------------------------
    ref_rot_inv = frame_pose[:3, :3].T  # global→ref rotation
    objects = []
    for oid, lb in enumerate(frame.get(FRAME["laser_labels"], [])):
        lf = parse_message(lb)
        bf = parse_message(lf[LABEL["box"]][0])
        box = {k: _get_scalar(bf, v, _as_double) for k, v in BOX.items()}
        mf = parse_message(lf[LABEL["metadata"]][0]) if LABEL["metadata"] in lf else {}
        speed = [
            _get_scalar(mf, METADATA["speed_x"], _as_double),
            _get_scalar(mf, METADATA["speed_y"], _as_double),
        ]
        accel = [
            _get_scalar(mf, METADATA["accel_x"], _as_double),
            _get_scalar(mf, METADATA["accel_y"], _as_double),
        ]
        num_pts = lf.get(LABEL["num_lidar_points_in_box"], [0])[0]
        difficulty = lf.get(LABEL["detection_difficulty_level"], [0])[0]
        # reference combined-difficulty logic (`waymo_decoder.py:170-183`)
        if difficulty == 0:
            combined = 1 if num_pts >= 5 else 2
        else:
            combined = difficulty
        ref_vel = ref_rot_inv @ np.array([speed[0], speed[1], 0.0])
        objects.append(
            {
                "id": oid,
                "name": lf.get(LABEL["id"], [b""])[0].decode(),
                "label": lf.get(LABEL["type"], [0])[0],
                "box": np.array(
                    [
                        box["center_x"], box["center_y"], box["center_z"],
                        box["length"], box["width"], box["height"],
                        ref_vel[0], ref_vel[1], box["heading"],
                    ],
                    np.float32,
                ),
                "num_points": num_pts,
                "detection_difficulty_level": difficulty,
                "combined_difficulty_level": combined,
                "global_speed": np.array(speed, np.float32),
                "global_accel": np.array(accel, np.float32),
            }
        )

    annos = {
        "scene_name": scene,
        "frame_name": frame_name,
        "frame_id": frame_id,
        "veh_to_global": pose16,
        "objects": objects,
    }
    return lidar, annos


def convert_record(fname: str, seq_idx: int, lidar_dir: str, anno_dir: str) -> int:
    n = 0
    for frame_id, payload in enumerate(read_tfrecord(fname)):
        lidar, annos = decode_frame_bytes(payload, frame_id)
        base = f"seq_{seq_idx}_frame_{frame_id}.pkl"
        with open(os.path.join(lidar_dir, base), "wb") as f:
            pickle.dump(lidar, f)
        with open(os.path.join(anno_dir, base), "wb") as f:
            pickle.dump(annos, f)
        n += 1
    return n


def main():
    ap = argparse.ArgumentParser(description="Waymo TFRecord converter (self-contained)")
    ap.add_argument("--root_path", required=True)
    ap.add_argument("--record_path", required=True, help="glob of .tfrecord files")
    args = ap.parse_args()

    lidar_dir = os.path.join(args.root_path, "lidar")
    anno_dir = os.path.join(args.root_path, "annos")
    os.makedirs(lidar_dir, exist_ok=True)
    os.makedirs(anno_dir, exist_ok=True)

    fnames = sorted(glob.glob(args.record_path))
    print(f"{len(fnames)} tfrecord files")
    total = 0
    for i, fname in enumerate(fnames):
        total += convert_record(fname, i, lidar_dir, anno_dir)
    print(f"decoded {total} frames")


if __name__ == "__main__":
    main()
