"""COLMAP model readers and writers, binary and text (upnerf/data/colmap.py).

Numpy only. Buffer-resident `struct.unpack_from` decoding, one read per
file. Layouts follow COLMAP src/base/reconstruction.cc:

  cameras.bin : u64 count, then {i32 cam_id, i32 model_id, u64 w, u64 h,
                f64 params[num_params(model)]}
  images.bin  : u64 count, then {i32 img_id, f64 qvec[4], f64 tvec[3],
                i32 cam_id, cstring name, u64 n_pts2D,
                {f64 x, f64 y, i64 p3d_id}[n]}
  points3D.bin: u64 count, then {u64 p3d_id, f64 xyz[3], u8 rgb[3],
                f64 error, u64 track_len, {i32 img_id, i32 p2d_idx}[n]}

The writers let a scene be written from poses (chip_smoke.py's
Phototourism-layout scene) and models round-trip.
"""

from __future__ import annotations

import collections
import struct
from typing import Dict

import numpy as np

CameraModel = collections.namedtuple(
    "CameraModel", ["model_id", "model_name", "num_params"]
)
Camera = collections.namedtuple("Camera", ["id", "model", "width", "height", "params"])
Image = collections.namedtuple(
    "Image", ["id", "qvec", "tvec", "camera_id", "name", "xys", "point3D_ids"]
)
Point3D = collections.namedtuple(
    "Point3D", ["id", "xyz", "rgb", "error", "image_ids", "point2D_idxs"]
)

CAMERA_MODELS = {
    CameraModel(0, "SIMPLE_PINHOLE", 3),
    CameraModel(1, "PINHOLE", 4),
    CameraModel(2, "SIMPLE_RADIAL", 4),
    CameraModel(3, "RADIAL", 5),
    CameraModel(4, "OPENCV", 8),
    CameraModel(5, "OPENCV_FISHEYE", 8),
    CameraModel(6, "FULL_OPENCV", 12),
    CameraModel(7, "FOV", 5),
    CameraModel(8, "SIMPLE_RADIAL_FISHEYE", 4),
    CameraModel(9, "RADIAL_FISHEYE", 5),
    CameraModel(10, "THIN_PRISM_FISHEYE", 12),
}
CAMERA_MODEL_IDS = {m.model_id: m for m in CAMERA_MODELS}
CAMERA_MODEL_NAMES = {m.model_name: m for m in CAMERA_MODELS}


def read_cameras_binary(path: str) -> Dict[int, Camera]:
    with open(path, "rb") as f:
        buf = f.read()
    (num,) = struct.unpack_from("<Q", buf, 0)
    off = 8
    cameras = {}
    for _ in range(num):
        cam_id, model_id, w, h = struct.unpack_from("<iiQQ", buf, off)
        off += 24
        n = CAMERA_MODEL_IDS[model_id].num_params
        params = np.frombuffer(buf, "<f8", n, off)
        off += 8 * n
        cameras[cam_id] = Camera(
            id=cam_id,
            model=CAMERA_MODEL_IDS[model_id].model_name,
            width=w,
            height=h,
            params=np.array(params),
        )
    assert len(cameras) == num
    return cameras


def read_images_binary(path: str) -> Dict[int, Image]:
    with open(path, "rb") as f:
        buf = f.read()
    (num,) = struct.unpack_from("<Q", buf, 0)
    off = 8
    images = {}
    for _ in range(num):
        vals = struct.unpack_from("<idddddddi", buf, off)
        off += 64
        img_id, qw, qx, qy, qz, tx, ty, tz, cam_id = vals
        end = buf.index(b"\x00", off)
        name = buf[off:end].decode("utf-8")
        off = end + 1
        (n_pts,) = struct.unpack_from("<Q", buf, off)
        off += 8
        rec = np.frombuffer(buf, "<f8", n_pts * 3, off).reshape(n_pts, 3)
        off += 24 * n_pts
        xys = rec[:, :2].copy()
        point3D_ids = rec[:, 2].view("<i8").copy()
        images[img_id] = Image(
            id=img_id,
            qvec=np.array([qw, qx, qy, qz]),
            tvec=np.array([tx, ty, tz]),
            camera_id=cam_id,
            name=name,
            xys=xys,
            point3D_ids=point3D_ids,
        )
    return images


def read_points3d_binary(path: str) -> Dict[int, Point3D]:
    with open(path, "rb") as f:
        buf = f.read()
    (num,) = struct.unpack_from("<Q", buf, 0)
    off = 8
    points = {}
    for _ in range(num):
        p3d_id, x, y, z, r, g, b, err = struct.unpack_from("<QdddBBBd", buf, off)
        off += 43
        (track_len,) = struct.unpack_from("<Q", buf, off)
        off += 8
        track = np.frombuffer(buf, "<i4", track_len * 2, off).reshape(track_len, 2)
        off += 8 * track_len
        points[p3d_id] = Point3D(
            id=p3d_id,
            xyz=np.array([x, y, z]),
            rgb=np.array([r, g, b]),
            error=np.array(err),
            image_ids=track[:, 0].copy(),
            point2D_idxs=track[:, 1].copy(),
        )
    return points


def read_points3d_xyz(path: str) -> np.ndarray:
    """Only the (N, 3) xyz array (all the scene loader needs), without the
    per-point records."""
    with open(path, "rb") as f:
        buf = f.read()
    (num,) = struct.unpack_from("<Q", buf, 0)
    off = 8
    xyz = np.empty((num, 3), np.float64)
    for i in range(num):
        xyz[i] = struct.unpack_from("<ddd", buf, off + 8)
        (track_len,) = struct.unpack_from("<Q", buf, off + 43)
        off += 51 + 8 * track_len
    return xyz


# --- text models -------------------------------------------------------------
# cameras.txt / images.txt / points3D.txt: '#'-comment lines,
# whitespace-separated fields; images.txt has TWO lines per image (header,
# then the 2-D point track as x y point3D_id triples).


def _text_lines(path: str):
    with open(path, "r") as f:
        for line in f:
            line = line.strip()
            if line and not line.startswith("#"):
                yield line


def read_cameras_text(path: str) -> Dict[int, Camera]:
    cameras = {}
    for line in _text_lines(path):
        elems = line.split()
        cam_id = int(elems[0])
        cameras[cam_id] = Camera(
            id=cam_id,
            model=elems[1],
            width=int(elems[2]),
            height=int(elems[3]),
            params=np.array(elems[4:], np.float64),
        )
    return cameras


def read_images_text(path: str) -> Dict[int, Image]:
    images = {}
    with open(path, "r") as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            elems = line.split()
            # the track line follows the header immediately (may be empty
            # for images with no registered 2-D points)
            track = f.readline().split()
            rec = (
                np.array(track, np.float64).reshape(-1, 3)
                if track
                else np.zeros((0, 3))
            )
            img_id = int(elems[0])
            images[img_id] = Image(
                id=img_id,
                qvec=np.array(elems[1:5], np.float64),
                tvec=np.array(elems[5:8], np.float64),
                camera_id=int(elems[8]),
                name=elems[9],
                xys=rec[:, :2],
                point3D_ids=rec[:, 2].astype(np.int64),
            )
    return images


def read_points3d_text(path: str) -> Dict[int, Point3D]:
    points = {}
    for line in _text_lines(path):
        elems = line.split()
        p3d_id = int(elems[0])
        track = np.array(elems[8:], np.float64).reshape(-1, 2)
        points[p3d_id] = Point3D(
            id=p3d_id,
            xyz=np.array(elems[1:4], np.float64),
            rgb=np.array(elems[4:7], np.int64),
            error=np.array(float(elems[7])),
            image_ids=track[:, 0].astype(np.int32),
            point2D_idxs=track[:, 1].astype(np.int32),
        )
    return points


def write_cameras_text(cameras: Dict[int, Camera], path: str) -> None:
    with open(path, "w") as f:
        f.write("# Camera list with one line of data per camera:\n")
        f.write("#   CAMERA_ID, MODEL, WIDTH, HEIGHT, PARAMS[]\n")
        for cam in cameras.values():
            params = " ".join(repr(float(p)) for p in cam.params)
            f.write(f"{cam.id} {cam.model} {cam.width} {cam.height} {params}\n")


def write_images_text(images: Dict[int, Image], path: str) -> None:
    with open(path, "w") as f:
        f.write("# Image list with two lines of data per image:\n")
        f.write("#   IMAGE_ID, QW, QX, QY, QZ, TX, TY, TZ, CAMERA_ID, NAME\n")
        f.write("#   POINTS2D[] as (X, Y, POINT3D_ID)\n")
        for im in images.values():
            pose = " ".join(repr(float(v)) for v in [*im.qvec, *im.tvec])
            f.write(f"{im.id} {pose} {im.camera_id} {im.name}\n")
            f.write(
                " ".join(
                    f"{repr(float(x))} {repr(float(y))} {int(pid)}"
                    for (x, y), pid in zip(im.xys, im.point3D_ids)
                )
                + "\n"
            )


def write_points3d_text(points: Dict[int, Point3D], path: str) -> None:
    with open(path, "w") as f:
        f.write("# 3D point list with one line of data per point:\n")
        f.write(
            "#   POINT3D_ID, X, Y, Z, R, G, B, ERROR, "
            "TRACK[] as (IMAGE_ID, POINT2D_IDX)\n"
        )
        for p in points.values():
            xyz = " ".join(repr(float(v)) for v in p.xyz)
            rgb = " ".join(str(int(v)) for v in p.rgb)
            track = " ".join(
                f"{int(i)} {int(j)}" for i, j in zip(p.image_ids, p.point2D_idxs)
            )
            f.write(f"{p.id} {xyz} {rgb} {repr(float(p.error))} {track}\n")


# --- binary writers ----------------------------------------------------------


def write_cameras_binary(cameras: Dict[int, Camera], path: str) -> None:
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(cameras)))
        for cam in cameras.values():
            model = CAMERA_MODEL_NAMES[cam.model]
            f.write(
                struct.pack("<iiQQ", cam.id, model.model_id, cam.width, cam.height)
            )
            f.write(np.asarray(cam.params, "<f8").tobytes())


def write_images_binary(images: Dict[int, Image], path: str) -> None:
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(images)))
        for im in images.values():
            f.write(struct.pack("<idddddddi", im.id, *im.qvec, *im.tvec, im.camera_id))
            f.write(im.name.encode("utf-8") + b"\x00")
            n = len(im.point3D_ids)
            f.write(struct.pack("<Q", n))
            rec = np.empty((n, 3), "<f8")
            rec[:, :2] = im.xys
            rec[:, 2] = np.asarray(im.point3D_ids, "<i8").view("<f8")
            f.write(rec.tobytes())


def write_points3d_binary(points: Dict[int, Point3D], path: str) -> None:
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(points)))
        for p in points.values():
            f.write(
                struct.pack(
                    "<QdddBBBd", p.id, *p.xyz, *(int(c) for c in p.rgb), float(p.error)
                )
            )
            n = len(p.image_ids)
            f.write(struct.pack("<Q", n))
            track = np.empty((n, 2), "<i4")
            track[:, 0] = p.image_ids
            track[:, 1] = p.point2D_idxs
            f.write(track.tobytes())


def qvec2rotmat(qvec) -> np.ndarray:
    """Quaternion (w, x, y, z) -> rotation matrix."""
    w, x, y, z = qvec
    return np.array(
        [
            [1 - 2 * y**2 - 2 * z**2, 2 * x * y - 2 * w * z, 2 * z * x + 2 * w * y],
            [2 * x * y + 2 * w * z, 1 - 2 * x**2 - 2 * z**2, 2 * y * z - 2 * w * x],
            [2 * z * x - 2 * w * y, 2 * y * z + 2 * w * x, 1 - 2 * x**2 - 2 * y**2],
        ]
    )


def rotmat2qvec(R) -> np.ndarray:
    """Rotation matrix -> quaternion (w, x, y, z), w >= 0."""
    Rxx, Ryx, Rzx, Rxy, Ryy, Rzy, Rxz, Ryz, Rzz = np.asarray(R).flat
    K = (
        np.array(
            [
                [Rxx - Ryy - Rzz, 0, 0, 0],
                [Ryx + Rxy, Ryy - Rxx - Rzz, 0, 0],
                [Rzx + Rxz, Rzy + Ryz, Rzz - Rxx - Ryy, 0],
                [Ryz - Rzy, Rzx - Rxz, Rxy - Ryx, Rxx + Ryy + Rzz],
            ]
        )
        / 3.0
    )
    eigvals, eigvecs = np.linalg.eigh(K)
    qvec = eigvecs[[3, 0, 1, 2], np.argmax(eigvals)]
    if qvec[0] < 0:
        qvec *= -1
    return qvec
