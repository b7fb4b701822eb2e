"""Episode stores: LAV-dataset-schema-compatible key/value frame storage.

The released LAV dataset is a directory of LMDB environments, one per
trajectory, with keys (reference basic_dataset.py:81-101):
    len                      int (frame count), town  str
    {tag}_{t:05d}            float32 buffers (lidar, loc, ori, bbox, nxp, ...)
    id_{t:05d}/type_{t:05d}  int32/uint8 buffers
    rgb_{i}_{t:05d} etc.     JPEG bytes;  sem_* grayscale PNG
    map_{ch}_{t:05d}         grayscale PNG BEV channel
    lidar_sem_{t:05d}        float32 painted semantics (written offline)

This module abstracts the byte store so the same datasets run on:
  * LMDBStore   — the real released dataset (requires the lmdb package)
  * DictStore   — in-memory, writable; unit tests + synthetic data
Image decode uses PIL (not cv2); decoded RGB order is RGB —
the reference decodes BGR with cv2 and flips to RGB at use sites
(seg_dataset.py:28), so end-to-end channel order matches.
"""

from __future__ import annotations

import io
import math
import os
from typing import Dict, List, Optional, Sequence

import numpy as np

try:
    import lmdb  # type: ignore
    _HAVE_LMDB = True
except Exception:  # pragma: no cover
    _HAVE_LMDB = False

from PIL import Image


class DictStore:
    """In-memory byte store with the LMDB get() interface; writable."""

    def __init__(self, data: Optional[Dict[bytes, bytes]] = None):
        self._d = data or {}

    def get(self, key: bytes) -> Optional[bytes]:
        return self._d.get(key)

    def put(self, key: bytes, value: bytes):
        self._d[key] = value


class LMDBStore:
    def __init__(self, path: str):
        if not _HAVE_LMDB:
            raise RuntimeError(
                "lmdb is not installed; use DictStore or "
                "convert episodes with lav_tpu_torch.data tooling"
            )
        self._env = lmdb.open(
            path, max_readers=1, readonly=True, lock=False,
            readahead=False, meminit=False,
        )
        self._txn = self._env.begin(write=False)

    def get(self, key: bytes) -> Optional[bytes]:
        return self._txn.get(key)


def _encode_png(arr: np.ndarray) -> bytes:
    buf = io.BytesIO()
    Image.fromarray(arr).save(buf, format="PNG")
    return buf.getvalue()


class Episode:
    """Typed accessors over one trajectory store (schema parity with
    reference BasicDataset.access/load_img/load_bev/filter)."""

    def __init__(self, store):
        self.store = store

    # -- basic ------------------------------------------------------------
    def __len__(self) -> int:
        return int(self.store.get(b"len"))

    @property
    def town(self) -> str:
        t = self.store.get(b"town")
        return t.decode() if t else ""

    def access(self, tag: str, index: int, T: int, dtype=np.float32):
        return np.stack([
            np.frombuffer(self.store.get(f"{tag}_{t:05d}".encode()), dtype)
            for t in range(index, index + T)
        ])

    def load_img(self, tag: str, idx: int) -> np.ndarray:
        buf = self.store.get(f"{tag}_{idx:05d}".encode())
        img = Image.open(io.BytesIO(buf))
        if "sem" in tag:
            img = img.convert("L")
        else:
            img = img.convert("RGB")
        return np.asarray(img)

    def load_bev(self, idx: int, channels: Sequence[int] = range(12)):
        chans = [
            np.asarray(Image.open(io.BytesIO(
                self.store.get(f"map_{c}_{idx:05d}".encode())
            )).convert("L"))
            for c in channels
        ]
        return np.stack(chans, axis=-1)

    # -- actor tracklets ---------------------------------------------------
    def gather_actors(self, index: int, T: int, *, max_pedestrian_radius: float,
                      max_vehicle_radius: float):
        """Build per-actor tracklets over frames [index, index+T].

        Keeps actors present in EVERY frame and within the class radius of
        the ego at t=0 (reference filter, basic_dataset.py:103-157).
        Returns (ego_locs (T+1,2), ego_oris (T+1,), ego_bbox (T+1,2),
        locs (N,T+1,2), oris (N,T+1), bbox (N,T+1,2), typs (N,T+1)) with
        the EGO in slot 0 of the actor arrays, others sorted by actor id.
        """
        ids0 = self.access("id", index, 1, np.int32).flatten()
        ego_id = int(ids0[0])

        tracks = {int(a): dict(
            msk=np.zeros(T + 1, bool), loc=np.zeros((T + 1, 2)),
            ori=np.zeros(T + 1), box=np.zeros((T + 1, 2)),
            typ=np.zeros(T + 1),
        ) for a in ids0}

        for t in range(index, index + T + 1):
            ids_t = self.access("id", t, 1, np.int32).flatten()
            locs_t = self.access("loc", t, 1).reshape(-1, 2)
            oris_t = self.access("ori", t, 1).flatten()
            boxs_t = self.access("bbox", t, 1).reshape(-1, 2)
            typs_t = self.access("type", t, 1, np.uint8).flatten()
            for a, l, o, b, ty in zip(ids_t, locs_t, oris_t, boxs_t, typs_t):
                tr = tracks.get(int(a))
                if tr is None:
                    continue
                k = t - index
                tr["msk"][k] = True
                tr["loc"][k] = l
                tr["ori"][k] = math.radians(float(o))
                tr["box"][k] = b
                tr["typ"][k] = ty

        ego = tracks[ego_id]
        ego_loc0 = ego["loc"][0]

        kept = []
        for a in sorted(tracks):
            tr = tracks[a]
            if not tr["msk"].all():
                continue
            dist = np.linalg.norm(tr["loc"][0] - ego_loc0)
            radius = (max_pedestrian_radius if tr["typ"][0] == 0
                      else max_vehicle_radius)
            if a != ego_id and dist > radius:
                continue
            kept.append(a)

        # ego first (the planners drop slot 0 as the ego,
        # bev_planner.py:78-80)
        kept = [ego_id] + [a for a in kept if a != ego_id]
        locs = np.stack([tracks[a]["loc"] for a in kept])
        oris = np.stack([tracks[a]["ori"] for a in kept])
        bbox = np.stack([tracks[a]["box"] for a in kept])
        typs = np.stack([tracks[a]["typ"] for a in kept])
        return ego["loc"], ego["ori"], ego["box"], locs, oris, bbox, typs


def open_episode(path: str) -> Episode:
    """Open a trajectory: .lavpack native packs or LMDB directories."""
    if path.endswith(".lavpack"):
        from lav_tpu_torch.data.lavpack import LavPackStore

        return Episode(LavPackStore(path))
    return Episode(LMDBStore(path))


# ---------------------------------------------------------------------------
# synthetic episodes — test fixture + replay-environment source
# ---------------------------------------------------------------------------

def make_synthetic_episode(
    n_frames: int = 24,
    n_actors: int = 4,
    n_lidar: int = 512,
    img_hw=(32, 32),
    bev_hw=(320, 320),
    n_cams: int = 5,
    town: str = "Town03",
    seed: int = 0,
    with_painted: bool = False,
    n_seg: int = 4,
) -> Episode:
    """Generate a physically-plausible episode with the exact key schema of
    the released LAV dataset, so every dataset class is testable without
    the real data (there is no such fixture in the reference —
    SURVEY.md §4)."""
    rng = np.random.default_rng(seed)
    s = DictStore()
    s.put(b"len", str(n_frames).encode())
    s.put(b"town", town.encode())

    # straight-driving ego + drifting actors in world coordinates
    ego_start = rng.uniform(-50, 50, 2)
    ego_dir = rng.uniform(-np.pi, np.pi)
    actor_off = rng.uniform(-12, 12, (n_actors, 2))
    actor_spd = rng.uniform(0.1, 0.5, (n_actors, 2))

    for t in range(n_frames):
        ego_loc = ego_start + t * 0.4 * np.array([math.cos(ego_dir), math.sin(ego_dir)])
        ids = np.arange(n_actors + 1, dtype=np.int32)
        locs = np.concatenate(
            [ego_loc[None], ego_loc[None] + actor_off + t * actor_spd]
        ).astype(np.float32)
        oris = np.full(n_actors + 1, math.degrees(ego_dir), np.float32)
        bbox = np.full((n_actors + 1, 2), 1.0, np.float32)
        typs = np.array([1] + [1] * (n_actors // 2) + [0] * (n_actors - n_actors // 2),
                        np.uint8)

        s.put(f"id_{t:05d}".encode(), ids.tobytes())
        s.put(f"loc_{t:05d}".encode(), locs.tobytes())
        s.put(f"ori_{t:05d}".encode(), oris.tobytes())
        s.put(f"bbox_{t:05d}".encode(), bbox.tobytes())
        s.put(f"type_{t:05d}".encode(), typs.tobytes())
        s.put(f"cmd_{t:05d}".encode(), np.array([3], np.uint8).tobytes())
        s.put(f"bra_{t:05d}".encode(), np.array([t % 2], np.uint8).tobytes())
        s.put(f"nxp_{t:05d}".encode(),
              (ego_loc + rng.uniform(5, 15, 2)).astype(np.float32).tobytes())

        lidar = rng.uniform(-30, 30, (n_lidar, 4)).astype(np.float32)
        lidar[:, 2] = rng.uniform(-2.0, 1.0, n_lidar)
        s.put(f"lidar_{t:05d}".encode(), lidar.tobytes())
        if with_painted:
            sem = rng.uniform(0, 1, (n_lidar, n_seg)).astype(np.float32)
            s.put(f"lidar_sem_{t:05d}".encode(), sem.tobytes())

        for c in range(n_cams):
            rgb = rng.integers(0, 255, (*img_hw, 3), dtype=np.uint8)
            sem_img = rng.integers(0, 23, img_hw, dtype=np.uint8)
            s.put(f"rgb_{c}_{t:05d}".encode(), _encode_png(rgb))
            s.put(f"sem_{c}_{t:05d}".encode(), _encode_png(sem_img))
        s.put(f"tel_rgb_{t:05d}".encode(),
              _encode_png(rng.integers(0, 255, (*img_hw, 3), dtype=np.uint8)))
        s.put(f"tel_sem_{t:05d}".encode(),
              _encode_png(rng.integers(0, 23, img_hw, dtype=np.uint8)))

        for ch in range(12):
            m = (rng.uniform(size=bev_hw) > 0.9).astype(np.uint8) * 255
            s.put(f"map_{ch}_{t:05d}".encode(), _encode_png(m))

    return Episode(s)
