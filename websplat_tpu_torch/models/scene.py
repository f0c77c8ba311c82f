"""``cameras.json`` scene model (``websplat_tpu/models/scene.py``, after
web-splat scene.rs), copied so the port does not import the JAX package.

Covers: serde-equivalent parsing (scene.rs:12-24), the every-8th-camera
Test/Train split per Kerbl et al. (scene.rs:139-147), duplicate-id dedup with
warning (scene.rs:118-134), the rotation determinant fix (scene.rs:85-108),
scene extend as max pairwise camera distance (scene.rs:173,192-201) and
nearest-camera lookup (scene.rs:178-187).
"""

from __future__ import annotations

import dataclasses
import enum
import json
import logging
from typing import Dict, List, Optional, Union

import numpy as np

from websplat_tpu_torch.models.camera import (
    PerspectiveCamera,
    PerspectiveProjection,
    focal2fov,
    fov2focal,
)
from websplat_tpu_torch.utils.gmath import mat_to_quat, max_pairwise_distance, quat_to_mat

log = logging.getLogger(__name__)


class Split(enum.Enum):
    TRAIN = "train"
    TEST = "test"


@dataclasses.dataclass
class SceneCamera:
    """scene.rs:12-24; `rotation` is the JSON row-major 3x3."""

    id: int
    img_name: str
    width: int
    height: int
    position: np.ndarray  # (3,)
    rotation: np.ndarray  # (3, 3)
    fx: float
    fy: float
    split: Split = Split.TRAIN

    def to_perspective(self) -> PerspectiveCamera:
        """scene.rs:85-108: focal->fov, det<0 y-column flip, znear/zfar=0.01/100.

        The reference loads the JSON rows into cgmath columns (an implicit
        transpose) and flips sublane 1 of each cgmath column; in row-major
        NumPy terms that is a flip of JSON column 1, and the camera rotation
        used by world2view is the transpose of the (fixed) JSON matrix.
        """
        fovx = focal2fov(self.fx, float(self.width))
        fovy = focal2fov(self.fy, float(self.height))
        r = np.array(self.rotation, dtype=np.float32)
        if np.linalg.det(r) < 0:
            r = r.copy()
            r[:, 1] = -r[:, 1]
        q = mat_to_quat(r.T)
        return PerspectiveCamera(
            position=np.asarray(self.position, np.float32),
            rotation=q,
            projection=PerspectiveProjection.new(
                (self.width, self.height), (fovx, fovy), 0.01, 100.0
            ),
        )

    @classmethod
    def from_perspective(
        cls,
        cam: PerspectiveCamera,
        name: str,
        id: int,
        viewport,
        split: Split,
    ) -> "SceneCamera":
        """scene.rs:38-61 (used when saving viewer poses)."""
        fx = fov2focal(cam.projection.fovx, float(viewport[0]))
        fy = fov2focal(cam.projection.fovy, float(viewport[1]))
        rot = quat_to_mat(cam.rotation).T  # back to JSON layout
        return cls(
            id=id,
            img_name=name,
            width=int(viewport[0]),
            height=int(viewport[1]),
            position=np.asarray(cam.position, np.float32),
            rotation=rot,
            fx=fx,
            fy=fy,
            split=split,
        )

    def to_json_dict(self) -> Dict:
        return dict(
            id=self.id,
            img_name=self.img_name,
            width=self.width,
            height=self.height,
            position=[float(x) for x in self.position],
            rotation=[[float(x) for x in row] for row in np.asarray(self.rotation)],
            fx=float(self.fx),
            fy=float(self.fy),
        )


class Scene:
    """scene.rs:110-188."""

    def __init__(self, cameras: List[SceneCamera]):
        self._extend = max_pairwise_distance(
            np.stack([c.position for c in cameras]) if cameras else np.zeros((0, 3))
        )
        self._cameras: Dict[int, SceneCamera] = {}
        for c in cameras:
            if c.id in self._cameras:
                log.warning("duplicate camera id %s in scene (duplicates were removed)", c.id)
            self._cameras[c.id] = c

    @classmethod
    def from_json(cls, source: Union[str, bytes]) -> "Scene":
        """scene.rs:136-150 with the Kerbl et al. every-8th Test split."""
        if isinstance(source, (bytes, bytearray)):
            entries = json.loads(source.decode("utf-8"))
        elif isinstance(source, str) and source.lstrip().startswith("["):
            entries = json.loads(source)
        else:
            with open(source) as f:
                entries = json.load(f)
        cameras = []
        for i, e in enumerate(entries):
            cameras.append(
                SceneCamera(
                    id=int(e["id"]),
                    img_name=str(e.get("img_name", "")),
                    width=int(e["width"]),
                    height=int(e["height"]),
                    position=np.asarray(e["position"], np.float32),
                    rotation=np.asarray(e["rotation"], np.float32),
                    fx=float(e["fx"]),
                    fy=float(e["fy"]),
                    split=Split.TEST if i % 8 == 0 else Split.TRAIN,
                )
            )
        log.info("loaded scene file with %d views", len(cameras))
        return cls(cameras)

    def camera(self, i: int) -> Optional[SceneCamera]:
        return self._cameras.get(i)

    def num_cameras(self) -> int:
        return len(self._cameras)

    def cameras(self, split: Optional[Split] = None) -> List[SceneCamera]:
        cams = [c for c in self._cameras.values() if split is None or c.split == split]
        return sorted(cams, key=lambda c: c.id)

    def extend(self) -> float:
        return self._extend

    def nearest_camera(self, pos: np.ndarray, split: Optional[Split] = None) -> Optional[int]:
        """scene.rs:178-187 (including the 1e6-scaled u32 distance compare)."""
        best = None
        best_key = None
        for c in self._cameras.values():
            if split is not None and c.split != split:
                continue
            d2 = float(((np.asarray(c.position) - np.asarray(pos)) ** 2).sum())
            key = int(d2 * 1e6) & 0xFFFFFFFF
            if best_key is None or key < best_key:
                best_key = key
                best = c.id
        return best
