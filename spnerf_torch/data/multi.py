"""Multi-AOI training: several satellite scenes merged into one ray set on
the device. The PyTorch port's copy of the JAX package's `data/multi.py`.

Rays from all AOIs mix freely in each batch: each ray carries what the field
needs (normalized origin and direction in its own scene frame, sun
direction, semantic label, transient image id). Validation and DSM scoring
stay per AOI.

Each AOI keeps its own `scene.loc` normalization and is then translated to a
disjoint region of the shared field's domain, frame_offset = (k *
FRAME_SPACING, 0, 0) for the k-th AOI, so one field represents all scenes
side by side. `SceneNorm.denormalize_points` inverts the offset, so per-AOI
DSMs and MAEs keep their meaning. Transient image ids stay unique across
AOIs.
"""

from dataclasses import dataclass
from typing import List

import numpy as np

from .dataset import SatelliteScene, load_scene


@dataclass
class MultiScene:
    scenes: List[SatelliteScene]
    aoi_ids: List[str]
    # merged train arrays (the schema of SatelliteScene)
    rays: np.ndarray
    rgbs: np.ndarray
    ids: np.ndarray
    depths: np.ndarray
    valid_depth: np.ndarray
    depth_std: np.ndarray
    sems: np.ndarray
    valid_sem: np.ndarray

    def __len__(self):
        return self.rays.shape[0]

    def validation_items(self):
        """Yield (aoi_id, scene, record) for every validation image."""
        for aoi, scene in zip(self.aoi_ids, self.scenes):
            for rec in scene.val_images:
                yield aoi, scene, rec


# distance between AOI cubes in normalized space: each scene spans about
# [-1, 1], so spacing 3 leaves at least one unit of empty space between
# neighbouring AOIs
FRAME_SPACING = 3.0


def load_scenes(aoi_ids, dataset_dir_fn, **scene_kwargs) -> MultiScene:
    """Load and merge several AOIs.

    dataset_dir_fn(aoi_id) -> dict with json_dir, img_dir, depth_dir and
    sem_dir for that AOI. Transient image ids are offset so that every image
    across all AOIs has its own id; scene k lives in a frame translated by
    (k * FRAME_SPACING, 0, 0) in normalized space.
    """
    scenes, id_offset = [], 0
    merged = {k: [] for k in ("rays", "rgbs", "ids", "depths", "valid_depth",
                              "depth_std", "sems", "valid_sem")}
    for k, aoi in enumerate(aoi_ids):
        dirs = dataset_dir_fn(aoi)
        scene = load_scene(dirs["json_dir"], dirs["img_dir"],
                           dirs["depth_dir"], dirs["sem_dir"], aoi,
                           frame_offset=np.array([k * FRAME_SPACING, 0.0, 0.0]),
                           **scene_kwargs)
        # a scene takes len(train) + len(test) id slots (validation record 0
        # reuses train image 0)
        scene.ids = scene.ids + id_offset
        for rec in scene.val_images:
            rec.t += id_offset
        id_offset += len(scene.train_images) + max(len(scene.val_images) - 1, 0)
        scenes.append(scene)
        for name in merged:
            merged[name].append(getattr(scene, name))
    return MultiScene(
        scenes=scenes, aoi_ids=list(aoi_ids),
        **{k: np.concatenate(v, axis=0) for k, v in merged.items()},
    )
