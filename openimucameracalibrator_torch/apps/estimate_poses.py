"""Pose-dataset loader of the pose-estimation stage.

Only the loader is ported so far (``load_pose_dataset``); the stage itself
is ROADMAP.md queue 1, item 9.
"""

from __future__ import annotations

import numpy as np


def load_pose_dataset(path: str):
    """PoseDataset from a ``.npz`` or a Theia ``.calibdata`` file."""
    from openimucameracalibrator_torch.utils.types import PoseDataset

    if path.endswith(".calibdata"):
        from openimucameracalibrator_torch.utils import theia_io
        poses, _, _ = theia_io.load_pose_dataset_calibdata(path)
        return poses
    z = np.load(path)
    return PoseDataset(times=z["times"], q_w_c=z["q_w_c"], t_w_c=z["t_w_c"],
                       valid=z["valid"], board_points=z["board_points"])
