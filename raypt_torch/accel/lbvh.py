"""The binary skip-link tree container (`raypt/accel/lbvh.py`'s `LBVH`).

Node ids: internal nodes [0, N-2] (root 0), leaves [N-1, 2N-2], leaf j
holds face `leaf_face[j]`. The port builds it on the host, so the
arrays are numpy; the Karras device build (`lbvh.build`) is not ported.
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class LBVH:
    left: np.ndarray       # (2N-1,) int32 left child, -1 for leaves
    skip: np.ndarray       # (2N-1,) int32 next node when done, -1 = exit
    bmin: np.ndarray       # (2N-1, 3) f32
    bmax: np.ndarray       # (2N-1, 3) f32
    leaf_face: np.ndarray  # (N,) int32

    @property
    def num_leaves(self) -> int:
        return self.leaf_face.shape[0]
