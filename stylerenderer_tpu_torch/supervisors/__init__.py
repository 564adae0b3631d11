"""Frozen supervisor nets, the training heads of ``--sfs``, ``--lmk`` and
``--feat`` (counterpart of ``stylerenderer_tpu/supervisors``): consistency
losses of the reference trainer (``train.py:316-330``).

- ``sfs``: the shape-from-shading normal estimator (face_normals'
  ``ResNetUNet``), a smooth L1 between its normals of the fake image and
  the rasterized normal map, weight 0.01;
- ``lmk``: the PFLD landmark regressor, landmark consistency between
  geometry-paired samples, weight 1e-5;
- ``feat``: the InceptionResnetV1 face embedding (facenet), identity
  consistency between shape-paired samples, weight 0.001.

The nets carry the published layouts' names (``convert.py``), so a
published state dict loads by name; without weights they run as
fixed-seed random stand-ins.
"""

from stylerenderer_tpu_torch.supervisors.convert import (
    load_face_normals,
    load_facenet,
    load_pfld,
    random_stand_in_,
)
from stylerenderer_tpu_torch.supervisors.face_normals import ResNetUNet
from stylerenderer_tpu_torch.supervisors.hub import make_extra_heads
from stylerenderer_tpu_torch.supervisors.landmark import PFLDInference
from stylerenderer_tpu_torch.supervisors.recognition import InceptionResnetV1

__all__ = [
    "InceptionResnetV1", "PFLDInference", "ResNetUNet", "load_face_normals", "load_facenet",
    "load_pfld", "make_extra_heads", "random_stand_in_",
]
