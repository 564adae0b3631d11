"""3D face geometry for the GAR's mesh condition."""

from stylerenderer_tpu_torch.face3d.geometry import (
    mesh_point_normal,
    normalize,
    random_apply_pose3D,
    save_obj,
)
from stylerenderer_tpu_torch.face3d.io import sphere_face_mesh, synthetic_face
from stylerenderer_tpu_torch.face3d.morphable import (
    LinearMorphableModel,
    make_linear_morphable_model,
)
from stylerenderer_tpu_torch.face3d.transforms import euler_mat

__all__ = [
    "LinearMorphableModel", "euler_mat", "make_linear_morphable_model",
    "mesh_point_normal", "normalize", "random_apply_pose3D", "save_obj",
    "sphere_face_mesh", "synthetic_face",
]
