"""3D face geometry: the face models and their loaders, the mesh
condition of the GAR, and face alignment."""

from stylerenderer_tpu_torch.face3d.geometry import (
    mesh_point_normal,
    normalize,
    random_apply_pose3D,
    save_obj,
)
from stylerenderer_tpu_torch.face3d.io import (
    load_bfm,
    load_bfm_texture,
    load_facewarehouse,
    load_face_model,
    load_flame,
    sphere_face_mesh,
    synthetic_face,
)
from stylerenderer_tpu_torch.face3d.morphable import (
    BlendShapeModel,
    LinearBlendSkinningModel,
    LinearMorphableModel,
    make_blendshape_model,
    make_lbs_model,
    make_linear_morphable_model,
)
from stylerenderer_tpu_torch.face3d.transforms import (
    euler_mat,
    rodrigues,
    rotate_mat,
    scale_mat,
    translate_mat,
)

__all__ = [
    "BlendShapeModel", "LinearBlendSkinningModel", "LinearMorphableModel", "euler_mat",
    "load_bfm", "load_bfm_texture", "load_face_model", "load_facewarehouse",
    "load_flame",
    "make_blendshape_model", "make_lbs_model", "make_linear_morphable_model",
    "mesh_point_normal", "normalize", "random_apply_pose3D", "rodrigues", "rotate_mat",
    "save_obj", "scale_mat", "sphere_face_mesh", "synthetic_face", "translate_mat",
]
