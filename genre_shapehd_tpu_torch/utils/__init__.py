"""Host-side utilities (counterpart of ``genre_shapehd_tpu/utils``):
console prefixes, sharded batch saving, camera math and Mitsuba camera
files, and the spherical rendering of a predicted depth map."""

from .printing import str_stage, str_verbose, str_warning, str_error
from .io import BatchSave
from .camera import Camera, backproject_depth_to_ptcloud
from . import cam_para, sph_eval

__all__ = ["str_stage", "str_verbose", "str_warning", "str_error",
           "BatchSave", "Camera", "backproject_depth_to_ptcloud",
           "cam_para", "sph_eval"]
